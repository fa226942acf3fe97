"""Ground-truth synthesis from the rotation: the 8-direction soft label,
the single-peak von Mises target and the mixture-of-von-Mises target.

Counterpart of ``pointcloud_orientation_tpu/data/gt.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.dirs8 import forward_to_8dir_probs
from ..ops.rotations import forward_to_mu

# Per-category peak counts for the MvM task; K = 0 marks fully symmetric
# categories.
K_DICT: Dict[str, int] = {
    "cone": 0, "bowl": 0, "chair": 1, "bottle": 0, "plant": 0, "car": 1,
    "sofa": 1, "toilet": 1, "door": 2, "curtain": 2, "bathtub": 4, "glass_box": 4,
}

# Categories whose 8-dir target is the uniform distribution.
UNIFORM_CLASSES = frozenset({"bottle", "bowl", "plant"})

# Single-peak vM: categories with a clear forward vs symmetric ones.
CLEAR_CLASSES = frozenset({"chair", "sofa", "toilet"})
SYMM_CLASSES = frozenset({"bottle", "plant", "bowl"})
KAPPA_DEFAULT = 8.0


def class_masks(class_names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (uniform_8dir, symmetric_vm, k_mvm) arrays from names."""
    uniform = np.asarray([c in UNIFORM_CLASSES for c in class_names], bool)
    symm = np.asarray([c in SYMM_CLASSES for c in class_names], bool)
    k = np.asarray([K_DICT.get(c, 1) for c in class_names], np.int32)
    return uniform, symm, k


def eight_dir_gt(forward: torch.Tensor, uniform_mask: torch.Tensor) -> torch.Tensor:
    """8-direction soft label: the projection of the forward vector, or the
    uniform distribution for symmetric categories."""
    probs = forward_to_8dir_probs(forward)
    return torch.where(uniform_mask[:, None], torch.full_like(probs, 0.125), probs)


def single_peak_gt(forward: torch.Tensor, symm_mask: torch.Tensor,
                   kappa_default: float = KAPPA_DEFAULT) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-peak von Mises target: ``mu = atan2(fx, -fz)`` of the
    projected forward; ``kappa`` 0 for symmetric categories, else
    ``kappa_default``."""
    mu = forward_to_mu(forward)
    kappa = torch.where(symm_mask, torch.zeros_like(mu), torch.full_like(mu, kappa_default))
    return mu, kappa


def mvm_gt(side: torch.Tensor, forward: torch.Tensor, k_spec: torch.Tensor,
           kappa_default: float = KAPPA_DEFAULT, max_k: int = 4
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mixture-of-von-Mises target from the rotated side and forward axes.
    Candidate peaks in the order front, -front, side, -side; ``k_spec = 0``
    (a symmetric category) becomes one uniform peak (K=1, kappa 0), else the
    first ``k_spec`` peaks get ``kappa_default`` and weight ``1/K``. Returns
    ``mu``, ``kappa``, ``weight`` ``(B, max_k)``, zero beyond ``k``, and
    ``k (B,)`` int32."""
    mus = torch.stack([forward_to_mu(forward), forward_to_mu(-forward),
                       forward_to_mu(side), forward_to_mu(-side)], dim=-1)[:, :max_k]
    k = torch.where(k_spec <= 0, torch.ones_like(k_spec), k_spec).to(torch.int32)
    valid = torch.arange(max_k, device=mus.device)[None, :] < k[:, None]
    kappa_val = torch.where(k_spec <= 0, 0.0, kappa_default).to(mus.dtype)[:, None]
    zeros = torch.zeros_like(mus)
    mu = torch.where(valid, mus, zeros)
    kappa = torch.where(valid, kappa_val.expand_as(mus), zeros)
    weight = torch.where(valid, (1.0 / k.to(mus.dtype))[:, None].expand_as(mus), zeros)
    return mu, kappa, weight, k
