"""Ground-truth synthesis from the rotation, for the 8-direction tasks.

Counterpart of ``pointcloud_orientation_tpu/data/gt.py`` (the class sets,
``class_masks`` and ``eight_dir_gt``; the von Mises targets come with their
heads).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.dirs8 import forward_to_8dir_probs

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
