"""Task adapters of the 8-direction tasks: (logits, batch, cfg) -> per-sample
loss and per-sample angular error in degrees (NaN where undefined).

Counterpart of the ``8dir_kl`` and ``8dir_mse`` entries of
``pointcloud_orientation_tpu/train/tasks.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .. import losses as L
from ..ops.dirs8 import DIRS_8
from ..ops.rotations import forward_to_mu, wrap_angle


def _unit(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def _horizontal_angle_deg(pred_forward: torch.Tensor, gt_forward: torch.Tensor) -> torch.Tensor:
    """Yaw-only angular error between the horizontal projections."""
    d = wrap_angle(forward_to_mu(pred_forward) - forward_to_mu(gt_forward))
    return torch.abs(d) * (180.0 / math.pi)


@dataclasses.dataclass(frozen=True)
class TaskAdapter:
    loss: Callable  # (outputs, batch, cfg) -> per-sample loss (B,)
    angular_error: Optional[Callable] = None  # (outputs, batch, cfg) -> (B,) degrees


def _8dir_ang(outputs, batch, cfg):
    """Angle between the probability-weighted compass direction and the
    ground-truth forward; NaN for uniform-target categories."""
    probs = torch.softmax(outputs, dim=-1)
    pred = _unit(probs @ DIRS_8.to(probs.device, probs.dtype))
    ang = _horizontal_angle_deg(pred, batch["forward"])
    target = batch["probs_8dir"]
    uniform = target.amax(dim=-1) - target.amin(dim=-1) < 1e-6
    return torch.where(uniform, torch.full_like(ang, math.nan), ang)


def _8dir_kl(outputs, batch, cfg):
    return L.soft_label_kl_8dir(outputs, batch["probs_8dir"])[1]


def _8dir_mse(outputs, batch, cfg):
    return L.softmax_mse_8dir_loss(outputs, batch["probs_8dir"])[1]


TASKS: Dict[str, TaskAdapter] = {
    "8dir_kl": TaskAdapter(_8dir_kl, _8dir_ang),
    "8dir_mse": TaskAdapter(_8dir_mse, _8dir_ang),
}
