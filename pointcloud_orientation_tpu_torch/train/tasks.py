"""Task adapters: (outputs, batch, cfg) -> per-sample loss and per-sample
angular error in degrees (NaN where undefined; no adapter where the task has
none, as classification).

Counterpart of ``pointcloud_orientation_tpu/train/tasks.py``: the
``forward_mse``, ``forward_mse_aux`` (the MoE transformer's ``(out, aux)``),
``axes``, ``8dir_kl``, ``8dir_mse``, ``multi_8dir``, ``vm_kl``, ``mvm`` and
``classification`` entries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .. import losses as L
from ..ops.dirs8 import DIRS_8
from ..ops.matching import hungarian_small
from ..ops.rotations import forward_to_mu, wrap_angle
from ..ops.von_mises import kl_von_mises

_DEG = 180.0 / math.pi


def _unit(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def _vec_angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between ``a`` and ``b`` in degrees, ``arccos`` of the
    clipped cosine of their :func:`_unit` vectors."""
    cos = torch.clamp((_unit(a) * _unit(b)).sum(dim=-1), -1.0, 1.0)
    return torch.arccos(cos) * _DEG


def _horizontal_angle_deg(pred_forward: torch.Tensor, gt_forward: torch.Tensor) -> torch.Tensor:
    """Yaw-only angular error between the horizontal projections."""
    d = wrap_angle(forward_to_mu(pred_forward) - forward_to_mu(gt_forward))
    return torch.abs(d) * _DEG


@dataclasses.dataclass(frozen=True)
class TaskAdapter:
    loss: Callable  # (outputs, batch, cfg) -> per-sample loss (B,)
    angular_error: Optional[Callable] = None  # (outputs, batch, cfg) -> (B,) degrees


def _nan_where(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, torch.full_like(x, math.nan), x)


def _forward_mse(outputs, batch, cfg):
    """MSE of the raw forward head against the axes row ``cfg.target_row``."""
    return L.forward_mse_loss(outputs, batch["axes"][:, cfg.target_row])[1]


def _forward_mse_ang(outputs, batch, cfg):
    return _vec_angle_deg(outputs, batch["axes"][:, cfg.target_row])


def _forward_mse_aux(outputs, batch, cfg):
    """Forward MSE of a model that returns ``(out, aux)``: the scalar aux
    adds to every per-sample loss, so the masked batch mean takes exactly
    ``moe_aux_weight * aux``."""
    out, aux = outputs
    return _forward_mse(out, batch, cfg) + cfg.moe_aux_weight * aux


def _forward_mse_aux_ang(outputs, batch, cfg):
    return _forward_mse_ang(outputs[0], batch, cfg)


def _axes(outputs, batch, cfg):
    """The two-axis loss: the mean of the up and forward heads' MSEs
    against axes rows 1 and 2, plus ``lambda_orth`` times the squared dot
    product of the two heads."""
    vy, vz = outputs
    return L.axes_orth_loss(vy, vz, batch["axes"][:, 1], batch["axes"][:, 2],
                            cfg.lambda_orth)[1]


def _axes_ang(outputs, batch, cfg):
    """The forward head's angle from the ground-truth forward (axes row 2)."""
    return _vec_angle_deg(outputs[1], batch["axes"][:, 2])


def _uniform_target(batch) -> torch.Tensor:
    target = batch["probs_8dir"]
    return target.amax(dim=-1) - target.amin(dim=-1) < 1e-6


def _8dir_ang(outputs, batch, cfg):
    """Angle between the probability-weighted compass direction and the
    ground-truth forward; NaN for uniform-target categories."""
    probs = torch.softmax(outputs, dim=-1)
    pred = _unit(probs @ DIRS_8.to(probs.device, probs.dtype))
    return _nan_where(_uniform_target(batch), _horizontal_angle_deg(pred, batch["forward"]))


def _8dir_kl(outputs, batch, cfg):
    return L.soft_label_kl_8dir(outputs, batch["probs_8dir"])[1]


def _8dir_mse(outputs, batch, cfg):
    return L.softmax_mse_8dir_loss(outputs, batch["probs_8dir"])[1]


def _multi_8dir(outputs, batch, cfg):
    return L.projected_probs_mse_loss(outputs, batch["probs_8dir"])[1]


def _multi_8dir_ang(outputs, batch, cfg):
    return _nan_where(_uniform_target(batch), _horizontal_angle_deg(outputs, batch["forward"]))


def _vm_kl(outputs, batch, cfg):
    mu, kappa = outputs
    return kl_von_mises(mu, kappa, batch["vm_mu"], batch["vm_kappa"])


def _vm_ang(outputs, batch, cfg):
    """|wrapped mu error| in degrees; NaN for symmetric categories."""
    mu, _ = outputs
    ang = torch.abs(wrap_angle(mu - batch["vm_mu"])) * _DEG
    return _nan_where(~(batch["vm_kappa"] > 0), ang)


def _mvm(outputs, batch, cfg):
    mu, kappa, w = outputs
    return L.mvm_matched_loss(mu, kappa, w, batch["mvm_mu"], batch["mvm_kappa"], batch["mvm_k"],
                              unmatched_penalty=getattr(cfg, "mvm_unmatched_penalty", 0.0))[1]


def _mvm_ang(outputs, batch, cfg):
    """Mean matched peak angular error over the first ``k`` components, for
    categories with concentrated peaks (kappa > 0); NaN otherwise."""
    mu, kappa, _ = outputs
    k = batch["mvm_k"]
    cost = kl_von_mises(mu[:, :, None], kappa[:, :, None],
                        batch["mvm_mu"][:, None, :], batch["mvm_kappa"][:, None, :])
    cost = torch.nan_to_num(cost, nan=1e6, posinf=1e6, neginf=1e6)
    col, _ = hungarian_small(cost, k)
    matched_gt_mu = torch.gather(batch["mvm_mu"], 1, col.long())
    ang = torch.abs(wrap_angle(mu - matched_gt_mu)) * _DEG
    valid = (torch.arange(mu.shape[1], device=mu.device)[None] < k[:, None]) & (
        batch["mvm_kappa"].amax(-1, keepdim=True) > 0)
    mean = torch.where(valid, ang, torch.zeros_like(ang)).sum(-1) / valid.sum(-1).clamp_min(1)
    return _nan_where(~valid.any(-1), mean)


def _cls(outputs, batch, cfg):
    """The negative log-probability of each sample's label."""
    log_probs = outputs[0] if isinstance(outputs, tuple) else outputs
    return L.nll_loss(log_probs, batch["labels"])[1]


TASKS: Dict[str, TaskAdapter] = {
    "forward_mse": TaskAdapter(_forward_mse, _forward_mse_ang),
    "forward_mse_aux": TaskAdapter(_forward_mse_aux, _forward_mse_aux_ang),
    "axes": TaskAdapter(_axes, _axes_ang),
    "8dir_kl": TaskAdapter(_8dir_kl, _8dir_ang),
    "8dir_mse": TaskAdapter(_8dir_mse, _8dir_ang),
    "multi_8dir": TaskAdapter(_multi_8dir, _multi_8dir_ang),
    "vm_kl": TaskAdapter(_vm_kl, _vm_ang),
    "mvm": TaskAdapter(_mvm, _mvm_ang),
    "classification": TaskAdapter(_cls, None),
}
