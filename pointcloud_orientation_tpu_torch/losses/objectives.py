"""Every training objective: the regressions (``mse``,
``forward_mse_loss``, ``axes_orth_loss``), the yaw tasks' and the
classifier's. Counterpart of ``pointcloud_orientation_tpu/losses/objectives.py``;
each returns ``(scalar_loss, per_sample (B,))`` but ``mse``, a scalar."""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.pointnet import feature_transform_regularizer
from ..ops.dirs8 import forward_to_8dir_probs
from ..ops.matching import matched_mvm_loss
from ..ops.von_mises import kl_von_mises

Loss = Tuple[torch.Tensor, torch.Tensor]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements (torch ``nn.MSELoss`` default)."""
    return ((pred - target) ** 2).mean()


def _per_sample_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean(dim=tuple(range(1, pred.dim())))


def forward_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> Loss:
    """Direct forward-vector regression: ``MSE(pred, gt)``."""
    per = _per_sample_mse(pred, target)
    return per.mean(), per


def axes_orth_loss(vy: torch.Tensor, vz: torch.Tensor, gy: torch.Tensor, gz: torch.Tensor,
                   lam: float = 0.1) -> Loss:
    """Two-axis regression with orthogonality regularization:
    ``(MSE(vy, gy) + MSE(vz, gz)) / 2 + lam * mean((vy . vz)^2)``."""
    per = (_per_sample_mse(vy, gy) + _per_sample_mse(vz, gz)) / 2.0
    per = per + lam * (vy * vz).sum(dim=-1) ** 2
    return per.mean(), per


def softmax_mse_8dir_loss(logits: torch.Tensor, probs_gt: torch.Tensor) -> Loss:
    """MSE between ``softmax(logits)`` and a target 8-dir distribution."""
    per = ((torch.softmax(logits, dim=-1) - probs_gt) ** 2).mean(dim=-1)
    return per.mean(), per


def soft_label_kl_8dir(logits: torch.Tensor, probs_gt: torch.Tensor) -> Loss:
    """Soft-label cross-entropy ``-sum P log_softmax(logits)`` per sample
    (KL(P||Q) up to the constant H(P))."""
    per = -(probs_gt * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return per.mean(), per


def projected_probs_mse_loss(forward_pred: torch.Tensor, probs_gt: torch.Tensor) -> Loss:
    """Project a predicted unit forward vector to 8-dir probabilities, then
    MSE against the target distribution."""
    per = ((forward_to_8dir_probs(forward_pred) - probs_gt) ** 2).mean(dim=-1)
    return per.mean(), per


def single_peak_vm_kl_loss(mu_pred: torch.Tensor, kappa_pred: torch.Tensor,
                           mu_gt: torch.Tensor, kappa_gt: torch.Tensor) -> Loss:
    """Analytic von Mises ``KL(pred || gt)`` per sample (clamped kappas,
    wrapped mean difference)."""
    per = kl_von_mises(mu_pred, kappa_pred, mu_gt, kappa_gt)
    return per.mean(), per


def mvm_matched_loss(mu_pred: torch.Tensor, kappa_pred: torch.Tensor, w_pred: torch.Tensor,
                     mu_gt: torch.Tensor, kappa_gt: torch.Tensor, k_gt: torch.Tensor,
                     unmatched_penalty: float = 0.0) -> Loss:
    """Hungarian-matched weighted mixture-of-von-Mises KL
    (:func:`..ops.matching.matched_mvm_loss`)."""
    per = matched_mvm_loss(mu_pred, kappa_pred, w_pred, mu_gt, kappa_gt, k_gt,
                           unmatched_penalty=unmatched_penalty)
    return per.mean(), per


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> Loss:
    """Negative log-likelihood on log-probabilities ``(B, C)`` of integer
    labels ``(B,)`` (torch's ``F.nll_loss`` with the per-sample values)."""
    per = -torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    return per.mean(), per


def pointnet_cls_loss(log_probs: torch.Tensor, labels: torch.Tensor, trans_feat: torch.Tensor,
                      mat_diff_loss_scale: float = 0.001) -> Loss:
    """The PointNet classifier's NLL plus ``mat_diff_loss_scale`` times the
    feature transform's orthogonality penalty
    (:func:`..models.pointnet.feature_transform_regularizer`); the
    per-sample values are the NLL's (the reference's ``get_loss``,
    `PointNetDemo.py:163-172`)."""
    scalar, per = nll_loss(log_probs, labels)
    return scalar + mat_diff_loss_scale * feature_transform_regularizer(trans_feat), per
