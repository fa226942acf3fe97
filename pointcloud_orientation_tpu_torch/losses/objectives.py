"""The yaw-task objectives. Counterpart of
``pointcloud_orientation_tpu/losses/objectives.py`` (``soft_label_kl_8dir``,
``softmax_mse_8dir_loss``, ``projected_probs_mse_loss``,
``single_peak_vm_kl_loss``, ``mvm_matched_loss``); each returns
``(scalar_loss, per_sample (B,))``."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.dirs8 import forward_to_8dir_probs
from ..ops.matching import matched_mvm_loss
from ..ops.von_mises import kl_von_mises

Loss = Tuple[torch.Tensor, torch.Tensor]


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
