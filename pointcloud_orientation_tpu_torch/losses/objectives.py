"""The 8-direction objectives. Counterpart of
``pointcloud_orientation_tpu/losses/objectives.py`` (``soft_label_kl_8dir``,
``softmax_mse_8dir_loss``); each returns ``(scalar_loss, per_sample (B,))``."""

from __future__ import annotations

from typing import Tuple

import torch

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
