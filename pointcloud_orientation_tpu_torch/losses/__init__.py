"""Training objectives of the port."""

from .objectives import (
    axes_orth_loss,
    forward_mse_loss,
    mse,
    mvm_matched_loss,
    nll_loss,
    pointnet_cls_loss,
    projected_probs_mse_loss,
    single_peak_vm_kl_loss,
    soft_label_kl_8dir,
    softmax_mse_8dir_loss,
)

__all__ = ["axes_orth_loss", "forward_mse_loss", "mse", "mvm_matched_loss", "nll_loss",
           "pointnet_cls_loss", "projected_probs_mse_loss", "single_peak_vm_kl_loss",
           "soft_label_kl_8dir", "softmax_mse_8dir_loss"]
