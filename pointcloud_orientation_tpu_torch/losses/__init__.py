"""Training objectives of the port."""

from .objectives import (
    mvm_matched_loss,
    projected_probs_mse_loss,
    single_peak_vm_kl_loss,
    soft_label_kl_8dir,
    softmax_mse_8dir_loss,
)

__all__ = ["mvm_matched_loss", "projected_probs_mse_loss", "single_peak_vm_kl_loss",
           "soft_label_kl_8dir", "softmax_mse_8dir_loss"]
