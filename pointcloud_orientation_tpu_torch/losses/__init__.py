"""Training objectives of the port."""

from .objectives import soft_label_kl_8dir, softmax_mse_8dir_loss

__all__ = ["soft_label_kl_8dir", "softmax_mse_8dir_loss"]
