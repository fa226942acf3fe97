"""Prediction overlays: axes-annotated PLYs, and polar plots of the
(mixture-of-)von-Mises yaw densities (matplotlib, imported when drawing)."""

from .axes_export import axes_from_two_heads, export_prediction_plys
from .polar import batch_plot_mvm, plot_mvm_polar, plot_predicted_density

__all__ = ["axes_from_two_heads", "batch_plot_mvm", "export_prediction_plys", "plot_mvm_polar",
           "plot_predicted_density"]
