"""Prediction overlays: axes-annotated PLYs (the MvM polar plots of the JAX
package's ``viz/polar.py`` are not ported)."""

from .axes_export import axes_from_two_heads, export_prediction_plys

__all__ = ["axes_from_two_heads", "export_prediction_plys"]
