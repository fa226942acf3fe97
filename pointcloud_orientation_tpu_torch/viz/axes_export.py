"""Prediction PLYs with an axes overlay, numpy only.

Counterpart of ``pointcloud_orientation_tpu/viz/axes_export.py``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from ..data.ply import write_ply_with_axes


def export_prediction_plys(predict_axes: Callable[[np.ndarray], Sequence[np.ndarray]],
                           clouds: np.ndarray, out_dir: str,
                           names: Optional[Sequence[str]] = None, max_count: int = 10) -> int:
    """Write up to ``max_count`` clouds with their predicted axes to
    ``out_dir/<name>_pred_<i+1>.ply`` (name ``sample_<i>`` by default);
    ``predict_axes(cloud (N, 3)) -> [vx, vy, vz]``. Returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    n = min(max_count, len(clouds))
    for i in range(n):
        axes = [np.asarray(v).reshape(3) for v in predict_axes(clouds[i])]
        base = names[i] if names is not None else f"sample_{i}"
        write_ply_with_axes(clouds[i], axes, os.path.join(out_dir, f"{base}_pred_{i + 1}.ply"))
    return n


def axes_from_two_heads(vy: np.ndarray, vz: np.ndarray) -> list:
    """The three overlay axes from the (up, forward) heads: ``vx = cross(vy,
    vz)``, unit-normalised, then ``vy`` and ``vz`` as they are."""
    vx = np.cross(vy, vz)
    vx = vx / (np.linalg.norm(vx) + 1e-12)
    return [vx, np.asarray(vy), np.asarray(vz)]
