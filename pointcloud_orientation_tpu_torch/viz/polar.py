"""Polar plots of (mixture-of-)von-Mises yaw densities.

Counterpart of ``pointcloud_orientation_tpu/viz/polar.py``: the density on
a 720-point grid over [-pi, pi] (float32, through
:func:`..ops.von_mises.mixture_von_mises_pdf`), normalised by its trapezoid
integral, drawn on polar axes with 0 degrees at North, clockwise, a blue
line over an alpha-0.3 fill, at 150 dpi. matplotlib is imported inside the
plotting functions (the card's machine has none; the density needs none).
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import Sequence

import numpy as np
import torch

from ..data.sidecar import read_multi_peak_vm_txt
from ..ops.von_mises import mixture_von_mises_pdf


def _density(theta: np.ndarray, mu, kappa, w) -> np.ndarray:
    """The mixture's density at ``theta``, normalised to integrate to 1."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    p = mixture_von_mises_pdf(f32(theta)[None, :], f32(mu)[None, :], f32(kappa)[None, :],
                              f32(w)[None, :])[0].numpy()
    return p / (np.trapezoid(p, theta) + 1e-8)


def plot_mvm_polar(mu: Sequence[float], kappa: Sequence[float], weight: Sequence[float],
                   save_path: str, theta_counts: int = 720) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    theta = np.linspace(-math.pi, math.pi, theta_counts)
    p = _density(theta, mu, kappa, weight)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, polar=True)
    ax.plot(theta, p, lw=1.5, color="tab:blue")
    ax.fill_between(theta, 0, p, alpha=0.3, color="tab:blue")
    ax.set_theta_zero_location("N")
    ax.set_theta_direction(-1)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_predicted_density(mu, kappa, weight, save_path: str) -> None:
    """A model's predicted mixture, drawn as the ground-truth plots are."""
    plot_mvm_polar(np.asarray(mu), np.asarray(kappa), np.asarray(weight), save_path)


def batch_plot_mvm(label_name: str, gt_root: str, out_root: str) -> int:
    """Draw every ``*_multi_peak_vM_gt.txt`` under ``gt_root/label`` to a PNG
    under ``out_root/label``; returns the number of files drawn."""
    label_dir = os.path.join(gt_root, label_name)
    out_dir = os.path.join(out_root, label_name)
    files = sorted(glob(os.path.join(label_dir, "*_multi_peak_vM_gt.txt")))
    for path in files:
        params, k = read_multi_peak_vm_txt(path)
        fname = os.path.basename(path).replace(".txt", ".png")
        plot_mvm_polar(params[:k, 0], params[:k, 1], params[:k, 2], os.path.join(out_dir, fname))
    return len(files)
