"""Metrics accumulation and ``summary.txt``, numpy only.

Counterpart of ``pointcloud_orientation_tpu/train/metrics.py``
(``masked_angular_mean``, ``MetricsAccumulator``, ``write_summary_txt``,
``write_mvm_results_txt``, ``plot_loss_curves``; matplotlib is imported
only when a curve is drawn).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def masked_angular_mean(angular, valid) -> float:
    """Mean angular error over samples that are both valid and finite
    (adapters mark undefined errors NaN)."""
    ang = np.asarray(angular, np.float64)
    ok = np.asarray(valid, np.float64) * np.isfinite(ang)
    n = float(ok.sum())
    return float(np.where(ok > 0, ang, 0.0).sum() / n) if n else float("nan")


class MetricsAccumulator:
    """Accumulates per-sample losses and angular errors, with per-class buckets."""

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.reset()

    def reset(self):
        n = len(self.class_names)
        self.loss_sum = 0.0
        self.count = 0.0
        self.ang_sum = 0.0
        self.ang_count = 0.0
        self.class_loss = np.zeros(n)
        self.class_count = np.zeros(n)

    def update(self, per_sample: np.ndarray, labels: np.ndarray, valid: np.ndarray,
               angular: Optional[np.ndarray] = None):
        per_sample = np.asarray(per_sample, np.float64)
        valid = np.asarray(valid, np.float64)
        self.loss_sum += float(np.sum(per_sample * valid))
        self.count += float(np.sum(valid))
        np.add.at(self.class_loss, labels, per_sample * valid)
        np.add.at(self.class_count, labels, valid)
        if angular is not None:
            ang = np.asarray(angular, np.float64)
            ok = valid * np.isfinite(ang)
            self.ang_sum += float(np.nansum(np.where(ok > 0, ang, 0.0)))
            self.ang_count += float(np.sum(ok))

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.count, 1.0)

    @property
    def mean_angular_error(self) -> float:
        return self.ang_sum / self.ang_count if self.ang_count else float("nan")

    def per_class_mean(self) -> Dict[str, float]:
        return {
            name: (self.class_loss[i] / self.class_count[i]) if self.class_count[i]
            else float("nan")
            for i, name in enumerate(self.class_names)
        }


def write_summary_txt(path: str, per_class: Dict[str, float], overall: Optional[float] = None):
    """Tab-separated ``label\\tloss`` rows, then ``Overall``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for label, value in per_class.items():
            f.write(f"{label}\t{value:.6f}\n")
        if overall is not None:
            f.write(f"Overall\t{overall:.6f}\n")


def write_mvm_results_txt(path: str, categories: Sequence[str],
                          hist: Dict[str, Dict[str, List[float]]],
                          test_kl: Optional[float] = None,
                          best_val_epoch: Optional[int] = None):
    """The MvM run's ``results.txt``: the best val epoch, the test KL, then
    the last epoch's train and val loss in total (``hist["total"]``) and per
    category (``hist[category]``), NaN where a category has none."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _fmt(x):
        try:
            return f"{float(x):.6f}"
        except (TypeError, ValueError):
            return "nan"

    with open(path, "w") as f:
        f.write("=== Multi-Peak von Mises KL Summary ===\n")
        if best_val_epoch is not None:
            f.write(f"Best Total Val Epoch: {best_val_epoch}\n")
        if test_kl is not None:
            f.write(f"Test KL: {test_kl:.6f}\n")
        f.write("\n-- Per-Category (last epoch) --\n")
        last = len(hist["total"]["train"]) - 1
        f.write(f"[TOTAL] Train={_fmt(hist['total']['train'][last])} "
                f"Val={_fmt(hist['total']['val'][last])}\n")
        for cat in categories:
            tr = hist[cat]["train"][last] if hist[cat]["train"] else float("nan")
            va = hist[cat]["val"][last] if hist[cat]["val"] else float("nan")
            f.write(f"[{cat}] Train={_fmt(tr)} Val={_fmt(va)}\n")


def have_matplotlib() -> bool:
    """Whether matplotlib imports here (the card's machine has none)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def plot_loss_curves(train_losses: Sequence[float], val_losses: Sequence[float], path: str,
                     ylabel: str = "Loss", title: Optional[str] = None):
    """The train and val loss curves as a PNG at ``path``. Imports
    matplotlib here, so a machine without it fails only this call."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xs = range(1, len(train_losses) + 1)
    plt.figure()
    plt.plot(xs, train_losses, label="Train")
    plt.plot(xs, val_losses, "--", label="Val")
    plt.xlabel("Epoch")
    plt.ylabel(ylabel)
    if title:
        plt.title(title)
    plt.grid(True)
    plt.legend()
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
