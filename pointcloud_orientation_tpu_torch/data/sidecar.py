"""Readers and writers of the four ground-truth sidecar text formats, numpy
only.

Counterpart of ``pointcloud_orientation_tpu/data/sidecar.py``, byte for byte
in what it writes and value for value in what it reads, parse failures
included:

* axes: 3 rows x 3 floats (side, up, forward), ``<stem>.txt``;
* 8-direction: one row of 8 probabilities, ``<stem>_8dir.txt``;
* single-peak vM: a ``# mu(rad)\\tkappa`` comment, then ``mu kappa``,
  ``<stem>_single_peak_vM_gt.txt``;
* multi-peak vM: a comment, ``K n``, a header, n rows ``mu kappa weight``,
  ``<stem>_multi_peak_vM_gt.txt``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def read_axes_txt(path: str | os.PathLike) -> np.ndarray:
    """The 3x3 axes sidecar (rows: side, up, forward): the first three rows
    of exactly three numbers. Raises ``ValueError`` with fewer."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                rows.append([float(p) for p in parts])
            if len(rows) == 3:
                break
    if len(rows) < 3:
        raise ValueError(f"axes sidecar needs 3 rows: {path}")
    return np.asarray(rows, dtype=np.float32)


def write_axes_txt(axes: np.ndarray, path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        for v in np.asarray(axes)[:3]:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")


def read_8dir_txt(path: str | os.PathLike) -> np.ndarray:
    """One row of 8 probabilities; ``ValueError`` for another count."""
    probs = np.loadtxt(path, dtype=np.float32).reshape(-1)
    if probs.shape[0] != 8:
        raise ValueError(f"expected 8 probabilities in {path}")
    return probs


def write_8dir_txt(probs: np.ndarray, path: str | os.PathLike) -> None:
    np.savetxt(path, np.asarray(probs).reshape(1, 8), fmt="%.6f")


def read_single_peak_vm_txt(path: str | os.PathLike) -> Tuple[float, float]:
    """``(mu, kappa)`` from the first line that is not blank or a comment; a
    missing or unparsable file gives ``(0, 0)``."""
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                return float(parts[0]), float(parts[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0.0, 0.0


def write_single_peak_vm_txt(mu: float, kappa: float, path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        f.write("# mu(rad)\tkappa\n")
        f.write(f"{mu:.8f}\t{kappa:.6f}\n")


def read_multi_peak_vm_txt(path: str | os.PathLike, max_k: int = 4
                           ) -> Tuple[np.ndarray, int]:
    """``(params (max_k, 3) [mu, kappa, weight] zero-padded, K)``. Rows that
    do not parse as numbers (the header) are skipped; without a ``K`` line,
    K is the number of rows; K is capped at ``max_k``."""
    params = np.zeros((max_k, 3), dtype=np.float32)
    k = 0
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    rows = []
    for ln in lines:
        if ln.startswith("#"):
            continue
        parts = ln.split()
        if parts[0] == "K":
            k = int(parts[1])
            continue
        try:
            vals = [float(p) for p in parts]
        except ValueError:
            continue  # the "mu(rad) kappa weight" header row
        if len(vals) >= 3:
            rows.append(vals[:3])
    for i, row in enumerate(rows[:max_k]):
        params[i] = row
    k = min(k if k > 0 else len(rows), max_k)
    return params, k


def write_multi_peak_vm_txt(params: np.ndarray, k: int, path: str | os.PathLike) -> None:
    params = np.asarray(params)
    with open(path, "w") as f:
        f.write("# von Mises mixture ground truth\n")
        f.write(f"K {k}\n")
        f.write("mu(rad)\tkappa\tweight\n")
        for i in range(k):
            mu, kappa, w = params[i]
            f.write(f"{mu:.8f}\t{kappa:.6f}\t{w:.6f}\n")
