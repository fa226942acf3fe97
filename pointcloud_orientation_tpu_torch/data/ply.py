"""ASCII PLY import and export, numpy only.

Counterpart of ``pointcloud_orientation_tpu/data/ply.py``: the writers give
the same bytes as the JAX package's (6-decimal fixed point), and
:func:`read_ply` parses with the native parser (:mod:`.fastply`) and falls
back to the NumPy parser for a file the native one rejects.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def read_ply_numpy(path: str | os.PathLike) -> np.ndarray:
    """The NumPy parser: the vertex block as ``(N, C)`` float32. Reads the
    ``element vertex`` count from the header and that many rows of at least
    three numbers, so trailing elements (the axes files' edge rows) stay
    out."""
    with open(path, "r") as f:
        n_vertex = None
        for line in f:
            stripped = line.strip()
            if stripped.startswith("element vertex"):
                n_vertex = int(stripped.split()[-1])
            if stripped == "end_header":
                break
        else:
            raise ValueError(f"no end_header in PLY file: {path}")
        rows = []
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            rows.append([float(p) for p in parts])
            if n_vertex is not None and len(rows) >= n_vertex:
                break
    if not rows:
        raise ValueError(f"no vertices in PLY file: {path}")
    return np.asarray(rows, dtype=np.float32)


def read_ply(path: str | os.PathLike) -> np.ndarray:
    """Read an ASCII PLY's vertex block; returns ``(N, C)`` float32 (C = 3,
    or 6 with normals). The native parser first; a file it rejects goes to
    :func:`read_ply_numpy` (:func:`.fastply.parser_counts` says which ran)."""
    from .fastply import count_numpy, try_read_ply_native

    native = try_read_ply_native(str(path))
    if native is not None:
        return native
    count_numpy(1)
    return read_ply_numpy(path)


def write_ply(vertices: np.ndarray, path: str | os.PathLike) -> None:
    """Write ``(N, 3)`` vertices (further columns dropped) as ASCII PLY,
    6-decimal fixed point."""
    vertices = np.asarray(vertices)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {vertices.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for x, y, z in vertices[:, :3]:
            f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")


def write_ply_with_axes(vertices: np.ndarray, axes: Sequence[np.ndarray],
                        path: str | os.PathLike) -> None:
    """Write a cloud plus 4 extra vertices (the origin, then the 3 axis
    endpoints, at indices 0..3) and 3 edge rows ``0 1 / 0 2 / 0 3``: the
    prediction overlay."""
    vertices = np.asarray(vertices)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {vertices.shape[0] + 4}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element edge 3\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        f.write("0.000000 0.000000 0.000000\n")
        for vec in axes:
            f.write(f"{vec[0]:.6f} {vec[1]:.6f} {vec[2]:.6f}\n")
        for pt in vertices[:, :3]:
            f.write(f"{pt[0]:.6f} {pt[1]:.6f} {pt[2]:.6f}\n")
        f.write("0 1\n0 2\n0 3\n")
