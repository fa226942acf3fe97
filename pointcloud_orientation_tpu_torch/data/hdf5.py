"""ModelNet40 ingest: the HDF5 archive read into packed arrays
(``load_modelnet_hdf5``, through :mod:`.h5format`: no h5py) and the
procedural stand-in (``synthetic_modelnet``), numpy only.

Counterpart of ``pointcloud_orientation_tpu/data/hdf5.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .h5format import read_dataset


def load_modelnet_hdf5(dataset_dir: str, splits: Sequence[str] = ("train", "test")
                       ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Read every ``*.h5`` under ``dataset_dir`` whose name holds one of
    ``splits``, in sorted order, with its ``data`` and ``label`` keys, and
    the class names from ``shape_names.txt``. Returns ``(points (S, P, 3)
    float32, labels (S,) int32, class_names)``. Only ``data`` and ``label``
    are read and decompressed (not the archive's ``normal`` or
    ``faceId``)."""
    with open(os.path.join(dataset_dir, "shape_names.txt"), "r") as f:
        class_names = [ln.strip() for ln in f if ln.strip()]
    h5_files = sorted(f for f in os.listdir(dataset_dir)
                      if f.endswith(".h5") and any(s in f for s in splits))
    if not h5_files:
        raise FileNotFoundError(f"no .h5 files in {dataset_dir}")
    all_pts, all_labels = [], []
    for fname in h5_files:
        path = os.path.join(dataset_dir, fname)
        data, labels = read_dataset(path, "data"), read_dataset(path, "label")
        if labels.ndim > 1:
            labels = labels[:, 0]
        all_pts.append(np.asarray(data[..., :3], np.float32))
        all_labels.append(np.asarray(labels, np.int32))
    return np.concatenate(all_pts), np.concatenate(all_labels), class_names


def synthetic_modelnet(
    seed: int = 42,
    class_names: Optional[Sequence[str]] = None,
    samples_per_class: int = 32,
    num_points: int = 2048,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Procedural stand-in for ModelNet40 (tests, benchmarks, smoke training).

    Each class is a box with class-specific aspect ratio plus a forward
    "nose" cluster on the -z face, so the canonical orientation is learnable
    from geometry. Clouds are centered and scale-normalized. The same seed
    gives the same arrays as the JAX package's function.
    """
    if class_names is None:
        class_names = ["chair", "toilet", "sofa", "plant", "bowl", "bottle"]
    rng = np.random.default_rng(seed)
    clouds, labels = [], []
    n_nose = max(num_points // 10, 1)
    n_body = num_points - n_nose
    for ci, name in enumerate(class_names):
        crng = np.random.default_rng(seed * 1000 + ci)
        dims = crng.uniform(0.3, 1.0, size=3)
        for _ in range(samples_per_class):
            body = rng.uniform(-0.5, 0.5, size=(n_body, 3)) * dims
            # project each body point to a random box face
            face_axis = rng.integers(0, 3, n_body)
            face_sign = rng.choice([-0.5, 0.5], n_body)
            body[np.arange(n_body), face_axis] = face_sign * dims[face_axis]
            nose = rng.normal(scale=0.03, size=(n_nose, 3))
            nose[:, 2] -= dims[2] * 0.5 + 0.15
            pts = np.concatenate([body, nose]).astype(np.float32)
            pts -= pts.mean(axis=0, keepdims=True)
            pts /= np.abs(pts).max() + 1e-8
            pts += rng.normal(scale=0.005, size=pts.shape).astype(np.float32)
            clouds.append(pts.astype(np.float32))
            labels.append(ci)
    return np.stack(clouds), np.asarray(labels, np.int32), list(class_names)
