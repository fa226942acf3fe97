"""Offline dataset tools: the reference's on-disk layout written and
converted (rotated PLY trees with axes sidecars, and the three
ground-truth passes: 8-direction, single-peak vM, multi-peak MvM).

Counterpart of ``pointcloud_orientation_tpu/data/offline.py``. The target
math is the port's own (``ops/dirs8.py``, ``ops/rotations.py``) in float32
on the CPU, the 8-direction projection in the order in which XLA's CPU code
computes the JAX function (:func:`_probs_8dir`), so that every file written
equals the JAX tools' byte for byte. ``rotate_tree`` draws its rotations
from a ``torch.Generator`` seeded with ``seed``: the same distribution as
the JAX function's, other numbers. ``hdf5_to_ply_tree`` reads the archive
through ``data/h5format.py``: no h5py.
"""

from __future__ import annotations

import json
import os
import re
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.dirs8 import DIRS_8
from ..ops.rotations import (
    axes_gt_from_rotation,
    forward_to_mu,
    random_so3_matrix,
    random_yaw_matrix,
)
from .h5format import read_dataset
from .gt import K_DICT, KAPPA_DEFAULT, SYMM_CLASSES, UNIFORM_CLASSES
from .ply import read_ply, write_ply
from .sidecar import (
    read_axes_txt,
    write_8dir_txt,
    write_axes_txt,
    write_multi_peak_vm_txt,
    write_single_peak_vm_txt,
)

_GT_SUFFIXES = ("_8dir.txt", "_single_peak_vM_gt.txt", "_multi_peak_vM_gt.txt")


def _class_dirs(root: str):
    return [c for c in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, c))]


def rotate_tree(input_dir: str, output_dir: str, mode: str = "yaw", seed: int = 42) -> int:
    """Rotate every ``<class>/<file>.ply`` of ``input_dir`` by a random yaw
    (``mode="yaw"``) or SO(3) Euler rotation (``"so3"``), one draw a file
    in sorted order, and write the rotated cloud and its 3-row axes sidecar
    (side, up, forward) to ``output_dir``. Returns the files written."""
    if mode not in ("yaw", "so3"):
        raise ValueError(f"unknown mode: {mode}")
    draw = random_yaw_matrix if mode == "yaw" else random_so3_matrix
    gen = torch.Generator().manual_seed(seed)
    count = 0
    for cls in _class_dirs(input_dir):
        cdir = os.path.join(input_dir, cls)
        out_cdir = os.path.join(output_dir, cls)
        os.makedirs(out_cdir, exist_ok=True)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(".ply"):
                continue
            verts = read_ply(os.path.join(cdir, fname))[:, :3]
            rot = draw(gen, 1)
            rotated = verts @ rot[0].numpy().T
            dst = os.path.join(out_cdir, fname)
            write_ply(rotated, dst)
            write_axes_txt(axes_gt_from_rotation(rot)[0].numpy(), dst[: -len(".ply")] + ".txt")
            count += 1
    return count


def _iter_axes_sidecars(root: str, cls: str):
    for path in sorted(glob(os.path.join(root, cls, "*.txt"))):
        if not os.path.basename(path).endswith(_GT_SUFFIXES):
            yield path


def _fma32(a, b, c):
    """``a * b + c`` of float32 values rounded to float32 once, as a fused
    multiply-add (the product is exact in float64; the sum's own float64
    rounding can differ from a single one only on a tie, about 2^-29 of
    cases)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _probs_8dir(fwd: np.ndarray) -> np.ndarray:
    """``forward_to_8dir_probs`` of one float32 forward vector in XLA's
    order on the CPU: the norm and each of the 8 dot products as a chain of
    fused multiply-adds over x, y, z; the total summed left to right. The
    port's on-device version (``ops/dirs8.py``) rounds each product, which
    moves the 6th decimal of the written label in about 1 file in 300."""
    x, y, z = fwd
    norm = np.sqrt(_fma32(z, z, _fma32(y, y, x * x)))
    v = fwd / (norm + np.float32(1e-8))
    d = DIRS_8.numpy()
    sims = np.maximum(_fma32(v[2], d[:, 2], _fma32(v[1], d[:, 1], v[0] * d[:, 0])), 0)
    total = np.float32(0.0)
    for s in sims:
        total = np.float32(total + s)
    return sims / total if total > 0 else np.full(8, 0.125, np.float32)


def _mu(vec: np.ndarray) -> float:
    return float(forward_to_mu(torch.from_numpy(np.asarray(vec, np.float32))))


def generate_8dir_gt(root: str, uniform_classes: Optional[Sequence[str]] = None) -> int:
    """Write ``<stem>_8dir.txt`` beside every axes sidecar: the forward
    row's 8-direction projection, or 0.125 each for a uniform class."""
    uniform = set(uniform_classes if uniform_classes is not None else UNIFORM_CLASSES)
    count = 0
    for cls in _class_dirs(root):
        for path in _iter_axes_sidecars(root, cls):
            if cls in uniform:
                probs = np.full(8, 0.125, np.float32)
            else:
                probs = _probs_8dir(read_axes_txt(path)[2])
            write_8dir_txt(probs, path[: -len(".txt")] + "_8dir.txt")
            count += 1
    return count


def generate_single_peak_gt(root: str, symm_classes: Optional[Sequence[str]] = None,
                            kappa_default: float = KAPPA_DEFAULT) -> int:
    """Write ``<stem>_single_peak_vM_gt.txt`` beside every axes sidecar:
    ``mu = atan2(fx, -fz)`` of the forward row, and ``kappa`` 0 for a
    symmetric class, else ``kappa_default``."""
    symm = set(symm_classes if symm_classes is not None else SYMM_CLASSES)
    count = 0
    for cls in _class_dirs(root):
        kappa = 0.0 if cls in symm else kappa_default
        for path in _iter_axes_sidecars(root, cls):
            mu = _mu(read_axes_txt(path)[2])
            write_single_peak_vm_txt(mu, kappa, path[: -len(".txt")] + "_single_peak_vM_gt.txt")
            count += 1
    return count


def generate_mvm_gt(src_root: str, dst_root: str, k_dict: Optional[Dict[str, int]] = None,
                    kappa_default: float = KAPPA_DEFAULT, max_k: int = 4) -> int:
    """Write ``dst_root/<class>/<stem>_multi_peak_vM_gt.txt`` for every axes
    sidecar of the classes in ``k_dict``: peaks in the order front, -front,
    side, -side, cut to the class's K, kappa ``kappa_default`` and weight
    1/K; a K=0 class gets one peak at the front with kappa 0."""
    k_dict = dict(k_dict if k_dict is not None else K_DICT)
    count = 0
    for cls, k_spec in k_dict.items():
        if not os.path.isdir(os.path.join(src_root, cls)):
            continue
        out_dir = os.path.join(dst_root, cls)
        os.makedirs(out_dir, exist_ok=True)
        for path in _iter_axes_sidecars(src_root, cls):
            axes = read_axes_txt(path)
            side, forward = axes[0], axes[2]
            if k_spec <= 0:
                peaks, kappa = [forward], 0.0
            else:
                peaks, kappa = [forward, -forward, side, -side][:k_spec], kappa_default
            k = len(peaks)
            params = np.zeros((max_k, 3), np.float32)
            for i, p in enumerate(peaks[:max_k]):
                params[i] = [_mu(p), kappa, 1.0 / k]
            stem = os.path.splitext(os.path.basename(path))[0]
            write_multi_peak_vm_txt(params, min(k, max_k),
                                    os.path.join(out_dir, f"{stem}_multi_peak_vM_gt.txt"))
            count += 1
    return count


def txt_to_ply(txt_path: str, ply_path: str) -> int:
    """Convert one comma-separated ``x,y,z[,nx,ny,nz]`` text cloud to ASCII
    PLY (xyz only); returns the vertex count."""
    pts = np.loadtxt(txt_path, delimiter=",", dtype=np.float32)
    if pts.ndim == 1:
        pts = pts[None, :]
    write_ply(pts[:, :3], ply_path)
    return int(pts.shape[0])


def txt_to_ply_tree(input_dir: str, output_dir: str) -> int:
    """Convert a ``<class>/<file>.txt`` tree of comma-separated clouds to a
    PLY tree; returns the files written."""
    count = 0
    for cls in _class_dirs(input_dir):
        cdir = os.path.join(input_dir, cls)
        out_cdir = os.path.join(output_dir, cls)
        os.makedirs(out_cdir, exist_ok=True)
        for fname in sorted(os.listdir(cdir)):
            if fname.endswith(".txt"):
                txt_to_ply(os.path.join(cdir, fname),
                           os.path.join(out_cdir, fname[: -len(".txt")] + ".ply"))
                count += 1
    return count


def _id2file(dataset_dir: str, base: str):
    """The ``*_id2file.json`` name mapping beside an archive ``base.h5``:
    ``<prefix>_<n>_id2file.json`` for a base ending in digits, else
    ``<base>_id2file.json``; the first that exists is read (None if it does
    not parse)."""
    candidates = [f"{base}_id2file.json"]
    m = re.match(r"(.*?)(\d+)$", base)
    if m:
        candidates.insert(0, f"{m.group(1)}_{m.group(2)}_id2file.json")
    for cand in candidates:
        path = os.path.join(dataset_dir, cand)
        if os.path.exists(path):
            try:
                with open(path) as jf:
                    return json.load(jf)
            except (OSError, ValueError):
                return None
    return None


def hdf5_to_ply_tree(dataset_dir: str, output_dir: str) -> int:
    """Write a ModelNet40 HDF5 archive out as the per-class ASCII PLY tree:
    a cloud is named by its archive's ``*_id2file.json`` mapping where one
    is given (a dict by index or a list), else ``<class>_<nnnn>.ply``
    counted per class across the archives in sorted order. Returns the
    files written. The archives are read by :mod:`.h5format` (no
    h5py)."""
    with open(os.path.join(dataset_dir, "shape_names.txt"), "r") as f:
        names = [ln.strip() for ln in f if ln.strip()]
    counters = {i: 0 for i in range(len(names))}
    total = 0
    for fname in sorted(f for f in os.listdir(dataset_dir) if f.endswith(".h5")):
        id2file = _id2file(dataset_dir, os.path.splitext(fname)[0])
        path = os.path.join(dataset_dir, fname)
        data, labels = read_dataset(path, "data"), read_dataset(path, "label")
        if labels.ndim > 1:
            labels = labels[:, 0]
        for i, (cloud, label) in enumerate(zip(data, labels)):
            label = int(label)
            cls = names[label]
            out_dir = os.path.join(output_dir, cls)
            os.makedirs(out_dir, exist_ok=True)
            mapped = None
            if isinstance(id2file, dict):
                mapped = id2file.get(str(i))
            elif isinstance(id2file, list) and i < len(id2file):
                mapped = id2file[i]
            if mapped:
                out_name = os.path.basename(mapped)
                if not out_name.endswith(".ply"):
                    out_name += ".ply"
            else:
                out_name = f"{cls}_{counters[label]:04d}.ply"
            counters[label] += 1
            write_ply(np.asarray(cloud[:, :3], np.float32), os.path.join(out_dir, out_name))
            total += 1
    return total
