"""Packed in-memory dataset with deterministic splits and batch iteration.

Counterpart of ``pointcloud_orientation_tpu/data/dataset.py`` (numpy, the
same splits and batch order from the same seeds, and the same packed arrays
from the same HDF5 archive or PLY tree, stored sidecar targets included).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .fastply import try_read_ply_bulk_native
from .gt import class_masks
from .hdf5 import load_modelnet_hdf5, synthetic_modelnet
from .ply import read_ply
from .sidecar import (
    read_8dir_txt,
    read_axes_txt,
    read_multi_peak_vm_txt,
    read_single_peak_vm_txt,
)

# the axes a PLY without its axes sidecar is given: the canonical frame
# (side -x, up +y, forward -z)
_CANONICAL_AXES = np.eye(3, dtype=np.float32) * np.asarray([[-1], [1], [-1]], np.float32)


def split_indices(
    n: int, seed: int = 42, fractions: Tuple[float, float] = (0.7, 0.15)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffle ``range(n)`` and cut train/val/test at 70%/15%/15%."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_tr = int(fractions[0] * n)
    n_va = int(fractions[1] * n)
    return order[:n_tr], order[n_tr: n_tr + n_va], order[n_tr + n_va:]


@dataclasses.dataclass
class OrientationDataset:
    """Canonical (un-rotated) clouds and labels, plus the per-sample class
    behaviour arrays the target synthesis reads.

    ``targets`` optionally holds ground truth stored beside a pre-rotated
    PLY tree (:meth:`from_ply_tree` with ``load_sidecars=True``), under the
    batch's keys: ``axes (S, 3, 3)``, ``forward (S, 3)``, ``probs_8dir (S,
    8)``, ``vm_mu``/``vm_kappa (S,)``, ``mvm_mu``/``mvm_kappa``/``mvm_weight
    (S, max_k)`` float32 and ``mvm_k (S,)`` int32. A trainer with
    ``rotation_mode="none"`` takes them in place of the targets it would
    synthesize.
    """

    points: np.ndarray  # (S, M, 3) float32
    labels: np.ndarray  # (S,) int32
    class_names: List[str]
    targets: Optional[dict] = None

    def __post_init__(self):
        uniform, symm, k = class_masks(self.class_names)
        self.uniform_mask = uniform[self.labels]
        self.symm_mask = symm[self.labels]
        self.k_spec = k[self.labels]

    def __len__(self) -> int:
        return self.points.shape[0]

    @classmethod
    def synthetic(cls, **kw) -> "OrientationDataset":
        return cls(*synthetic_modelnet(**kw))

    @classmethod
    def from_hdf5(cls, dataset_dir: str, **kw) -> "OrientationDataset":
        """The ModelNet40 HDF5 archive under ``dataset_dir``
        (:func:`.hdf5.load_modelnet_hdf5`; no h5py needed)."""
        return cls(*load_modelnet_hdf5(dataset_dir, **kw))

    @classmethod
    def from_ply_tree(cls, root: str, num_points: int, classes: Optional[Sequence[str]] = None,
                      load_sidecars: bool = False, max_k: int = 4) -> "OrientationDataset":
        """A PLY tree ``root/<class>/*.ply`` (classes and files in sorted
        order), every cloud resampled to ``num_points`` by
        ``default_rng(0)``'s ``choice`` (without replacement when the cloud
        has enough points), so that the pack is the JAX package's bit for
        bit. Files are parsed by the native parser's thread pool; a file it
        rejects by the NumPy parser alone.

        With ``load_sidecars=True`` the sidecars beside each PLY are packed
        into ``targets``; a missing one gets the JAX loader's default: the
        canonical axes, the uniform 8-direction label, ``(0, 0)`` for the
        single peak (also when it does not parse), K=0 and zeros for the
        mixture.
        """
        rng = np.random.default_rng(0)
        names = sorted(d for d in os.listdir(root)
                       if not d.startswith(".") and os.path.isdir(os.path.join(root, d)))
        if classes is not None:
            names = [n for n in names if n in set(classes)]
        files = []
        for ci, name in enumerate(names):
            cdir = os.path.join(root, name)
            files += [(ci, os.path.join(cdir, f)) for f in sorted(os.listdir(cdir))
                      if f.endswith(".ply")]
        parsed = try_read_ply_bulk_native([p for _, p in files])
        clouds, labels = [], []
        tg = {k: [] for k in ("axes", "probs_8dir", "vm_mu", "vm_kappa", "mvm_mu", "mvm_kappa",
                              "mvm_weight", "mvm_k")}
        for fi, (ci, path) in enumerate(files):
            pts = parsed[fi] if parsed is not None and parsed[fi] is not None else read_ply(path)
            pts = pts[:, :3]
            idx = rng.choice(pts.shape[0], num_points, replace=pts.shape[0] < num_points)
            clouds.append(pts[idx].astype(np.float32))
            labels.append(ci)
            if not load_sidecars:
                continue
            stem = path[: -len(".ply")]
            try:
                axes = read_axes_txt(stem + ".txt")
            except (OSError, ValueError):
                axes = _CANONICAL_AXES
            tg["axes"].append(axes)
            try:
                probs = read_8dir_txt(stem + "_8dir.txt")
            except (OSError, ValueError):
                probs = np.full(8, 0.125, np.float32)
            tg["probs_8dir"].append(probs)
            mu, kappa = read_single_peak_vm_txt(stem + "_single_peak_vM_gt.txt")
            tg["vm_mu"].append(mu)
            tg["vm_kappa"].append(kappa)
            try:
                params, k = read_multi_peak_vm_txt(stem + "_multi_peak_vM_gt.txt", max_k)
            except OSError:
                params, k = np.zeros((max_k, 3), np.float32), 0
            tg["mvm_mu"].append(params[:, 0])
            tg["mvm_kappa"].append(params[:, 1])
            tg["mvm_weight"].append(params[:, 2])
            tg["mvm_k"].append(k)
        targets = None
        if load_sidecars and clouds:
            targets = {k: np.asarray(v, dtype=np.float32) for k, v in tg.items()}
            targets["mvm_k"] = targets["mvm_k"].astype(np.int32)
            targets["forward"] = targets["axes"][:, 2]
        return cls(np.stack(clouds), np.asarray(labels, np.int32), list(names), targets)

    def _take_targets(self, mask_or_idx) -> Optional[dict]:
        if self.targets is None:
            return None
        return {k: v[mask_or_idx] for k, v in self.targets.items()}

    def subset(self, idx: np.ndarray) -> "OrientationDataset":
        return OrientationDataset(self.points[idx], self.labels[idx], self.class_names,
                                  self._take_targets(idx))

    def select_classes(self, classes: Sequence[str]) -> "OrientationDataset":
        """Restrict to the given categories, relabeling densely."""
        keep = [self.class_names.index(c) for c in classes]
        remap = {old: new for new, old in enumerate(keep)}
        mask = np.isin(self.labels, keep)
        labels = np.asarray([remap[l] for l in self.labels[mask]], np.int32)
        return OrientationDataset(self.points[mask], labels, list(classes),
                                  self._take_targets(mask))

    def split(self, seed: int = 42
              ) -> Tuple["OrientationDataset", "OrientationDataset", "OrientationDataset"]:
        tr, va, te = split_indices(len(self), seed)
        return self.subset(tr), self.subset(va), self.subset(te)

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0, pad_final: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        """Yield ``(index_batch (B,), valid_mask (B,), epoch_fraction)``.

        The final partial batch is padded by wrapping around the order, with
        ``valid_mask`` zero on the padding, so that every step has one shape
        and losses and metrics can leave the padding out.
        """
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, n, batch_size):
            chunk = order[start: start + batch_size]
            valid = np.ones(len(chunk), np.float32)
            if len(chunk) < batch_size:
                if not pad_final:
                    continue
                pad = batch_size - len(chunk)
                wrap = np.tile(order, -(-pad // n))[:pad]
                chunk = np.concatenate([chunk, wrap])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            yield chunk, valid, min((start + batch_size) / n, 1.0)

    def gather_host(self, idx: np.ndarray):
        """Host-side gather of one batch's raw arrays."""
        return (self.points[idx], self.labels[idx], self.uniform_mask[idx],
                self.symm_mask[idx], self.k_spec[idx])
