"""Packed in-memory dataset with deterministic splits and batch iteration.

Counterpart of ``pointcloud_orientation_tpu/data/dataset.py`` (numpy, the
same splits and batch order from the same seeds). The HDF5 and PLY-tree
constructors and stored sidecar targets are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .gt import class_masks
from .hdf5 import synthetic_modelnet


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
    behaviour arrays the target synthesis reads."""

    points: np.ndarray  # (S, M, 3) float32
    labels: np.ndarray  # (S,) int32
    class_names: List[str]

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

    def subset(self, idx: np.ndarray) -> "OrientationDataset":
        return OrientationDataset(self.points[idx], self.labels[idx], self.class_names)

    def select_classes(self, classes: Sequence[str]) -> "OrientationDataset":
        """Restrict to the given categories, relabeling densely."""
        keep = [self.class_names.index(c) for c in classes]
        remap = {old: new for new, old in enumerate(keep)}
        mask = np.isin(self.labels, keep)
        labels = np.asarray([remap[l] for l in self.labels[mask]], np.int32)
        return OrientationDataset(self.points[mask], labels, list(classes))

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
