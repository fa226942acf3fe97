"""Data of the port: synthetic clouds, the packed dataset, the on-device
batch pipeline and its targets (axes, 8-direction, von Mises, mixture)."""

from .dataset import OrientationDataset, split_indices
from .gt import (
    CLEAR_CLASSES,
    K_DICT,
    KAPPA_DEFAULT,
    SYMM_CLASSES,
    UNIFORM_CLASSES,
    class_masks,
    eight_dir_gt,
    mvm_gt,
    single_peak_gt,
)
from .hdf5 import synthetic_modelnet
from .pipeline import (
    ROTATION_MODES,
    augment_batch,
    random_rotation,
    rotate_batch,
    subsample_by_uniform,
    subsample_points,
)

__all__ = [
    "CLEAR_CLASSES",
    "K_DICT",
    "KAPPA_DEFAULT",
    "OrientationDataset",
    "ROTATION_MODES",
    "SYMM_CLASSES",
    "UNIFORM_CLASSES",
    "augment_batch",
    "class_masks",
    "eight_dir_gt",
    "mvm_gt",
    "random_rotation",
    "rotate_batch",
    "single_peak_gt",
    "split_indices",
    "subsample_by_uniform",
    "subsample_points",
    "synthetic_modelnet",
]
