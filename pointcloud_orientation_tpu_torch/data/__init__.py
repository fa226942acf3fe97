"""Data of the port: synthetic clouds, the packed dataset, the on-device
batch pipeline and the yaw targets (8-direction, von Mises, mixture)."""

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
from .pipeline import augment_batch, subsample_by_uniform, subsample_points

__all__ = [
    "CLEAR_CLASSES",
    "K_DICT",
    "KAPPA_DEFAULT",
    "OrientationDataset",
    "SYMM_CLASSES",
    "UNIFORM_CLASSES",
    "augment_batch",
    "class_masks",
    "eight_dir_gt",
    "mvm_gt",
    "single_peak_gt",
    "split_indices",
    "subsample_by_uniform",
    "subsample_points",
    "synthetic_modelnet",
]
