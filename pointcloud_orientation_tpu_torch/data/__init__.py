"""Data of the port: synthetic clouds, the ModelNet40 HDF5 archive, PLY
trees with their ground-truth sidecars, the packed dataset, the on-device
batch pipeline and its targets (axes, 8-direction, von Mises, mixture), and
the offline tools (:mod:`.offline`)."""

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
from .hdf5 import load_modelnet_hdf5, synthetic_modelnet
from .pipeline import (
    ROTATION_MODES,
    augment_batch,
    random_rotation,
    rotate_batch,
    subsample_by_uniform,
    subsample_points,
)
from .ply import read_ply, write_ply, write_ply_with_axes
from .sidecar import (
    read_8dir_txt,
    read_axes_txt,
    read_multi_peak_vm_txt,
    read_single_peak_vm_txt,
    write_8dir_txt,
    write_axes_txt,
    write_multi_peak_vm_txt,
    write_single_peak_vm_txt,
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
    "load_modelnet_hdf5",
    "mvm_gt",
    "random_rotation",
    "read_8dir_txt",
    "read_axes_txt",
    "read_multi_peak_vm_txt",
    "read_ply",
    "read_single_peak_vm_txt",
    "rotate_batch",
    "single_peak_gt",
    "split_indices",
    "subsample_by_uniform",
    "subsample_points",
    "synthetic_modelnet",
    "write_8dir_txt",
    "write_axes_txt",
    "write_multi_peak_vm_txt",
    "write_ply",
    "write_ply_with_axes",
    "write_single_peak_vm_txt",
]
