"""PyTorch/CUDA port of pointcloud_orientation_tpu, for one NVIDIA H100.

The port serves every head the JAX package serves on one device (the
PointNet++ heads and classifier, the point transformer, the PointNet
backbones; yaw-voting TTA, int8 weights) through
``infer.OrientationPredictor``, and trains them (``train.Trainer`` and its
presets), through the CUDA kernels written for Hopper (``csrc/``): fused
set-abstraction grouping and its scatter-add gradient, fused shared-MLP +
max and its recompute backward, kNN, farthest-point sampling, the radius
ball query, the grid stage's top-k and the flash attention. Importing the package builds nothing and
needs no ``nvcc``; the kernels are built on the first CUDA call.
The JAX package beside it is the reference; this package never imports it.
"""

from .infer import OrientationPredictor
from .models import MODEL_REGISTRY, PointNetPP8Dir, PointNetPPCls
from .utils import load_flax_variables, random_flax_variables

__all__ = [
    "MODEL_REGISTRY",
    "OrientationPredictor",
    "PointNetPP8Dir",
    "PointNetPPCls",
    "load_flax_variables",
    "random_flax_variables",
]
