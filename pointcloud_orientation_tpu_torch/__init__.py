"""PyTorch/CUDA port of pointcloud_orientation_tpu, for one NVIDIA H100.

The port serves the PointNet++ 8-direction model (``pointnet_pp_8dir``) and
the PointNet++ ModelNet40 classifier (``pointnet_pp_cls``) through
``infer.OrientationPredictor``, and trains the 8-direction model
(``train.Trainer``, the ``8dir_kl``/``8dir_mse`` presets), through seven
CUDA kernels written for Hopper (``csrc/``): fused set-abstraction grouping
and its scatter-add gradient, fused shared-MLP + max and its recompute
backward, kNN for clouds above the fused grouping's size, farthest-point
sampling and the radius ball query. Importing the package builds nothing and
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
