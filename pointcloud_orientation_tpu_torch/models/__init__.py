"""PyTorch models of the port: the PointNet++ yaw heads (8-dir, unit
forward, von Mises, mixture of von Mises), the SO(3) heads (raw forward
vector, the two two-axis heads), the PointNet++ ModelNet40 classifier, the
point transformer and its mixture-of-experts variant, and the PointNet
backbones (the simple baseline, PointNet regression and the PointNet
ModelNet40 classifier), in eval and train mode; and, as in the JAX
package's registry, the sequence-parallel ring transformer
(``parallel/sp_transformer.py``), plain off a mesh."""

from .layers import PointNetPPTrunk, SetAbstraction, SharedMLP
from .moe_transformer import MoEPointTransformer, moe_ep_param_specs, shard_moe_params
from .point_transformer import PointTransformer
from .pointnet import PointNet, PointNetCls, PointNetEncoder, STN3d, STNkd
from .pointnet_pp import (
    PointNetPP,
    PointNetPP8Dir,
    PointNetPPCls,
    PointNetPPFwd,
    PointNetPPMvM,
    PointNetPPVonMises,
    PointNetPPXYZ,
    PointNetPPXYZSchmidt,
)
from .simple_pointnet import SimplePointNet
from ..parallel.sp_transformer import RingPointTransformer  # noqa: E402 (after .layers)

MODEL_REGISTRY = {
    "simple_pointnet": SimplePointNet,
    "pointnet": PointNet,
    "pointnet_cls": PointNetCls,
    "pointnet_pp_8dir": PointNetPP8Dir,
    "pointnet_pp_fwd": PointNetPPFwd,
    "pointnet_pp_von_mises": PointNetPPVonMises,
    "pointnet_pp_mvm": PointNetPPMvM,
    "pointnet_pp_cls": PointNetPPCls,
    "pointnet_pp": PointNetPP,
    "pointnet_pp_xyz": PointNetPPXYZ,
    "pointnet_pp_xyz_schmidt": PointNetPPXYZSchmidt,
    "point_transformer": PointTransformer,
    # returns (out, aux_loss): the task "forward_mse_aux" consumes the tuple
    "moe_point_transformer": MoEPointTransformer,
    # the sequence-parallel variant (the plain module when no group is given)
    "ring_point_transformer": RingPointTransformer,
}

# Models whose forward returns a tuple with an auxiliary loss rather than a
# head output. The serving predictor and the .pth layouts refuse them, as
# the JAX package's do.
MULTI_OUTPUT_MODELS = frozenset({"moe_point_transformer"})

__all__ = [
    "MODEL_REGISTRY",
    "MULTI_OUTPUT_MODELS",
    "MoEPointTransformer",
    "PointNet",
    "PointNetCls",
    "PointNetEncoder",
    "PointNetPP",
    "PointNetPP8Dir",
    "PointNetPPCls",
    "PointNetPPFwd",
    "PointNetPPMvM",
    "PointNetPPVonMises",
    "PointNetPPXYZ",
    "PointNetPPXYZSchmidt",
    "PointNetPPTrunk",
    "PointTransformer",
    "RingPointTransformer",
    "STN3d",
    "STNkd",
    "SetAbstraction",
    "SharedMLP",
    "SimplePointNet",
    "moe_ep_param_specs",
    "shard_moe_params",
]
