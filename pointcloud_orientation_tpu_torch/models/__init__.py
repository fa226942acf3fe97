"""PyTorch models of the port: the PointNet++ 8-dir model, in eval and
train mode, and the PointNet++ ModelNet40 classifier, in eval."""

from .layers import PointNetPPTrunk, SetAbstraction, SharedMLP
from .pointnet_pp import PointNetPP8Dir, PointNetPPCls

MODEL_REGISTRY = {
    "pointnet_pp_8dir": PointNetPP8Dir,
    "pointnet_pp_cls": PointNetPPCls,
}

__all__ = [
    "MODEL_REGISTRY",
    "PointNetPP8Dir",
    "PointNetPPCls",
    "PointNetPPTrunk",
    "SetAbstraction",
    "SharedMLP",
]
