"""PyTorch models of the port: the PointNet++ 8-dir model, in eval and
train mode."""

from .layers import PointNetPPTrunk, SetAbstraction, SharedMLP
from .pointnet_pp import PointNetPP8Dir

MODEL_REGISTRY = {
    "pointnet_pp_8dir": PointNetPP8Dir,
}

__all__ = [
    "MODEL_REGISTRY",
    "PointNetPP8Dir",
    "PointNetPPTrunk",
    "SetAbstraction",
    "SharedMLP",
]
