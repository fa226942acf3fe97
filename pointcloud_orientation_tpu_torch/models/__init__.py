"""PyTorch models of the port: the PointNet++ yaw heads (8-dir, unit
forward, von Mises, mixture of von Mises), in eval and train mode, and the
PointNet++ ModelNet40 classifier, in eval."""

from .layers import PointNetPPTrunk, SetAbstraction, SharedMLP
from .pointnet_pp import (
    PointNetPP8Dir,
    PointNetPPCls,
    PointNetPPFwd,
    PointNetPPMvM,
    PointNetPPVonMises,
)

MODEL_REGISTRY = {
    "pointnet_pp_8dir": PointNetPP8Dir,
    "pointnet_pp_fwd": PointNetPPFwd,
    "pointnet_pp_von_mises": PointNetPPVonMises,
    "pointnet_pp_mvm": PointNetPPMvM,
    "pointnet_pp_cls": PointNetPPCls,
}

__all__ = [
    "MODEL_REGISTRY",
    "PointNetPP8Dir",
    "PointNetPPCls",
    "PointNetPPFwd",
    "PointNetPPMvM",
    "PointNetPPVonMises",
    "PointNetPPTrunk",
    "SetAbstraction",
    "SharedMLP",
]
