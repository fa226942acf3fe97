"""PointNet++ models in PyTorch: the 8-way direction head, which the serving
and training slices run, and the ModelNet40 classifier, served in eval."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BN_EPS, PointNetPPTrunk, SetAbstraction, compute_dtype


class PointNetPP8Dir(nn.Module):
    """8-way direction head: trunk, then Linear 256 -> 8 raw logits.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPP8Dir`` (the reference's `models/pointnet_pp_8dir.py:58-85`).
    The kNN trunk with ``random`` or ``first`` centroids is ported, in f32
    (``dtype=None``) or bf16 (``dtype=torch.bfloat16`` or ``"bfloat16"``,
    flax's ``dtype=jnp.bfloat16``: the trunk computes in bf16 and returns
    f32, the head is f32; ``models/layers.py``). ``fused_mlp_train`` picks
    the train configuration of the shared MLPs; ``p_drop`` is the trunk's
    dropout. ``generator`` feeds the centroid sampling and, in train, the
    dropout mask.
    """

    def __init__(self, sampling: str = "random", grouping: str = "knn",
                 dtype=None, fused_mlp_train: bool = False, p_drop: float = 0.5):
        super().__init__()
        if grouping != "knn":
            raise NotImplementedError(f"grouping={grouping!r}: the 8-dir model takes only 'knn'")
        if sampling not in ("random", "first"):
            raise NotImplementedError(
                f"sampling={sampling!r}: the 8-dir model takes only 'random' and 'first'")
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype))
        self.head = nn.Linear(256, 8)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.head(self.trunk(xyz, generator))


class PointNetPPCls(nn.Module):
    """The ModelNet40 classifier with FPS and radius ball query, in eval.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPPCls`` (the reference's `PointNet++Demo.py:177-245`):
    SA(512, r=0.2, K=32, [64, 64, 128]) -> SA(128, r=0.4, K=64,
    [128, 128, 256]) -> group-all [256, 512, 1024] -> Linear 1024 -> 512,
    BatchNorm, ReLU -> 256, BatchNorm, ReLU -> ``num_classes``, then
    ``log_softmax``. Takes ``(B, N, in_channels)`` clouds: xyz
    (``in_channels=3``) or xyz and normals (6). ``generator`` draws the
    FPS start points; without one both stages start at index 0. Train mode
    (dropout 0.4 after each FC) is not ported.
    """

    def __init__(self, num_classes: int = 40, in_channels: int = 3):
        super().__init__()
        if in_channels < 3:
            raise ValueError(f"in_channels={in_channels}: the clouds carry xyz first")
        sa = dict(sampling="fps", grouping="ball")
        self.in_channels = in_channels
        self.sa1 = SetAbstraction(512, 32, in_channels, (64, 64, 128), radius=0.2, **sa)
        self.sa2 = SetAbstraction(128, 64, 3 + 128, (128, 128, 256), radius=0.4, **sa)
        self.sa3 = SetAbstraction(None, None, 3 + 256, (256, 512, 1024), group_all=True)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512, eps=BN_EPS)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256, eps=BN_EPS)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "PointNetPPCls trains in a later slice of the port (task 'classification'); "
                "call .eval() to serve it")
        if x.dim() != 3 or x.shape[-1] != self.in_channels:
            raise ValueError(f"x must be (B, N, {self.in_channels}), got {tuple(x.shape)}")
        xyz = x[..., :3].contiguous()
        points = x[..., 3:].contiguous() if self.in_channels > 3 else None
        l1_xyz, l1_pts = self.sa1(xyz, points, generator)
        l2_xyz, l2_pts = self.sa2(l1_xyz, l1_pts, generator)
        _, l3_pts = self.sa3(l2_xyz, l2_pts)
        h = l3_pts.reshape(x.shape[0], -1)  # (B, 1024)
        h = F.relu(self.bn1(self.fc1(h)))
        h = F.relu(self.bn2(self.fc2(h)))
        return F.log_softmax(self.fc3(h), dim=-1)
