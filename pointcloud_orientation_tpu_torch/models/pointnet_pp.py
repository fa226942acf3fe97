"""PointNet++ orientation heads in PyTorch. This slice ports the 8-way
direction head that the serving path runs."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import PointNetPPTrunk


class PointNetPP8Dir(nn.Module):
    """8-way direction head: trunk, then Linear 256 -> 8 raw logits.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPP8Dir`` (the reference's `models/pointnet_pp_8dir.py:58-85`).
    Only f32 (``dtype=None``) is ported.
    """

    def __init__(self, sampling: str = "random", grouping: str = "knn",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if grouping != "knn":
            raise NotImplementedError(f"grouping={grouping!r}: only 'knn' is ported")
        if dtype not in (None, torch.float32):
            raise NotImplementedError(f"dtype={dtype}: only float32 is ported")
        self.trunk = PointNetPPTrunk(sampling=sampling)
        self.head = nn.Linear(256, 8)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.head(self.trunk(xyz, generator))
