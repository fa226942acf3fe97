"""PointNet++ orientation heads in PyTorch. The port carries the 8-way
direction head, which the serving and training slices run."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import PointNetPPTrunk


class PointNetPP8Dir(nn.Module):
    """8-way direction head: trunk, then Linear 256 -> 8 raw logits.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPP8Dir`` (the reference's `models/pointnet_pp_8dir.py:58-85`).
    Only f32 (``dtype=None``) is ported. ``fused_mlp_train`` picks the train
    configuration of the shared MLPs (``models/layers.py``); ``p_drop`` is
    the trunk's dropout. ``generator`` feeds the centroid sampling and, in
    train, the dropout mask.
    """

    def __init__(self, sampling: str = "random", grouping: str = "knn",
                 dtype: Optional[torch.dtype] = None, fused_mlp_train: bool = False,
                 p_drop: float = 0.5):
        super().__init__()
        if grouping != "knn":
            raise NotImplementedError(f"grouping={grouping!r}: only 'knn' is ported")
        if dtype not in (None, torch.float32):
            raise NotImplementedError(f"dtype={dtype}: only float32 is ported")
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train)
        self.head = nn.Linear(256, 8)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.head(self.trunk(xyz, generator))
