"""The small PointNet-style baseline of the reference's simplest script, in
PyTorch.

Counterpart of ``pointcloud_orientation_tpu/models/simple_pointnet.py``
``SimplePointNet`` (the reference's `simple_pointnet_train.py:86-113`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import layers
from .pointnet import DenseBN


class SimplePointNet(nn.Module):
    """Pointwise Linear + BatchNorm + ReLU ``in_channels -> 64 -> 128 ->
    256``, the max over points, then Linear 256 -> 128 + BatchNorm + ReLU,
    dropout 0.3 in train, and Linear 128 -> 3: a raw forward vector ``(B,
    3)`` from ``(B, N, in_channels)`` clouds. BatchNorm follows flax
    (momentum 0.9, epsilon 1e-5, statistics over every leading axis);
    ``generator`` draws the dropout mask in train. No ``dtype``: f32, as the
    JAX model."""

    P_DROP = 0.3

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = DenseBN(in_channels, 64)
        self.conv2 = DenseBN(64, 128)
        self.conv3 = DenseBN(128, 256)
        self.fc1 = DenseBN(256, 128)
        self.fc2 = nn.Linear(128, 3)

    def bn_fed_biases(self):
        """The Dense biases that a train-mode BatchNorm normalises."""
        return [f"{name}.lin.bias" for name in ("conv1", "conv2", "conv3", "fc1")]

    def shift_biases(self):
        """The shift before the max whose pooled output feeds ``fc1``'s
        train BatchNorm, and its sibling scale (``utils/grad_check.py``)."""
        return {"conv3.bn.bias": "conv3.bn.weight"}

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = x
        for block in (self.conv1, self.conv2, self.conv3):
            h = torch.relu(block(h))
        h = torch.relu(self.fc1(h.amax(dim=1)))
        if self.training:
            h = layers.dropout(h, self.P_DROP, generator)
        return self.fc2(h)
