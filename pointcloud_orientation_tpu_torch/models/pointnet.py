"""Classic PointNet with its input and feature spatial transformer networks,
in PyTorch, eval (serving) and train mode.

Counterpart of ``pointcloud_orientation_tpu/models/pointnet.py`` (the
reference's `models/pointnet.py:6-129` and the demo classifier
`PointNetDemo.py:139-172`): ``STN3d``, ``STNkd``, ``PointNetEncoder``,
``PointNet``, ``PointNetCls`` and ``feature_transform_regularizer``. Every
module takes feature-last ``(B, N, C)`` clouds. The dense layers are
``nn.Linear`` and the transforms ``torch.bmm`` in f32, which the JAX package
leaves to XLA at ``Precision.HIGHEST``: no TPU kernel is involved, so none
is ported, and the card runs them in cuBLAS with TF32 off
(``cuda_kernels.f32_matmuls``, which the predictor and the trainer set).
BatchNorm follows flax over the last axis (momentum 0.9, epsilon 1e-5,
statistics over every leading axis, ``models/layers.py``) and dropout is
flax's inverted dropout (``layers.dropout``) with the caller's generator.
No ``dtype``: f32, as the JAX models.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from . import layers
from .layers import BN_EPS, flax_batch_norm_train

__all__ = ["DenseBN", "PointNet", "PointNetCls", "PointNetEncoder", "STN3d", "STNkd",
           "feature_transform_regularizer"]


def flax_batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis from the running statistics,
    as flax computes it: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``."""
    return (x - bn.running_mean) * (torch.rsqrt(bn.running_var + bn.eps) * bn.weight) + bn.bias


class DenseBN(nn.Module):
    """``flax.linen.Dense`` then ``BatchNorm`` over the last axis of any
    ``(..., C_in)`` input; no activation."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, out_features)
        self.bn = nn.BatchNorm1d(out_features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.lin(x)
        if self.training:
            return flax_batch_norm_train(z, self.bn)
        return flax_batch_norm_eval(z, self.bn)


class _STN(nn.Module):
    """A transform net: pointwise 64 -> 128 -> 1024, the max over points,
    512 -> 256 (each Linear + BatchNorm + ReLU), then Linear 256 -> k*k plus
    the identity, ``(B, k, k)``."""

    def __init__(self, in_channels: int, k: int):
        super().__init__()
        self.k = k
        self.conv1 = DenseBN(in_channels, 64)
        self.conv2 = DenseBN(64, 128)
        self.conv3 = DenseBN(128, 1024)
        self.fc1 = DenseBN(1024, 512)
        self.fc2 = DenseBN(512, 256)
        self.fc3 = nn.Linear(256, k * k)

    def bn_fed_biases(self) -> List[str]:
        return [f"{n}.lin.bias" for n in ("conv1", "conv2", "conv3", "fc1", "fc2")]

    def shift_biases(self) -> Dict[str, str]:
        """The shift before the max whose pooled output feeds ``fc1``'s
        train BatchNorm, and its sibling scale (``utils/grad_check.py``)."""
        return {"conv3.bn.bias": "conv3.bn.weight"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for block in (self.conv1, self.conv2, self.conv3):
            h = torch.relu(block(h))
        h = h.amax(dim=1)
        for block in (self.fc1, self.fc2):
            h = torch.relu(block(h))
        h = self.fc3(h) + torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return h.reshape(-1, self.k, self.k)


class STN3d(_STN):
    """Input transform net: a 3x3 matrix from ``(B, N, in_channels)``
    (the JAX package's ``STN3d``, the reference's `models/pointnet.py:6-34`)."""

    def __init__(self, in_channels: int = 3):
        super().__init__(in_channels, 3)


class STNkd(_STN):
    """Feature transform net: a k x k matrix from ``(B, N, k)`` features
    (the JAX package's ``STNkd``, `models/pointnet.py:36-65` there)."""

    def __init__(self, k: int = 64):
        super().__init__(k, k)


class PointNetEncoder(nn.Module):
    """PointNet's global-feature encoder: the input transform on the xyz
    channels (the other ``in_channels - 3`` pass around it), Linear 64 +
    BatchNorm + ReLU, the feature transform when ``feature_transform``,
    128 + BatchNorm + ReLU, 1024 + BatchNorm, the max over points. Returns
    ``(feat, trans, trans_feat)``: ``feat (B, 1024)``, or with
    ``global_feat=False`` the per-point ``(B, N, 1088)`` of the pooled
    feature beside the transformed 64-wide features; ``trans_feat`` is None
    without the feature transform."""

    def __init__(self, in_channels: int = 3, global_feat: bool = True,
                 feature_transform: bool = False):
        super().__init__()
        self.global_feat = global_feat
        self.stn = STN3d(in_channels)
        self.conv1 = DenseBN(in_channels, 64)
        self.fstn = STNkd(64) if feature_transform else None
        self.conv2 = DenseBN(64, 128)
        self.conv3 = DenseBN(128, 1024)

    def bn_fed_biases(self) -> List[str]:
        return [f"{n}.lin.bias" for n in ("conv1", "conv2", "conv3")]

    def shift_biases(self) -> Dict[str, str]:
        return {"conv3.bn.bias": "conv3.bn.weight"}

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        trans = self.stn(x)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if x.shape[-1] > 3 else xyz
        x = torch.relu(self.conv1(x))
        trans_feat = None
        if self.fstn is not None:
            trans_feat = self.fstn(x)
            x = torch.bmm(x, trans_feat)
        point_feat = x
        x = torch.relu(self.conv2(x))
        x = self.conv3(x).amax(dim=1)
        if self.global_feat:
            return x, trans, trans_feat
        expanded = x[:, None, :].expand(-1, point_feat.shape[1], -1)
        return torch.cat([expanded, point_feat], dim=-1), trans, trans_feat


class _PointNetHead(nn.Module):
    """Encoder, Linear 1024 -> 512 + BatchNorm + ReLU, Linear 512 -> 256,
    dropout 0.4 in train, BatchNorm + ReLU, Linear 256 -> ``out_features``."""

    P_DROP = 0.4

    def __init__(self, in_channels: int, feature_transform: bool, out_features: int):
        super().__init__()
        self.in_channels = in_channels
        self.encoder = PointNetEncoder(in_channels, feature_transform=feature_transform)
        self.fc1 = DenseBN(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256, eps=BN_EPS)
        self.fc3 = nn.Linear(256, out_features)

    def bn_fed_biases(self) -> List[str]:
        return ["fc1.lin.bias"]  # fc2's output is dropped out before its BatchNorm

    def _features(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        feat, _, trans_feat = self.encoder(x)
        h = self.fc2(torch.relu(self.fc1(feat)))
        if self.training:
            h = torch.relu(flax_batch_norm_train(layers.dropout(h, self.P_DROP, generator),
                                                 self.bn2))
        else:
            h = torch.relu(flax_batch_norm_eval(h, self.bn2))
        return self.fc3(h), trans_feat


class PointNet(_PointNetHead):
    """PointNet regression: a raw forward vector ``(B, 3)`` (the JAX
    package's ``PointNet``, the reference's `models/pointnet.py:111-129`),
    with the feature transform unless ``feature_transform=False``.
    ``generator`` draws the dropout mask in train."""

    def __init__(self, in_channels: int = 3, feature_transform: bool = True):
        super().__init__(in_channels, feature_transform, 3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self._features(x, generator)[0]


class PointNetCls(_PointNetHead):
    """The PointNet ModelNet40 classifier with the feature transform:
    ``(log_probs (B, num_classes), trans_feat (B, 64, 64))``, as the JAX
    package's ``PointNetCls`` (the reference's ``get_model``,
    `PointNetDemo.py:139-161`). ``generator`` draws the dropout mask in
    train."""

    def __init__(self, num_classes: int = 40, in_channels: int = 3):
        super().__init__(in_channels, True, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, trans_feat = self._features(x, generator)
        return F.log_softmax(logits, dim=-1), trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """``mean_b ||T_b T_b^T - I||_F``, the feature transform's
    orthogonality penalty (the reference's ``feature_transform_reguliarzer``,
    `PointNetDemo.py:131-137`)."""
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    prod = torch.bmm(trans, trans.transpose(1, 2))
    return torch.sqrt(((prod - eye) ** 2).sum(dim=(1, 2))).mean()
