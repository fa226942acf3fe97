"""PointNet++ building blocks in PyTorch, eval (serving) mode.

Counterpart of ``pointcloud_orientation_tpu/models/layers.py`` on its fused
eval path: every set abstraction groups through the ``sa_group`` kernel and
runs its shared MLP and neighbour max through the ``sa_mlp_max`` kernel,
with BatchNorm folded into a per-layer scale and shift from the running
statistics (``SharedMLP._fused_max`` there). Training is the next slice of
the port (ROADMAP.md): in train mode these modules raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import cuda_kernels as K
from ..ops import geometry as G

BN_EPS = 1e-5

_TRAIN_NOT_PORTED = (
    "train mode is not ported yet: training and its backward kernels are the next "
    "slice of the PyTorch/CUDA port (ROADMAP.md)")


class SharedMLP(nn.Module):
    """Pointwise Linear + BatchNorm + ReLU stack fused with the max over the
    neighbour axis: ``(B, K, S, C_in)`` neighbour-major -> ``(B, S, C_out)``."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        widths = [in_channels, *channels]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(nn.BatchNorm1d(c, eps=BN_EPS) for c in channels)

    def folded_layers(self) -> List[K.Layer]:
        """``(W (Cin,Cout), scale, shift)`` per layer with the running-stats
        BatchNorm folded in: ``s = gamma * rsqrt(var + eps)``,
        ``t = (bias - mean) * s + beta``."""
        layers = []
        for lin, bn in zip(self.linears, self.bns):
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            t = (lin.bias - bn.running_mean) * s + bn.bias
            layers.append((lin.weight.t().contiguous(), s.contiguous(), t.contiguous()))
        return layers

    def forward(self, grouped: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(_TRAIN_NOT_PORTED)
        return K.sa_mlp_max(grouped.contiguous(), self.folded_layers())


class SetAbstraction(nn.Module):
    """Sample centroids, group their nearest neighbours, shared MLP, max.

    ``sampling``: ``"random"`` (draws from the generator passed to
    ``forward``; without one it takes the first points, as the JAX module does
    without a ``sampling`` rng) or ``"first"``. ``group_all`` pools the whole
    cloud with uncentered coordinates.
    """

    def __init__(self, npoint: Optional[int], nsample: Optional[int], in_channels: int,
                 mlp_channels: Sequence[int], group_all: bool = False,
                 sampling: str = "random"):
        super().__init__()
        if sampling not in ("random", "first"):
            raise NotImplementedError(
                f"sampling={sampling!r}: only 'random' and 'first' are ported")
        self.npoint = npoint
        self.nsample = nsample
        self.group_all = group_all
        self.sampling = sampling
        self.mlp = SharedMLP(in_channels, mlp_channels)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            raise NotImplementedError(_TRAIN_NOT_PORTED)
        if self.group_all:
            new_xyz, grouped = G.group_all(xyz, points)
            grouped = grouped.transpose(1, 2)  # (B, N, 1, C): N neighbours of one centroid
        else:
            sampling = self.sampling
            if sampling == "random" and generator is None:
                sampling = "first"
            new_xyz, grouped = G.sample_and_group(
                xyz, points, self.npoint, self.nsample, generator=generator,
                sampling=sampling, neighbor_major=True)
        return new_xyz, self.mlp(grouped)


class PointNetPPTrunk(nn.Module):
    """Three set abstractions and the FC funnel to a 256-d feature.

    sa1 = SA(128, 32, [64, 64, 128]); sa2 = SA(32, 32, [128, 128, 256]);
    sa3 = SA(group_all, [256, 512, 1024]); fc 1024 -> 512 -> 256 with
    BatchNorm and ReLU. Dropout is the identity in eval, the only mode ported.
    """

    def __init__(self, sampling: str = "random"):
        super().__init__()
        self.sa1 = SetAbstraction(128, 32, 3, (64, 64, 128), sampling=sampling)
        self.sa2 = SetAbstraction(32, 32, 3 + 128, (128, 128, 256), sampling=sampling)
        self.sa3 = SetAbstraction(None, None, 3 + 256, (256, 512, 1024), group_all=True,
                                  sampling=sampling)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512, eps=BN_EPS)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256, eps=BN_EPS)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(_TRAIN_NOT_PORTED)
        l1_xyz, l1_pts = self.sa1(xyz, None, generator)
        l2_xyz, l2_pts = self.sa2(l1_xyz, l1_pts, generator)
        _, l3_pts = self.sa3(l2_xyz, l2_pts)
        x = l3_pts.reshape(xyz.shape[0], -1)  # (B, 1024)
        x = F.relu(self.bn1(self.fc1(x)))
        return F.relu(self.bn2(self.fc2(x)))
