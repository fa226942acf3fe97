"""PointNet++ models in PyTorch: the yaw heads on the shared trunk (8-way
direction logits, unit forward vector, single-peak von Mises, mixture of von
Mises), served and trained, and the ModelNet40 classifier, served in eval."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .layers import BN_EPS, PointNetPPTrunk, SetAbstraction, compute_dtype


def _check_trunk_modes(sampling: str, grouping: str) -> None:
    if grouping != "knn":
        raise NotImplementedError(f"grouping={grouping!r}: the trunk's heads take only 'knn'")
    if sampling not in ("random", "first"):
        raise NotImplementedError(
            f"sampling={sampling!r}: the trunk's heads take only 'random' and 'first'")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(|x|, eps)`` over the last axis with the norm taken as
    ``sqrt(max(sum(x^2), 1e-24))``, so its gradient at ``x = 0`` is 0, not
    NaN (the JAX package's ``_l2_normalize``)."""
    n = torch.sqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=True), 1e-24))
    return x / torch.clamp_min(n, eps)


def guarded_angle(cs: torch.Tensor) -> torch.Tensor:
    """``atan2(s, c)`` of ``cs (..., 2)`` scaled to unit length with eps
    1e-4; a near-zero vector (unit length below 1e-3) gives angle 0. The
    guards keep the gradient finite, and 0, at ``cs = 0`` (the MvM head's
    zero-init point): every ``torch.where`` picks between values that are
    finite on both sides."""
    n = torch.sqrt(torch.clamp_min((cs * cs).sum(dim=-1, keepdim=True), 1e-24))
    unit = cs / torch.clamp_min(n, 1e-4)
    c, s = unit[..., 0], unit[..., 1]
    degenerate = torch.hypot(c, s) < 1e-3
    c = torch.where(degenerate, torch.ones_like(c), c)
    s = torch.where(degenerate, torch.zeros_like(s), s)
    return torch.atan2(s, c)


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
        _check_trunk_modes(sampling, grouping)
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype))
        self.head = nn.Linear(256, 8)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.head(self.trunk(xyz, generator))


class PointNetPPFwd(nn.Module):
    """Unit forward-vector head: trunk, Linear 256 -> 3, L2-normalised.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPPFwd``; the trunk's options as :class:`PointNetPP8Dir`'s.
    """

    def __init__(self, sampling: str = "random", grouping: str = "knn",
                 dtype=None, fused_mlp_train: bool = False, p_drop: float = 0.5):
        super().__init__()
        _check_trunk_modes(sampling, grouping)
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype))
        self.head = nn.Linear(256, 3)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return l2_normalize(self.head(self.trunk(xyz, generator)))


class PointNetPPVonMises(nn.Module):
    """Single-peak von Mises head: returns ``(mu (B,), kappa (B,))``.

    Counterpart of ``PointNetPPVonMises`` there. ``mu_parameterization``
    ``"tanh"``: Linear 256 -> 2, ``mu = tanh(out0) * pi``; ``"atan2"``:
    Linear 256 -> 3, ``mu`` the guarded angle of ``out[:2]``
    (:func:`guarded_angle`). ``kappa = softplus`` of the last output. The
    trunk's options as :class:`PointNetPP8Dir`'s.
    """

    def __init__(self, mu_parameterization: str = "tanh", sampling: str = "random",
                 grouping: str = "knn", dtype=None, fused_mlp_train: bool = False,
                 p_drop: float = 0.5):
        super().__init__()
        _check_trunk_modes(sampling, grouping)
        if mu_parameterization not in ("tanh", "atan2"):
            raise ValueError(f"mu_parameterization={mu_parameterization!r}: 'tanh' or 'atan2'")
        self.mu_parameterization = mu_parameterization
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype))
        self.head = nn.Linear(256, 3 if mu_parameterization == "atan2" else 2)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.head(self.trunk(xyz, generator))
        if self.mu_parameterization == "atan2":
            return guarded_angle(out[:, :2]), F.softplus(out[:, 2])
        return torch.tanh(out[:, 0]) * math.pi, F.softplus(out[:, 1])


def mu_bias_init(max_K: int, mu_init: str) -> np.ndarray:
    """The MvM head's initial ``head_mu`` bias ``(2 max_K,)``: zeros, or for
    ``"spread"`` the (cos, sin) of the angles ``2 pi k / max_K``,
    interleaved."""
    if mu_init == "zero":
        return np.zeros(2 * max_K, np.float32)
    angles = 2.0 * np.pi * np.arange(max_K) / max_K
    return np.stack([np.cos(angles), np.sin(angles)], -1).reshape(-1).astype(np.float32)


class PointNetPPMvM(nn.Module):
    """Mixture-of-von-Mises head over the LayerNorm trunk: returns ``(mu,
    kappa, weight)``, each ``(B, max_K)``.

    Counterpart of ``PointNetPPMvM`` there: the trunk with ``fc_norm="layer"``
    and dropout ``p_drop`` after each FC; ``head_pi`` (zero-init kernel) gives
    ``weight = softmax(logits / temp)``, mixed with ``weight_floor / max_K``
    when set; ``head_mu`` (zero-init kernel; bias zero, or with
    ``mu_init="spread"`` the unit vectors at angles ``2 pi k / max_K``) gives
    ``max_K`` guarded angles (:func:`guarded_angle`); ``head_kappa`` gives
    ``min(softplus + 1e-6, kappa_max)``. f32 only (the LayerNorm funnel).
    """

    def __init__(self, max_K: int = 4, kappa_max: float = 80.0, p_drop: float = 0.4,
                 temp: float = 0.7, sampling: str = "random", grouping: str = "knn",
                 dtype=None, weight_floor: float = 0.0, mu_init: str = "zero",
                 fused_mlp_train: bool = False):
        super().__init__()
        _check_trunk_modes(sampling, grouping)
        if mu_init not in ("zero", "spread"):
            raise ValueError(f"mu_init={mu_init!r}: 'zero' or 'spread'")
        self.max_K, self.kappa_max, self.temp = max_K, kappa_max, temp
        self.weight_floor, self.mu_init = weight_floor, mu_init
        self.trunk = PointNetPPTrunk(sampling=sampling, p_drop=p_drop,
                                     fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype),
                                     fc_norm="layer", drop_each_fc=True)
        self.head_pi = nn.Linear(256, max_K)
        self.head_mu = nn.Linear(256, 2 * max_K)
        self.head_kappa = nn.Linear(256, max_K)
        self.reset_head_parameters()

    @torch.no_grad()
    def reset_head_parameters(self) -> None:
        """The flax initialisation of ``head_pi`` and ``head_mu``: zero
        kernels, zero bias, ``head_mu``'s bias from :func:`mu_bias_init`."""
        for lin in (self.head_pi, self.head_mu):
            lin.weight.zero_()
            lin.bias.zero_()
        self.head_mu.bias.copy_(torch.from_numpy(mu_bias_init(self.max_K, self.mu_init)))

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feat = self.trunk(xyz, generator)
        weight = torch.softmax(self.head_pi(feat) / self.temp, dim=-1)
        if self.weight_floor:
            f = self.weight_floor
            weight = (1.0 - f) * weight + f / self.max_K
        mu = guarded_angle(self.head_mu(feat).reshape(-1, self.max_K, 2))
        kappa = torch.clamp_max(F.softplus(self.head_kappa(feat)) + 1e-6, self.kappa_max)
        return mu, kappa, weight


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
