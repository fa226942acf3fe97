"""PointNet++ models in PyTorch: the heads on the shared trunk (8-way
direction logits, unit forward vector, single-peak von Mises, mixture of von
Mises; the SO(3) heads: a raw forward vector and the two-axis heads) and the
ModelNet40 classifier, served and trained."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import layers
from .layers import BN_EPS, PointNetPPTrunk, SetAbstraction, compute_dtype, flax_batch_norm_train


def _trunk(sampling: str, grouping: str, dtype, fused_mlp_train: bool, p_drop: float,
           **kw) -> PointNetPPTrunk:
    return PointNetPPTrunk(sampling=sampling, grouping=grouping, p_drop=p_drop,
                           fused_mlp_train=fused_mlp_train, dtype=compute_dtype(dtype), **kw)


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


class PointNetPP(nn.Module):
    """Forward-vector regression head: trunk, then Linear 256 -> 3, raw.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPP`` (the reference's `models/pointnet_pp.py:45-68`); the
    trunk's options as :class:`PointNetPP8Dir`'s.
    """

    def __init__(self, sampling: str = "random", grouping: str = "knn",
                 dtype=None, fused_mlp_train: bool = False, p_drop: float = 0.5):
        super().__init__()
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop)
        self.head = nn.Linear(256, 3)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.head(self.trunk(xyz, generator))


class PointNetPPXYZ(nn.Module):
    """Two-axis regression: ``head_x`` and ``head_y``, each Linear 256 -> 3
    and L2-normalised unless ``normalize_heads=False`` (the reference's
    no-L2-norm ablation). Returns ``(v_x, v_y)``.

    Counterpart of ``PointNetPPXYZ`` there; the trunk's options as
    :class:`PointNetPP8Dir`'s.
    """

    HEADS = ("head_x", "head_y")

    def __init__(self, sampling: str = "random", grouping: str = "knn", dtype=None,
                 normalize_heads: bool = True, fused_mlp_train: bool = False,
                 p_drop: float = 0.5):
        super().__init__()
        self.normalize_heads = normalize_heads
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop)
        for name in self.HEADS:
            setattr(self, name, nn.Linear(256, 3))

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.trunk(xyz, generator)
        a, b = (getattr(self, name)(feat) for name in self.HEADS)
        if self.normalize_heads:
            a, b = l2_normalize(a), l2_normalize(b)
        return a, b


class PointNetPPXYZSchmidt(PointNetPPXYZ):
    """Up/forward two-axis regression: ``head_y`` (up) and ``head_z``
    (forward), each L2-normalised unless ``normalize_heads=False``; with
    ``gram_schmidt`` the up vector becomes ``l2_normalize(v_y - (v_y . v_z)
    v_z)``, normalised even when the heads are not (as in the JAX model).
    Returns ``(up, forward)``.

    Counterpart of ``PointNetPPXYZSchmidt`` there; the trunk's options as
    :class:`PointNetPP8Dir`'s.
    """

    HEADS = ("head_y", "head_z")

    def __init__(self, gram_schmidt: bool = False, sampling: str = "random",
                 grouping: str = "knn", dtype=None, normalize_heads: bool = True,
                 fused_mlp_train: bool = False, p_drop: float = 0.5):
        super().__init__(sampling, grouping, dtype, normalize_heads, fused_mlp_train, p_drop)
        self.gram_schmidt = gram_schmidt

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        up, fwd = super().forward(xyz, generator)
        if self.gram_schmidt:
            up = l2_normalize(up - (up * fwd).sum(dim=-1, keepdim=True) * fwd)
        return up, fwd


class PointNetPP8Dir(nn.Module):
    """8-way direction head: trunk, then Linear 256 -> 8 raw logits.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPP8Dir`` (the reference's `models/pointnet_pp_8dir.py:58-85`).
    The trunk takes ``sampling`` ``"random"``, ``"first"`` or ``"fps"`` and
    ``grouping`` ``"knn"`` or ``"ball"`` (radius 0.2 at sa1 and sa2), in f32
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
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop)
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
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop)
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
        if mu_parameterization not in ("tanh", "atan2"):
            raise ValueError(f"mu_parameterization={mu_parameterization!r}: 'tanh' or 'atan2'")
        self.mu_parameterization = mu_parameterization
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop)
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
    ``min(softplus + 1e-6, kappa_max)``. The trunk, its LayerNorm funnel
    included, computes in f32 or bf16 (``dtype``).
    """

    def __init__(self, max_K: int = 4, kappa_max: float = 80.0, p_drop: float = 0.4,
                 temp: float = 0.7, sampling: str = "random", grouping: str = "knn",
                 dtype=None, weight_floor: float = 0.0, mu_init: str = "zero",
                 fused_mlp_train: bool = False):
        super().__init__()
        if mu_init not in ("zero", "spread"):
            raise ValueError(f"mu_init={mu_init!r}: 'zero' or 'spread'")
        self.max_K, self.kappa_max, self.temp = max_K, kappa_max, temp
        self.weight_floor, self.mu_init = weight_floor, mu_init
        self.trunk = _trunk(sampling, grouping, dtype, fused_mlp_train, p_drop,
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
    """The ModelNet40 classifier with FPS and radius ball query.

    Counterpart of ``pointcloud_orientation_tpu/models/pointnet_pp.py``
    ``PointNetPPCls`` (the reference's `PointNet++Demo.py:177-245`):
    SA(512, r=0.2, K=32, [64, 64, 128]) -> SA(128, r=0.4, K=64,
    [128, 128, 256]) -> group-all [256, 512, 1024] -> Linear 1024 -> 512,
    BatchNorm, ReLU, dropout 0.4 -> 256, BatchNorm, ReLU, dropout 0.4 ->
    ``num_classes``, then ``log_softmax``. Takes ``(B, N, in_channels)``
    clouds: xyz (``in_channels=3``) or xyz and normals (6). ``generator``
    draws the FPS start points of both stages and, in train, the dropout
    masks; without one both stages start at index 0 (and train mode
    refuses dropout). In train the FC BatchNorms follow flax (momentum 0.9)
    and ``fused_mlp_train`` picks the set abstractions' train configuration
    (``models/layers.py``). Like the JAX model it has no ``dtype``: a
    trainer leaves it in f32 whatever its config's ``compute_dtype`` says,
    as the JAX ``Trainer._build_model`` does.
    """

    P_DROP = 0.4

    def __init__(self, num_classes: int = 40, in_channels: int = 3,
                 fused_mlp_train: bool = False):
        super().__init__()
        if in_channels < 3:
            raise ValueError(f"in_channels={in_channels}: the clouds carry xyz first")
        sa = dict(sampling="fps", grouping="ball", fused_mlp_train=fused_mlp_train)
        self.in_channels = in_channels
        self.sa1 = SetAbstraction(512, 32, in_channels, (64, 64, 128), radius=0.2, **sa)
        self.sa2 = SetAbstraction(128, 64, 3 + 128, (128, 128, 256), radius=0.4, **sa)
        self.sa3 = SetAbstraction(None, None, 3 + 256, (256, 512, 1024), group_all=True,
                                  fused_mlp_train=fused_mlp_train)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512, eps=BN_EPS)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256, eps=BN_EPS)
        self.fc3 = nn.Linear(256, num_classes)

    def _fc(self, h: torch.Tensor, lin: nn.Linear, bn: nn.BatchNorm1d,
            generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training:
            return F.relu(bn(lin(h)))
        return layers.dropout(F.relu(flax_batch_norm_train(lin(h), bn)), self.P_DROP, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if x.dim() != 3 or x.shape[-1] != self.in_channels:
            raise ValueError(f"x must be (B, N, {self.in_channels}), got {tuple(x.shape)}")
        xyz = x[..., :3].contiguous()
        points = x[..., 3:].contiguous() if self.in_channels > 3 else None
        l1_xyz, l1_pts = self.sa1(xyz, points, generator)
        l2_xyz, l2_pts = self.sa2(l1_xyz, l1_pts, generator)
        _, l3_pts = self.sa3(l2_xyz, l2_pts)
        h = l3_pts.reshape(x.shape[0], -1)  # (B, 1024)
        h = self._fc(h, self.fc1, self.bn1, generator)
        h = self._fc(h, self.fc2, self.bn2, generator)
        return F.log_softmax(self.fc3(h), dim=-1)
