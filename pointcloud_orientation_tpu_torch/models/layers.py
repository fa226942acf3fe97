"""PointNet++ building blocks in PyTorch, eval (serving) and train mode.

Counterpart of ``pointcloud_orientation_tpu/models/layers.py``. In eval every
set abstraction samples and groups through the kernels that
``geometry.sample_and_group`` picks and runs its shared MLP and neighbour
max through the ``sa_mlp_max`` kernel, with BatchNorm
folded into a per-layer scale and shift from the running statistics
(``SharedMLP._fused_max`` there). In train, BatchNorm follows flax: biased
batch variance ``max(0, E[x^2] - E[x]^2)`` and running statistics updated as
``0.9 * old + 0.1 * batch``. The shared MLP then runs in one of the JAX
package's two train configurations:

* default (``fused_mlp_train=False``, the JAX default): Linear + BatchNorm
  over all rows + ReLU in plain PyTorch, then the max over neighbours; the
  grouping's gradient reaches its features through the scatter kernel
  (``cuda_kernels.SAGroupFeatsFn``).
* ``fused_mlp_train=True`` (``PCOT_FUSED_MLP=1`` there): BatchNorm statistics
  from the ghost rows ``grouped[:, ::GHOST_STRIDE]``, differentiable, folded
  into scale and shift, then the ``sa_mlp_max`` kernel and its recompute
  backward kernel (``cuda_kernels.SAMlpMaxFn``).

``dtype=torch.bfloat16`` is flax's ``dtype=jnp.bfloat16`` (the JAX package's
``compute_dtype="bfloat16"``). A Dense rounds its input, kernel and bias to
bf16, rounds the product (accumulated in f32) to bf16 and then adds the bias
in bf16 (:func:`dense`). A BatchNorm takes its statistics and normalises in
f32 from the widened bf16 input and returns bf16; parameters and running
statistics stay f32. The ``sa_mlp_max`` kernel runs its bf16 variant and
returns f32. So SA outputs are f32 in eval and in the fused train path, bf16
(the max of bf16 activations) in the default train path; the grouping widens
bf16 features to f32. The trunk returns f32, and geometry is f32 throughout.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import batch_shard
from ..ops import cuda_kernels as K
from ..ops import geometry as G

BN_EPS = 1e-5
LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon
BN_MOMENTUM = 0.9  # flax: running = momentum * running + (1 - momentum) * batch
# Every GHOST_STRIDE-th neighbour slot gives the fused train path's BatchNorm
# statistics (``SharedMLP.ghost_stride`` in the JAX package's layers.py:51).
GHOST_STRIDE = 4


# the compute types the port takes, by every name a caller may give them
_COMPUTE_DTYPES = {None: None, "float32": None, torch.float32: None,
                   "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def compute_dtype(dtype) -> Optional[torch.dtype]:
    """None (f32) or ``torch.bfloat16`` from ``None``, ``"float32"``,
    ``"bfloat16"`` or the torch dtypes; any other raises
    ``NotImplementedError``."""
    if dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(f"dtype={dtype!r}: the port computes in float32 or bfloat16")
    return _COMPUTE_DTYPES[dtype]


def _widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 widened to f32 (flax computes BatchNorm in at least f32); any
    other type as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at two standard
    deviations, rescaled to variance ``1/fan_in``."""
    # the standard deviation of a unit normal truncated at +-2 is 0.8796...
    s = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``flax.linen.Dense(dtype=dtype)`` with ``lin``'s parameters. In bf16:
    input, kernel and bias rounded to bf16, the product accumulated in f32
    and rounded to bf16, then the bias added in bf16 (two roundings, which
    a fused ``addmm`` would make one). Otherwise ``lin(x)``."""
    if dtype != torch.bfloat16:
        return lin(x)
    return torch.matmul(x.bfloat16(), lin.weight.t().bfloat16()) + lin.bias.bfloat16()


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and the unclamped fast variance ``E[x^2] - E[x]^2`` over every
    leading axis of ``x``; under a data-parallel shard
    (:mod:`..ops.batch_shard`) over the global batch, ``E[x]`` and
    ``E[x^2]`` all-reduced in one call."""
    rows = x.reshape(-1, x.shape[-1])
    mean, msq = rows.mean(dim=0), (rows * rows).mean(dim=0)
    if batch_shard.current() is not None:
        mean, msq = batch_shard.global_mean(torch.stack([mean, msq]))
    return mean, msq - mean * mean


def flax_batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d,
                          moments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Train-mode BatchNorm over the last axis with flax's semantics
    (``flax.linen.BatchNorm``, ``use_fast_variance=True``): statistics over
    every leading axis, the biased variance ``max(0, E[x^2] - E[x]^2)``,
    gradients through both, and ``bn``'s running statistics updated in place
    as ``0.9 * old + 0.1 * batch`` (``nn.BatchNorm1d``'s own train forward
    would store the unbiased variance). ``moments`` passes in
    ``batch_moments(x)`` where the caller has them already. A bf16 ``x`` is
    widened to f32 for the statistics and the normalisation, and the result
    rounded to bf16, as flax's ``BatchNorm(dtype=bfloat16)``."""
    mean, raw_var = batch_moments(_widen(x)) if moments is None else moments
    var = torch.clamp_min(raw_var, 0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    y = (_widen(x) - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype)


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``flax.linen.LayerNorm`` over the last axis with ``ln``'s scale and
    bias: mean and the fast variance ``max(0, E[x^2] - E[x]^2)`` per row,
    then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, the same in
    train and eval. A bf16 ``x`` is widened to f32 for the statistics and
    the normalisation and the result rounded to bf16, as flax's
    ``LayerNorm(dtype=bfloat16)``."""
    xf = _widen(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    return ((xf - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias).to(x.dtype)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Eval-mode BatchNorm from the running statistics; a bf16 ``x`` is
    normalised in f32 and the result rounded to bf16."""
    return bn(_widen(x)).to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as ``flax.linen.Dropout``: keep each entry with
    probability ``1 - p`` (mask drawn from ``generator``, at the global
    batch's shape under a data-parallel shard) and scale the kept ones by
    ``1 / (1 - p)``."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - p
    keep = batch_shard.draw(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                            *x.shape) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class SharedMLP(nn.Module):
    """Pointwise Linear + BatchNorm + ReLU stack fused with the max over the
    neighbour axis: ``(B, K, S, C_in)`` neighbour-major -> ``(B, S, C_out)``.
    ``fused_mlp_train`` picks the train configuration and ``dtype`` (None or
    ``torch.bfloat16``) the compute type (module docstring)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 fused_mlp_train: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = [in_channels, *channels]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(nn.BatchNorm1d(c, eps=BN_EPS) for c in channels)
        self.fused_mlp_train = fused_mlp_train
        self.compute_dtype = dtype
        self.bf16 = dtype == torch.bfloat16

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
        if not self.training:
            return K.sa_mlp_max(grouped.contiguous(), self.folded_layers(), self.bf16)
        if self.fused_mlp_train:
            return self._fused_train(grouped)
        x = grouped
        for lin, bn in zip(self.linears, self.bns):
            x = torch.relu(flax_batch_norm_train(dense(lin, x, self.compute_dtype), bn))
        return x.amax(dim=1)

    def _fused_train(self, grouped: torch.Tensor) -> torch.Tensor:
        """Ghost-statistics BatchNorm folded into scale and shift, then the
        fused kernel (``SharedMLP._fused_max`` with ``train=True`` there).
        The ghost rows run through the flax BatchNorm (which updates the
        running statistics and feeds the next layer's ghost rows); scale and
        shift come from the same mean and unclamped ``E[z^2] - E[z]^2``,
        differentiable, so the kernel's dscale/dshift reach W, bias, gamma
        and beta."""
        g = grouped[:, ::GHOST_STRIDE]
        flat = []
        for lin, bn in zip(self.linears, self.bns):
            zg = dense(lin, g, self.compute_dtype)
            mu, var = batch_moments(_widen(zg))
            g = torch.relu(flax_batch_norm_train(zg, bn, (mu, var)))
            s = bn.weight * torch.rsqrt(var + bn.eps)
            t = (lin.bias - mu) * s + bn.bias
            flat += [lin.weight.t().contiguous(), s, t]
        return K.SAMlpMaxFn.apply(grouped.contiguous(), self.bf16, *flat)


class SetAbstraction(nn.Module):
    """Sample centroids, group their neighbours, shared MLP, max.

    ``sampling``: ``"random"`` (draws from the generator passed to
    ``forward``; without one it takes the first points, as the JAX module does
    without a ``sampling`` rng), ``"fps"`` (farthest points, starting at a
    point drawn from the generator, or at index 0 without one) or
    ``"first"``. ``grouping``: ``"knn"`` or ``"ball"`` (the points within
    ``radius``). ``in_channels`` is the grouped width, 3 plus the input
    features'. ``group_all`` pools the whole cloud with uncentered
    coordinates. ``dtype`` is the shared MLP's compute type.
    """

    def __init__(self, npoint: Optional[int], nsample: Optional[int], in_channels: int,
                 mlp_channels: Sequence[int], group_all: bool = False,
                 sampling: str = "random", grouping: str = "knn", radius: float = 0.2,
                 fused_mlp_train: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if sampling not in ("random", "first", "fps"):
            raise NotImplementedError(
                f"sampling={sampling!r}: only 'random', 'first' and 'fps' are ported")
        if grouping not in ("knn", "ball"):
            raise NotImplementedError(f"grouping={grouping!r}: only 'knn' and 'ball' are ported")
        self.npoint = npoint
        self.nsample = nsample
        self.group_all = group_all
        self.sampling = sampling
        self.grouping = grouping
        self.radius = radius
        self.mlp = SharedMLP(in_channels, mlp_channels, fused_mlp_train=fused_mlp_train,
                             dtype=dtype)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.group_all:
            new_xyz, grouped = G.group_all(xyz, points)
            grouped = grouped.transpose(1, 2)  # (B, N, 1, C): N neighbours of one centroid
        else:
            sampling = self.sampling
            if sampling == "random" and generator is None:
                sampling = "first"
            new_xyz, grouped = G.sample_and_group(
                xyz, points, self.npoint, self.nsample, generator=generator,
                sampling=sampling, grouping=self.grouping, radius=self.radius,
                neighbor_major=True)
        return new_xyz, self.mlp(grouped)


class PointNetPPTrunk(nn.Module):
    """Three set abstractions and the FC funnel to a 256-d feature.

    sa1 = SA(128, 32, [64, 64, 128]); sa2 = SA(32, 32, [128, 128, 256]);
    sa3 = SA(group_all, [256, 512, 1024]); fc 1024 -> 512 -> 256, each with
    its norm and ReLU, then dropout ``p_drop`` in train. ``sampling`` and
    ``grouping`` go to sa1 and sa2 (:class:`SetAbstraction`; the ball query
    at its default radius 0.2 in both, as in the JAX trunk). ``fc_norm``:
    ``"batch"`` (the BatchNorm trunk, ``bn1``/``bn2``) or ``"layer"`` (the
    MvM head's LayerNorm trunk, ``ln1``/``ln2``);
    ``drop_each_fc`` adds dropout after fc1 as well (the MvM trunk; the
    BatchNorm trunk drops once, after fc2). ``generator`` feeds the centroid
    sampling and the dropout masks. ``dtype`` (None or ``torch.bfloat16``)
    is the compute type of the set abstractions' MLPs and of the FC funnel;
    the output is f32 either way.
    """

    def __init__(self, sampling: str = "random", p_drop: float = 0.5,
                 fused_mlp_train: bool = False, dtype: Optional[torch.dtype] = None,
                 fc_norm: str = "batch", drop_each_fc: bool = False, grouping: str = "knn"):
        super().__init__()
        if fc_norm not in ("batch", "layer"):
            raise ValueError(f"fc_norm={fc_norm!r}: 'batch' or 'layer'")
        sa = dict(sampling=sampling, grouping=grouping, fused_mlp_train=fused_mlp_train,
                  dtype=dtype)
        self.sa1 = SetAbstraction(128, 32, 3, (64, 64, 128), **sa)
        self.sa2 = SetAbstraction(32, 32, 3 + 128, (128, 128, 256), **sa)
        self.sa3 = SetAbstraction(None, None, 3 + 256, (256, 512, 1024), group_all=True, **sa)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        if fc_norm == "batch":
            self.bn1 = nn.BatchNorm1d(512, eps=BN_EPS)
            self.bn2 = nn.BatchNorm1d(256, eps=BN_EPS)
        else:
            self.ln1 = nn.LayerNorm(512, eps=LN_EPS)
            self.ln2 = nn.LayerNorm(256, eps=LN_EPS)
        self.fc_norm = fc_norm
        self.drop_each_fc = drop_each_fc
        self.p_drop = p_drop
        self.compute_dtype = dtype

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.fc_norm == "layer":
            return flax_layer_norm(x, getattr(self, f"ln{i}"))
        bn = getattr(self, f"bn{i}")
        return flax_batch_norm_train(x, bn) if self.training else batch_norm_eval(x, bn)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        l1_xyz, l1_pts = self.sa1(xyz, None, generator)
        l2_xyz, l2_pts = self.sa2(l1_xyz, l1_pts, generator)
        _, l3_pts = self.sa3(l2_xyz, l2_pts)
        x = l3_pts.reshape(xyz.shape[0], -1)  # (B, 1024)
        x = F.relu(self._norm(1, dense(self.fc1, x, self.compute_dtype)))
        if self.training and self.drop_each_fc:
            x = dropout(x, self.p_drop, generator)
        x = F.relu(self._norm(2, dense(self.fc2, x, self.compute_dtype)))
        if self.training:
            x = dropout(x, self.p_drop, generator)
        return _widen(x)  # the JAX trunk returns float32
