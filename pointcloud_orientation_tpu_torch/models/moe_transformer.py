"""MoE point transformer: the point transformer with routed expert FFNs.

Counterpart of ``pointcloud_orientation_tpu/models/moe_transformer.py``:
``Dense(in_dim -> embed_dim)``, ``depth`` post-norm encoder layers whose
feed-forward is the top-1 routed :class:`..parallel.ep.MoEFeedForward`,
a mean pool in f32 and ``Dense(embed_dim -> 3)``. The model returns
``(out, aux)``, ``aux`` the mean of the layers' load-balance losses (each
widened to f32 before the sum, as there); the task ``forward_mse_aux``
adds ``moe_aux_weight * aux`` to every sample's loss.

The attention is flax's plain ``MultiHeadDotProductAttention`` (the port's
:class:`.point_transformer.MultiHeadAttention` with ``attention_impl="xla"``;
the JAX model never takes the flash backend), with its attention-probability
dropout; dropout also follows the attention and the MoE FFN. Under
``dtype="bfloat16"`` the attention's Dense layers and both LayerNorms
compute as flax's with ``dtype=jnp.bfloat16``; the MoE FFN takes no compute
type and promotes its bf16 input to f32, so the residual ``x + h`` is f32
and the second LayerNorm rounds its output to bf16.

The pool widens to f32 as ``h.astype(jnp.float32)`` does and the head then
computes in the parameters' type, so that a model cast to float64 (a test's
or the card check's reference) computes as the JAX model does under
``jax.enable_x64``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.ep import MoEFeedForward
from . import layers as L
from .layers import LN_EPS, compute_dtype, dense, flax_layer_norm
from .point_transformer import MultiHeadAttention


class MoETransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with a routed-MoE FFN: ``x = LN1(x +
    drop(MHA(x)))``, ``h, aux = MoE(x)``, ``x = LN2(x + drop(h))``; returns
    ``(x, aux)``."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, n_experts: int = 4,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 dispatch: str = "masked", capacity_factor: float = 1.25):
        super().__init__()
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout, dtype, "xla")
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.moe = MoEFeedForward(embed_dim, ffn_dim, n_experts, dispatch, capacity_factor)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.dropout = dropout
        self.compute_dtype = dtype

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return L.dropout(x, self.dropout, generator) if self.training else x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = flax_layer_norm(x + self._drop(self.attn(x, generator), generator), self.ln1)
        h, aux = self.moe(x)
        x = flax_layer_norm(x + self._drop(h, generator), self.ln2)
        return (x if self.compute_dtype is None else x.to(self.compute_dtype)), aux


class MoEPointTransformer(nn.Module):
    """Embed points, run ``depth`` MoE encoder layers, mean-pool, regress a
    3-vector: ``(B, N, in_dim)`` -> ``(out (B, 3), aux ())``. ``generator``
    feeds the dropout masks in train mode. ``dispatch`` is ``"masked"`` or
    ``"capacity"`` (:mod:`..parallel.ep`)."""

    def __init__(self, in_dim: int = 3, embed_dim: int = 64, num_heads: int = 4, depth: int = 6,
                 ffn_dim: int = 2048, n_experts: int = 4, dropout: float = 0.1, dtype=None,
                 dispatch: str = "masked", capacity_factor: float = 1.25):
        super().__init__()
        dtype = compute_dtype(dtype)
        self.in_channels = in_dim
        self.embed = nn.Linear(in_dim, embed_dim)
        self.layers = nn.ModuleList(
            MoETransformerEncoderLayer(embed_dim, num_heads, ffn_dim, n_experts, dropout, dtype,
                                       dispatch, capacity_factor)
            for _ in range(depth))
        self.head = nn.Linear(embed_dim, 3)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = dense(self.embed, x, self.compute_dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            h, aux = layer(h, generator)
            aux_total = aux_total + aux.float()
        pooled = h.float().mean(dim=1).to(self.head.weight.dtype)
        return self.head(pooled), aux_total / len(self.layers)


def moe_ep_param_specs(params, axis: str = "expert"):
    """The spec tree of a flax :class:`MoEPointTransformer` tree, a tuple a
    leaf as ``tuple(PartitionSpec)``: the experts' stacked leaves
    (``wi``/``bi``/``wo``/``bo`` inside any ``MoEFeedForward_*``) split on
    their leading axis, ``(axis,)``; the rest ``()``."""
    from ..parallel.mesh import map_tree

    def spec_for(path, leaf):
        if path and path[-1] in ("wi", "bi", "wo", "bo") and any(
                "MoEFeedForward" in k for k in path):
            return (axis,)
        return ()

    return map_tree(spec_for, params)


def shard_moe_params(params, mesh, axis: str = "expert"):
    """The flax tree with every leaf split by :func:`moe_ep_param_specs` cut
    to this rank's block of ``axis`` (numpy; the rest whole)."""
    import numpy as np

    from ..parallel.mesh import map_tree

    rank, n = mesh.get_local_rank(axis), mesh[axis].size()

    def cut(path, leaf, spec):
        leaf = np.asarray(leaf)
        if not spec:
            return leaf
        k = leaf.shape[0] // n
        return leaf[rank * k:(rank + 1) * k]

    return map_tree(cut, params, moe_ep_param_specs(params, axis))
