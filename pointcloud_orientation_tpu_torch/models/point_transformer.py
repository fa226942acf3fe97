"""Point transformer: full self-attention over the point set.

Counterpart of ``pointcloud_orientation_tpu/models/point_transformer.py``:
``Dense(in_dim -> embed_dim)``, ``depth`` post-norm encoder layers (flax's
``MultiHeadDotProductAttention``, ReLU feed-forward of ``ffn_dim``, dropout
0.1), a mean pool in f32 and ``Dense(embed_dim -> 3)`` in f32.

``attention_impl``: ``"xla"`` is flax's plain attention (the query scaled
by ``1 / sqrt(D)`` before the product, the softmax in the compute type,
attention-probability dropout with one ``(N, N)`` mask broadcast over batch
and heads), in ``torch.matmul`` as the JAX package leaves it to XLA;
``"flash"`` runs the flash kernels (:mod:`..ops.flash_attention`, the JAX
package's Pallas path) and applies no attention-probability dropout, with
the JAX package's warning; residual and feed-forward dropout apply either
way. ``dtype=torch.bfloat16`` is flax's ``dtype=jnp.bfloat16``: every Dense
as :func:`.layers.dense`, LayerNorm statistics in f32 from the widened
input (:func:`.layers.flax_layer_norm`); parameters stay f32. ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, flax's
``nn.remat``) with the same parameters; the layer's dropout masks are
drawn again from the generator state the forward started from.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as FA
from . import layers as L
from .layers import LN_EPS, compute_dtype, dense, flax_layer_norm

ATTENTION_IMPLS = ("xla", "flash")


def attention_keep_mask(n: int, p: float, generator: Optional[torch.Generator],
                        device: torch.device) -> torch.Tensor:
    """The keep mask ``(n, n)`` of attention-probability dropout, shared by
    every batch entry and head (flax's ``broadcast_dropout=True``): each
    entry kept with probability ``1 - p``, drawn from ``generator``."""
    if generator is None:
        raise ValueError("attention dropout in train mode needs a torch.Generator")
    return torch.rand((n, n), generator=generator, device=device) < 1.0 - p


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          keep: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """flax's ``dot_product_attention`` over ``(B, N, H, D)``, in the inputs'
    type: ``q / sqrt(D)``, then ``q k^T``, the softmax as ``jax.nn.softmax``
    computes it, the dropout ``keep / (1 - p)`` where ``keep`` is given,
    then the product with ``v``."""
    dt = q.dtype
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=dt)
    s = torch.matmul(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if keep is not None:
        w = w * (keep.to(dt) / torch.tensor(1.0 - p, dtype=dt))
    return torch.matmul(w, v).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=E,
    out_features=E)`` as self-attention: ``query``, ``key`` and ``value``
    Dense layers ``E -> (H, D)`` (flax kernels ``(E, H, D)``, biases ``(H,
    D)``), the attention, and ``out`` ``(H, D) -> E``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 dtype: Optional[torch.dtype], attention_impl: str):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim={embed_dim} is not a multiple of num_heads={num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)
        self.dropout = dropout
        self.compute_dtype = dtype
        self.attention_impl = attention_impl

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        B, N, E = x.shape
        q, k, v = (dense(lin, x, self.compute_dtype).reshape(B, N, self.num_heads, -1)
                   for lin in (self.query, self.key, self.value))
        if self.attention_impl == "flash":
            o = FA.flash_attention_fn(q, k, v, self.compute_dtype, self.dropout,
                                      deterministic=not self.training)
        else:
            keep = None
            if self.training and self.dropout > 0.0:
                keep = attention_keep_mask(N, self.dropout, generator, x.device)
            o = dot_product_attention(q, k, v, keep, self.dropout)
        return dense(self.out, o.reshape(B, N, E), self.compute_dtype)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``x = LN1(x + drop(MHA(x)))``, then ``x =
    LN2(x + drop(W2 drop(relu(W1 x))))``."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int = 2048, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, attention_impl: str = "xla"):
        super().__init__()
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout, dtype, attention_impl)
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(embed_dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, embed_dim)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.dropout = dropout
        self.compute_dtype = dtype

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return L.dropout(x, self.dropout, generator) if self.training else x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = flax_layer_norm(x + self._drop(self.attn(x, generator), generator), self.ln1)
        h = torch.relu(dense(self.ffn1, x, self.compute_dtype))
        h = dense(self.ffn2, self._drop(h, generator), self.compute_dtype)
        return flax_layer_norm(x + self._drop(h, generator), self.ln2)


class PointTransformer(nn.Module):
    """Embed points, run ``depth`` encoder layers, mean-pool in f32, regress
    a 3-vector (``(B, N, in_dim)`` -> ``(B, 3)``). ``generator`` feeds the
    dropout masks in train mode."""

    def __init__(self, in_dim: int = 3, embed_dim: int = 64, num_heads: int = 4, depth: int = 6,
                 ffn_dim: int = 2048, dropout: float = 0.1, remat: bool = False, dtype=None,
                 attention_impl: str = "xla"):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl={attention_impl!r}: one of {ATTENTION_IMPLS}")
        dtype = compute_dtype(dtype)
        self.in_channels = in_dim
        self.embed = nn.Linear(in_dim, embed_dim)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, ffn_dim, dropout, dtype, attention_impl)
            for _ in range(depth))
        self.head = nn.Linear(embed_dim, 3)
        self.remat = remat
        self.compute_dtype = dtype
        self.attention_impl = attention_impl

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = dense(self.embed, x, self.compute_dtype)
        for layer in self.layers:
            if self.remat and self.training and torch.is_grad_enabled():
                h = checkpoint(_replay, layer, h, generator,
                               None if generator is None else generator.get_state(),
                               use_reentrant=False)
            else:
                h = layer(h, generator)
        return self.head(h.float().mean(dim=1))


def _replay(layer: nn.Module, h: torch.Tensor, generator: Optional[torch.Generator],
            state: Optional[torch.Tensor]) -> torch.Tensor:
    """``layer(h, generator)`` from the generator state ``state``, so that
    the backward's recompute draws the forward's dropout masks."""
    if generator is not None:
        generator.set_state(state)
    return layer(h, generator)
