"""The sequence-parallel point transformer: the point axis sharded over a
group of ranks, attention mixing across it by ring attention.

Counterpart of ``pointcloud_orientation_tpu/parallel/sp_transformer.py``.
Parameters are replicated; a rank holds ``(B/n_data, N/n_model, C)`` of the
activations; the only cross-shard mixing is the attention
(:func:`.ring_attention.ring_attention`) and the pooled mean over the
points, an all-reduce over the model axis. Off a mesh (``group=None``) the
module is the plain single-device transformer, as the JAX module is
outside ``shard_map``, with one parameter tree for both.

The layer is the JAX package's, not the flagship's: the query, key and
value come from one Dense to ``(3, H, D)`` (flax ``DenseGeneral``, kernel
``(E, 3, H, D)``, bias ``(3, H, D)``), the encoder layer is post-norm with
a ``ffn_dim`` of 256, and the head reads the pooled mean. Its flax tree is
carried both ways by ``utils/jax_weights.py`` (``ring_point_transformer``).
No ``Trainer`` trains it (its forward has no train mode, as the JAX
module's ``__call__`` takes no ``train``): :func:`make_sp_train_step` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.layers import LN_EPS, flax_layer_norm
from .comm import all_reduce_grads, sum_over_group
from .ring_attention import full_attention, ring_attention


class RingSelfAttention(nn.Module):
    """Multi-head self-attention whose mixing runs over ``group`` by ring
    attention, or over the whole local sequence without one."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)  # flax (E, 3, H, D) flattened
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        B, S, E = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, S, 3, H, E // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, S, D)
        out = full_attention(q, k, v) if group is None else ring_attention(q, k, v, group)
        return self.out(out.transpose(1, 2).reshape(B, S, E))


class RingTransformerLayer(nn.Module):
    """Post-norm encoder layer over ring self-attention (LayerNorm is local
    to each point, so it needs no communication)."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int = 256):
        super().__init__()
        self.attn = RingSelfAttention(embed_dim, num_heads)
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(embed_dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, embed_dim)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        x = flax_layer_norm(x + self.attn(x, group), self.ln1)
        h = self.ffn2(torch.relu(self.ffn1(x)))
        return flax_layer_norm(x + h, self.ln2)


class RingPointTransformer(nn.Module):
    """Embed, ring layers, the mean over the (sharded) point axis, a
    3-vector head: ``(B, N_local, in_dim) -> (B, 3)``. With ``group`` the
    pooled mean is all-reduced over it (:func:`.comm.sum_over_group`, whose
    backward all-reduces too); ``generator`` is unused (no dropout), taken
    as every model of the registry takes it."""

    def __init__(self, in_dim: int = 3, embed_dim: int = 64, num_heads: int = 4, depth: int = 2,
                 ffn_dim: int = 256):
        super().__init__()
        self.in_channels = in_dim
        self.embed = nn.Linear(in_dim, embed_dim)
        self.layers = nn.ModuleList(RingTransformerLayer(embed_dim, num_heads, ffn_dim)
                                    for _ in range(depth))
        self.head = nn.Linear(embed_dim, 3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                group=None) -> torch.Tensor:
        h = self.embed(x)
        for layer in self.layers:
            h = layer(h, group)
        pooled = h.mean(dim=1)
        if group is not None:
            pooled = sum_over_group(pooled, group) / torch.distributed.get_world_size(group)
        return self.head(pooled)


def make_sp_train_step(mesh, data_axis: str = "data", model_axis: str = "model"):
    """``step(model, opt, x, target) -> (model, opt, loss)``, in place, for
    a :class:`RingPointTransformer`: ``x (B/n_data, N/n_model, 3)`` the
    rank's shard (``(data, model)`` on ``(B, N)``), ``target (B/n_data,
    3)`` its rows, the weights replicated and ``opt`` an optimizer over
    ``model.parameters()`` (the JAX step's ``tx``). The loss is the mean over the
    global batch; every rank's share of it (its data shard's mean over
    ``n_data * n_model``) backpropagates through the ring and the pooled
    all-reduce, and the gradients are summed over both axes, so every
    rank takes the same update. Returns the global loss."""
    data_group, model_group = mesh.get_group(data_axis), mesh.get_group(model_axis)
    n_data, n_model = mesh[data_axis].size(), mesh[model_axis].size()

    def step(params: RingPointTransformer, opt, x, target):
        out = params(x, group=model_group)
        local = torch.mean((out - target) ** 2)
        opt.zero_grad(set_to_none=True)
        (local / (n_data * n_model)).backward()
        all_reduce_grads(params.parameters(), data_group)
        all_reduce_grads(params.parameters(), model_group)
        opt.step()
        loss = local.detach() / n_data
        torch.distributed.all_reduce(loss, group=data_group)
        return params, opt, loss

    return step
