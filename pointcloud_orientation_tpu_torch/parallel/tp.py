"""Tensor parallelism for the point transformer (the Megatron layout).

Counterpart of ``pointcloud_orientation_tpu/parallel/tp.py``. Over the mesh's
``model`` axis each rank holds ``H/n`` of every layer's attention heads
(the query, key and value products column-parallel by head, ``out``
row-parallel) and ``F/n`` of its feed-forward width (``Dense_0``
column-parallel, ``Dense_1`` row-parallel); the embedding, the head and
the LayerNorms are replicated. A layer costs two all-reduces in the
forward (after ``out`` and after ``Dense_1``) and two in the backward (of
the layer input's gradient before each split product): the Megatron ``g``
and ``f`` operations (:func:`.comm.reduce_from_group`,
:func:`.comm.copy_to_group`). With ``attention_impl="flash"`` the flash
kernels run on each rank's ``H/n`` heads. The batch can be data-parallel
on the ``data`` axis of the same mesh. The JAX package lets XLA insert the
collectives from a ``PartitionSpec`` a leaf (:func:`tp_param_specs`, the
same tree here); the port builds each rank's slice of the model.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..models import layers as L
from ..models.layers import dense, flax_layer_norm
from ..models.point_transformer import (PointTransformer, attention_keep_mask,
                                        dot_product_attention)
from ..ops import batch_shard
from ..ops import flash_attention as FA
from .comm import all_gather_cat, all_reduce_grads, copy_to_group, reduce_from_group
from .mesh import batch_sharding, map_tree

_MHA = "MultiHeadDotProductAttention"


def tp_param_specs(params, axis: str = "model"):
    """The Megatron spec tree of a flax :class:`PointTransformer` tree, a
    tuple a leaf as ``tuple(PartitionSpec)``: the attention's
    ``query``/``key``/``value`` kernels ``(E, H, D)`` ``(None, axis)`` and
    biases ``(axis,)``, its ``out`` kernel ``(axis,)`` and bias ``()``; a
    layer's ``Dense_0`` kernel ``(None, axis)`` and bias ``(axis,)``,
    ``Dense_1`` kernel ``(axis,)`` and bias ``()``; the rest ``()``."""

    def spec_for(path, leaf):
        joined = "/".join(path)
        last = path[-1]
        if _MHA in joined:
            proj = path[-2] if len(path) >= 2 else ""
            if proj in ("query", "key", "value"):
                return (None, axis) if last == "kernel" else (axis,)
            if proj == "out":
                return (axis,) if last == "kernel" else ()
        if "TransformerEncoderLayer" in joined and "Dense_0" in path:
            return (None, axis) if last == "kernel" else (axis,)
        if "TransformerEncoderLayer" in joined and "Dense_1" in path:
            return (axis,) if last == "kernel" else ()
        return ()

    return map_tree(spec_for, params)


def _row_product(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """A row-parallel product without its bias (added after the
    all-reduce), rounded as :func:`..models.layers.dense` rounds."""
    if dtype != torch.bfloat16:
        return lin(x)
    return torch.matmul(x.bfloat16(), lin.weight.t().bfloat16())


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> nn.Linear:
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


class TPAttention(nn.Module):
    """A rank's heads of a :class:`..models.point_transformer.MultiHeadAttention`."""

    def __init__(self, attn, rank: int, n: int, group):
        super().__init__()
        E, H = attn.query.in_features, attn.num_heads
        if H % n:
            raise ValueError(f"{H} heads do not split over a model axis of {n}")
        rows = slice(rank * E // n, (rank + 1) * E // n)  # H/n heads of D each
        for name in ("query", "key", "value"):
            lin = getattr(attn, name)
            setattr(self, name, _linear(lin.weight[rows], lin.bias[rows]))
        self.out = _linear(attn.out.weight[:, rows], None)
        self.out_bias = nn.Parameter(attn.out.bias.detach().clone())
        self.num_heads, self.group = H // n, group
        self.dropout, self.compute_dtype = attn.dropout, attn.compute_dtype
        self.attention_impl = attn.attention_impl

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        B, N, _ = x.shape
        x = copy_to_group(x, self.group)
        q, k, v = (dense(lin, x, self.compute_dtype).reshape(B, N, self.num_heads, -1)
                   for lin in (self.query, self.key, self.value))
        if self.attention_impl == "flash":
            o = FA.flash_attention_fn(q, k, v, self.compute_dtype, self.dropout,
                                      deterministic=not self.training)
        else:
            keep = None
            if self.training and self.dropout > 0.0:  # (N, N), shared by every head and rank
                keep = attention_keep_mask(N, self.dropout, generator, x.device)
            o = dot_product_attention(q, k, v, keep, self.dropout)
        y = _row_product(self.out, o.reshape(B, N, -1), self.compute_dtype)
        return reduce_from_group(y, self.group) + self.out_bias.to(y.dtype)


class TPEncoderLayer(nn.Module):
    """A rank's slice of a post-norm encoder layer: its heads, its
    ``F/n`` feed-forward columns; LayerNorms replicated."""

    def __init__(self, layer, rank: int, n: int, group):
        super().__init__()
        F = layer.ffn1.out_features
        if F % n:
            raise ValueError(f"ffn_dim={F} does not split over a model axis of {n}")
        cols = slice(rank * F // n, (rank + 1) * F // n)
        self.attn = TPAttention(layer.attn, rank, n, group)
        self.ln1, self.ln2 = copy.deepcopy(layer.ln1), copy.deepcopy(layer.ln2)
        self.ffn1 = _linear(layer.ffn1.weight[cols], layer.ffn1.bias[cols])
        self.ffn2 = _linear(layer.ffn2.weight[:, cols], None)
        self.ffn2_bias = nn.Parameter(layer.ffn2.bias.detach().clone())
        self.cols, self.ffn_dim, self.group = cols, F, group
        self.dropout, self.compute_dtype = layer.dropout, layer.compute_dtype

    def _drop(self, x, generator):
        return L.dropout(x, self.dropout, generator) if self.training else x

    def _drop_hidden(self, h, generator):
        """Dropout of the rank's hidden columns: the mask of the whole
        width drawn (as on one device) and cut to the columns."""
        if not self.training or self.dropout == 0.0:
            return h
        keep_prob = 1.0 - self.dropout
        keep = batch_shard.draw(lambda shape: torch.rand(shape, generator=generator,
                                                         device=h.device),
                                h.shape[0], h.shape[1], self.ffn_dim)[..., self.cols]
        return torch.where(keep < keep_prob, h / keep_prob, torch.zeros_like(h))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = flax_layer_norm(x + self._drop(self.attn(x, generator), generator), self.ln1)
        h = torch.relu(dense(self.ffn1, copy_to_group(x, self.group), self.compute_dtype))
        y = _row_product(self.ffn2, self._drop_hidden(h, generator), self.compute_dtype)
        y = reduce_from_group(y, self.group) + self.ffn2_bias.to(y.dtype)
        return flax_layer_norm(x + self._drop(y, generator), self.ln2)


class TPPointTransformer(nn.Module):
    """A rank's slice of a :class:`PointTransformer` over ``axis`` of the
    mesh: the same forward, its layers tensor-parallel."""

    def __init__(self, model: PointTransformer, mesh, axis: str = "model"):
        super().__init__()
        group, rank, n = mesh.get_group(axis), mesh.get_local_rank(axis), mesh[axis].size()
        self.embed, self.head = copy.deepcopy(model.embed), copy.deepcopy(model.head)
        self.layers = nn.ModuleList(TPEncoderLayer(layer, rank, n, group)
                                    for layer in model.layers)
        self.compute_dtype, self.group, self.axis_size = model.compute_dtype, group, n

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        h = dense(self.embed, x, self.compute_dtype)
        for layer in self.layers:
            h = layer(h, generator)
        return self.head(h.float().mean(dim=1))

    def unshard(self, model: PointTransformer) -> PointTransformer:
        """``model`` (of the same shape) with this slice's weights gathered
        into it (every rank of the axis calls it)."""
        g = self.group
        with torch.no_grad():
            model.embed.load_state_dict(self.embed.state_dict())
            model.head.load_state_dict(self.head.state_dict())
            for full, tp in zip(model.layers, self.layers):
                for name in ("query", "key", "value"):
                    part = getattr(tp.attn, name)
                    getattr(full.attn, name).weight.copy_(all_gather_cat(part.weight, g, 0))
                    getattr(full.attn, name).bias.copy_(all_gather_cat(part.bias, g, 0))
                full.attn.out.weight.copy_(all_gather_cat(tp.attn.out.weight, g, 1))
                full.attn.out.bias.copy_(tp.attn.out_bias)
                full.ffn1.weight.copy_(all_gather_cat(tp.ffn1.weight, g, 0))
                full.ffn1.bias.copy_(all_gather_cat(tp.ffn1.bias, g, 0))
                full.ffn2.weight.copy_(all_gather_cat(tp.ffn2.weight, g, 1))
                full.ffn2.bias.copy_(tp.ffn2_bias)
                full.ln1.load_state_dict(tp.ln1.state_dict())
                full.ln2.load_state_dict(tp.ln2.state_dict())
        return model


def shard_tp_params(model: PointTransformer, mesh, axis: str = "model") -> TPPointTransformer:
    """``model``'s slice for this rank under the Megatron layout (every
    rank holds the same ``model``)."""
    return TPPointTransformer(model, mesh, axis)


def make_tp_train_step(mesh, data_axis: str = "data", train: bool = False):
    """``step(params, opt, x, target, generator=None) -> (params, opt,
    loss)``, in place: ``params`` from :func:`shard_tp_params`, ``opt`` an
    optimizer over ``params.parameters()`` (the JAX step's ``tx``),
    ``x``/``target`` the rank's rows of the
    batch when the mesh has ``data_axis`` (else the whole batch). The loss
    is the mean squared error over the global batch; each model-parallel
    gradient is complete on its rank, and the gradients are summed over
    ``data_axis``. ``train=True`` runs dropout and needs ``generator``
    (the JAX ``ValueError``)."""
    data = batch_sharding(mesh, data_axis) if data_axis in mesh.mesh_dim_names else None
    world = 1 if data is None else data.world

    def step(params: TPPointTransformer, opt, x, target,
             generator: Optional[torch.Generator] = None):
        if train and generator is None:
            raise ValueError("make_tp_train_step(train=True) requires step(..., generator=...) "
                             "for the dropout masks")
        params.train(train)
        with batch_shard.batch_shard(data):
            out = params(x, generator)
        local = ((out - target) ** 2).sum() / (out.numel() * world)
        opt.zero_grad(set_to_none=True)
        local.backward()
        loss = local.detach().clone()
        if data is not None:
            all_reduce_grads(params.parameters(), data.group)
            torch.distributed.all_reduce(loss, group=data.group)
        opt.step()
        return params, opt, loss

    return step
