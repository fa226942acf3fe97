"""Pipeline parallelism for the point transformer (GPipe).

Counterpart of ``pointcloud_orientation_tpu/parallel/pp.py``. Each rank of
the mesh's ``stage`` axis holds ``depth/S`` consecutive encoder layers;
the batch is cut into ``M`` microbatches that stream through the stages
over ``M + S - 1`` ticks, stage ``s`` running microbatch ``t - s`` at tick
``t`` and sending its activation to stage ``s + 1``: the usual ``(S -
1)/(M + S - 1)`` bubble. The embedding runs on the first stage and the
f32 mean pool and head on the last, so their gradients are counted once
and then summed over the stages.

The backward pipeline is autograd's own: sending an activation is an
``autograd.Function`` whose backward receives its cotangent from the next
stage (:class:`_Send`), receiving one is a function whose backward sends
the cotangent back (:class:`_Recv`). Each stage's loss adds the (zero)
tokens of its sends, so its backward reaches them; the engine runs a
stage's graph in the reverse order of its creation, so every stage
answers the microbatches from the last to the first, and the messages are
tagged by microbatch. Stages are deterministic (no dropout), as in the
JAX package. With a ``data`` axis (a ``(data, stage)`` mesh) each data
shard runs its own pipeline and the gradients are summed over ``data``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import dense
from .comm import all_reduce_grads
from .mesh import batch_sharding, map_tree

_LAYER = "TransformerEncoderLayer_"


def split_pipeline_params(params: Dict, depth: int) -> Tuple[Dict, Dict]:
    """A flax :class:`PointTransformer` tree split for pipelining:
    ``(stacked, rest)``, the ``depth`` layers' trees stacked on a new
    leading axis and the embedding and head."""
    layers = [params[f"{_LAYER}{i}"] for i in range(depth)]
    stacked = map_tree(lambda path, *leaves: np.stack([np.asarray(x) for x in leaves]), *layers)
    rest = {k: v for k, v in params.items() if not k.startswith(_LAYER)}
    return stacked, rest


def _index(tree: Dict, i: int) -> Dict:
    return map_tree(lambda path, leaf: np.asarray(leaf)[i], tree)


class PipelineStage(nn.Module):
    """A rank's stage: its slice of the layers, with the embedding and the
    head (used on the first and last stage)."""

    def __init__(self, stacked: Dict, rest: Dict, mesh, axis_name: str = "stage",
                 attention_impl: str = "xla", dtype=None):
        from ..utils.jax_weights import load_flax_variables, transformer_kwargs

        super().__init__()
        self.group = mesh.get_group(axis_name)
        self.stage, self.stages = mesh.get_local_rank(axis_name), mesh[axis_name].size()
        depth = int(np.shape(stacked["Dense_0"]["kernel"])[0])
        if depth % self.stages:
            raise ValueError(f"depth {depth} does not split over {self.stages} stages")
        per = depth // self.stages
        first = self.stage * per
        tree = {**rest, **{f"{_LAYER}{i}": _index(stacked, first + i) for i in range(per)}}
        kw = transformer_kwargs(tree)
        from ..models.point_transformer import PointTransformer

        model = load_flax_variables(PointTransformer(**kw, dropout=0.0, dtype=dtype,
                                                     attention_impl=attention_impl),
                                    {"params": tree})
        self.embed, self.head, self.layers = model.embed, model.head, model.layers
        self.compute_dtype = model.compute_dtype
        self.eval()  # deterministic stages

    def run_layers(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h)
        return h


def place_pipeline_state(stacked: Dict, rest: Dict, mesh, axis_name: str = "stage",
                         attention_impl: str = "xla", dtype=None) -> PipelineStage:
    """This rank's :class:`PipelineStage` of the split trees (every rank
    holds the same ``stacked``/``rest``)."""
    return PipelineStage(stacked, rest, mesh, axis_name, attention_impl, dtype)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dst, tag, group):
        dist.send(y.contiguous(), dst, group=group, tag=tag)
        ctx.meta = (dst, tag, group, y.shape, y.dtype)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        dst, tag, group, shape, dtype = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=_.device)
        dist.recv(g, dst, group=group, tag=tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, src, tag, group, shape, dtype):
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(h, src, group=group, tag=tag)
        ctx.meta = (src, tag, group)
        return h

    @staticmethod
    def backward(ctx, g):
        src, tag, group = ctx.meta
        dist.send(g.contiguous(), src, group=group, tag=tag)
        return torch.zeros((), device=g.device), None, None, None, None, None


def _pipeline(stage: PipelineStage, x: torch.Tensor, microbatches: int):
    """Stream ``x``'s microbatches through the stages. Returns ``(out,
    token)``: the last stage's ``(B, 3)`` output (None elsewhere) and the
    sum of the stage's send tokens (zero)."""
    B, N = x.shape[0], x.shape[1]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    mb, S, s, g = B // microbatches, stage.stages, stage.stage, stage.group
    width = stage.embed.out_features
    dtype = stage.compute_dtype or torch.float32
    anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    prev = None if s == 0 else dist.get_global_rank(g, s - 1)
    nxt = None if s == S - 1 else dist.get_global_rank(g, s + 1)
    outs, token = [], x.new_zeros(())
    for t in range(microbatches + S - 1):
        m = t - s
        if not 0 <= m < microbatches:
            continue
        if s == 0:
            h = dense(stage.embed, x[m * mb:(m + 1) * mb], stage.compute_dtype)
        else:
            h = _Recv.apply(anchor, prev, m, g, (mb, N, width), dtype)
        h = stage.run_layers(h)
        if nxt is not None:
            token = token + _Send.apply(h, nxt, m, g)
        else:
            outs.append(h)
    if nxt is not None:
        return None, token
    pooled = torch.cat(outs).float().mean(dim=1)
    return pooled @ stage.head.weight.t() + stage.head.bias, token


def make_pp_apply(microbatches: int):
    """``apply(stage, x) -> (B, 3)``, the pipelined forward on every rank
    of the axis (the last stage's output broadcast): ``stage`` from
    :func:`place_pipeline_state` (which fixes the attention backend and
    compute type), ``x (B, N, 3)`` the same on every stage; ``B`` must
    split into ``microbatches``."""

    def apply(stage: PipelineStage, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out, _ = _pipeline(stage, x, microbatches)
            if out is None:
                out = torch.zeros((x.shape[0], 3), device=x.device)
            dist.broadcast(out, dist.get_global_rank(stage.group, stage.stages - 1),
                           group=stage.group)
        return out

    return apply


def make_pp_train_step(mesh, microbatches: int, data_axis: str = None):
    """``step(stage, opt, x, target) -> (stage, opt, loss)``, in place:
    ``opt`` an optimizer over ``stage.parameters()`` (the JAX step's
    ``tx``); ``x``/``target`` the same on every
    stage (the rank's rows when ``data_axis`` is set). The loss is the mean
    squared error over the (global) batch, computed on the last stage;
    the layers' gradients are complete on their stage, the embedding's and
    head's summed over the stages (each counted on one), and everything
    summed over ``data_axis``. Returns the global loss on every rank."""
    data = None if data_axis is None else batch_sharding(mesh, data_axis)
    world = 1 if data is None else data.world

    def step(stage: PipelineStage, opt, x, target):
        out, token = _pipeline(stage, x, microbatches)
        local = token
        if out is not None:
            local = local + ((out - target) ** 2).sum() / (out.numel() * world)
        opt.zero_grad(set_to_none=True)
        local.backward()
        rest = [*stage.embed.parameters(), *stage.head.parameters()]
        for p in rest:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_grads(rest, stage.group)
        if data is not None:
            all_reduce_grads(stage.parameters(), data.group)
        opt.step()
        loss = local.detach().clone()
        dist.all_reduce(loss, group=stage.group)
        if data is not None:
            dist.all_reduce(loss, group=data.group)
        return stage, opt, loss

    return step
