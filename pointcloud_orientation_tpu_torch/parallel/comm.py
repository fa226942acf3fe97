"""The collectives the port's parallel paths write out, with their
gradients.

Under ``shard_map`` JAX transposes each collective for the backward; the
port says what each one's backward is:

* :func:`copy_to_group` - identity forward, all-reduce backward: a
  replicated input feeding a computation split over the group (the
  column-parallel products, a rank's experts), whose partial input
  gradients sum over the group;
* :func:`reduce_from_group` - all-reduce forward, identity backward: the
  split computation's partial outputs summed into a replicated value that
  every rank goes on computing with (the row-parallel products, the
  experts' combine);
* :func:`sum_over_group` - all-reduce forward and backward: a value each
  rank computes from its own rows and every rank uses, in a loss that is
  the sum of the ranks' (``torch.distributed.nn``'s ``all_reduce``);
* :func:`gather_from_group` - all-gather forward along a dimension,
  reduce-scatter backward: a sharded weight gathered before use (FSDP),
  each rank receiving the sum of the gradients of its own shard;
* :func:`all_reduce_grads` - the gradients of parameters summed over a
  group in one flat buffer.

``gloo`` has no reduce-scatter on every build: there the backward
all-reduces the whole gradient and keeps the rank's part (the same sum).
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, without gradient."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_sum(g: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``g``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        parts = [p.contiguous() for p in torch.chunk(g, n, dim=dim)]
        out = torch.empty_like(parts[r])
        dist.reduce_scatter(out, parts, group=group)
        return out
    g = g.contiguous().clone()
    dist.all_reduce(g, group=group)
    return torch.chunk(g, n, dim=dim)[r].contiguous()


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group, ctx.dim), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum the ``.grad`` of ``params`` over ``group`` in one flat buffer. A
    parameter without a gradient is left so: every rank runs the same
    graph, so it has none on any rank."""
    params: List[torch.nn.Parameter] = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
