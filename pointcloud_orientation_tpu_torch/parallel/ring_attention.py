"""Ring attention: exact attention over a point axis sharded over ranks.

Counterpart of ``pointcloud_orientation_tpu/parallel/ring_attention.py``.
Each rank keeps its query block and streams the key/value blocks around the
ring of its group (``batch_isend_irecv`` to the next rank, from the
previous), merging each block's scores into running log-sum-exp
accumulators, so that no rank ever holds the whole K/V or score matrix:
O(N/n) memory a rank. The merge order is the JAX one: the own block first,
then the received blocks in ring order. ``compute_dtype`` (e.g.
``torch.bfloat16``) rounds the block products' inputs to that type and
multiplies and accumulates in f32, as ``preferred_element_type=float32``;
the softmax bookkeeping stays f32.

``torch.distributed.nn`` has no differentiable point-to-point operation,
so the backward is written out (:class:`_RingAttention`): each rank keeps
its queries, output, output gradient and log-sum-exp, and the K/V blocks
travel the ring again together with their dK/dV accumulators; every rank
adds its queries' contributions to the block it holds, and after the last
block one more hop brings each dK/dV home. Still O(N/n) a rank.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _ring_pass(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group``'s ring and receive
    the previous rank's in its place."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _cast(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` and widened back to f32 (the
    products then multiply exactly and accumulate in f32)."""
    return t if compute_dtype is None else t.to(compute_dtype).float()


def _scores(q, k, scale, compute_dtype):
    return torch.matmul(_cast(q, compute_dtype), _cast(k, compute_dtype).transpose(-1, -2)) * scale


def _attend_block(q, k, v, scale, compute_dtype):
    """``(block max, exp-scores @ v, exp sums)`` of one K/V block."""
    s = _scores(q, k, scale, compute_dtype)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.matmul(_cast(p, compute_dtype), _cast(v, compute_dtype))
    return m, o, p.sum(-1, keepdim=True)


def _merge(acc, blk):
    m_acc, o_acc, l_acc = acc
    m_blk, o_blk, l_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    alpha, beta = torch.exp(m_acc - m_new), torch.exp(m_blk - m_new)
    return m_new, o_acc * alpha + o_blk * beta, l_acc * alpha + l_blk * beta


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, compute_dtype):
        n = dist.get_world_size(group)
        acc = _attend_block(q, k, v, scale, compute_dtype)
        kv = [k, v]
        for _ in range(n - 1):
            kv = _ring_pass(kv, group)
            acc = _merge(acc, _attend_block(q, kv[0], kv[1], scale, compute_dtype))
        m, o, l = acc
        out = o / l
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.scale, ctx.compute_dtype = group, scale, compute_dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale, cd = ctx.group, ctx.scale, ctx.compute_dtype
        n = dist.get_world_size(group)
        dout = dout.contiguous()
        delta = (dout * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(q)
        blk = [k, v, torch.zeros_like(k), torch.zeros_like(v)]
        for i in range(n):
            kb, vb, dk, dv = blk
            p = torch.exp(_scores(q, kb, scale, cd) - lse)
            dv = dv + torch.matmul(p.transpose(-1, -2), dout)
            ds = p * (torch.matmul(dout, _cast(vb, cd).transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, _cast(kb, cd)) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), _cast(q, cd)) * scale
            blk = [kb, vb, dk, dv]
            if i < n - 1:
                blk = _ring_pass(blk, group)
        dk, dv = blk[2:] if n == 1 else _ring_pass(blk[2:], group)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   scale: Optional[float] = None, compute_dtype=None) -> torch.Tensor:
    """Exact softmax attention of the local shards ``q (..., Sq, D)``,
    ``k``/``v (..., Sk, D)`` of a sequence sharded over ``group``'s ranks
    in rank order (logical length ``n * S``); every rank of the group
    calls it. ``group=None``: the whole world. Differentiable (the
    backward streams the blocks around the ring again)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = group if group is not None else dist.group.WORLD
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _RingAttention.apply(q, k, v, group, float(scale), compute_dtype)


def make_ring_attention(mesh, axis_name: str = "model", compute_dtype=None):
    """``fn(q, k, v) -> out`` over ``(B, H, N, D)`` local shards whose N
    axis is sharded over ``axis_name`` of ``mesh`` (a batch sharded over
    another axis needs no communication here)."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, compute_dtype=compute_dtype)

    return fn


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention of whole sequences, the single-device path."""
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v)
