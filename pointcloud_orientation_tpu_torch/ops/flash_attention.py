"""Flash attention: the point transformer's ``attention_impl="flash"``.

Counterpart of ``pointcloud_orientation_tpu/models/point_transformer.py``
``_flash_attention_fn`` together with the library function it calls,
``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`` (no
mask, no bias, not causal), whose three Pallas kernels (the forward, dK/dV
and dQ) become the CUDA kernels of ``csrc/flash_attention.cu``, launched
through :mod:`.cuda_kernels` (``flash_attention_fwd``,
``flash_attention_bwd_dkv``, ``flash_attention_bwd_dq``) and wired into
autograd by :class:`FlashAttentionFn`. The public functions take the JAX
layout ``(B, H, N, D)``; :func:`flash_attention_fn` takes flax's ``(B, N,
H, D)`` as ``_flash_attention_fn`` does.

The plain versions here follow the library's order of operations:
``s = (q . k^T in f32) * sm_scale``, the scale applied after the product;
the forward's online softmax over tiles of 128 keys with the accumulator
kept normalised (``_flash_attention_kernel_single_batch``), ``p`` rounded
to ``v``'s type before ``p . v``; the row statistics ``l`` (sum) and ``m``
(max) in f32; the backward's ``p = exp(s - m) * (1 / l)``, ``di = sum(o *
dO)`` in f32, ``ds = (dO . v^T - di) * p * sm_scale``, ``p`` and ``ds``
rounded to the operands' type before their products. bf16 operands enter
every product widened to f32 (exact products, f32 sums), as the library's
``preferred_element_type=float32``. (At N=128 the library takes a one-tile
kernel that divides ``p`` by ``l`` before rounding it; these versions keep
the tiled form there too, a difference within bf16 rounding.)

The library's block sizes are 128: N must be at least 128 and a multiple
of 128, or :func:`check_seq_len` raises the library's ``ValueError``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from . import cuda_kernels as K

BLOCK = 128  # the library's default block sizes (BlockSizes.get_default)
# a plain backward chunk's (B, H, rows, N) score tensors hold at most this many entries
_PLAIN_CHUNK_ENTRIES = 1 << 27

DROPOUT_WARNING = (
    "flash attention backend does not apply attention-probability dropout (rate %.3g "
    "ignored; residual/FFN dropout still apply) — regularization differs from the torch "
    "reference TransformerEncoderLayer")


def check_seq_len(n: int) -> None:
    """The library's ``_verify_block`` on the default 128-row blocks: the
    sequence must hold a whole block and be a multiple of it."""
    if BLOCK > n:
        raise ValueError(f"block_q={BLOCK} should be smaller or equal to q_seq_len={n}")
    if n % BLOCK != 0:
        raise ValueError(f"kv_seq_len={n} should be divisible by block_k_major={BLOCK}")


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q, k, v of one shape ``(B, H, N, D)``, one type and one device, N as
    :func:`check_seq_len` takes it."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; q is "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    check_seq_len(q.shape[2])


def _sum_type(dtype: torch.dtype) -> torch.dtype:
    """The type products are summed in: f32 (the library's), or f64 for f64
    operands (a float64 reference of the same steps)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as ``dtype`` holds it, kept in ``x``'s type."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``o`` (q's type), ``l`` and
    ``m`` ``(B, H, N)`` (f32), tile by tile over 128 keys as
    ``_flash_attention_kernel_single_batch``."""
    check_qkv(q, k, v)
    K.f32_matmuls()
    acc_t = _sum_type(q.dtype)
    qf, kf, vf = (t.to(acc_t) for t in (q, k, v))
    B, H, N, D = q.shape
    m = torch.full((B, H, N), -torch.inf, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, N), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, N, D), dtype=acc_t, device=q.device)
    for t in range(0, N, BLOCK):
        s = torch.matmul(qf, kf[:, :, t:t + BLOCK].transpose(-1, -2)) * sm_scale
        m_next = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1) + l_corr
        inv = torch.where(l_next == 0.0, torch.ones_like(l_next), 1.0 / l_next)
        acc = acc * (l_corr * inv)[..., None]
        acc = acc + torch.matmul(_as(p, v.dtype), vf[:, :, t:t + BLOCK]) * inv[..., None]
        m, l = m_next, l_next
    return acc.to(q.dtype), l, m


def _bwd_plain(q, k, v, l, m, dout, di, sm_scale, dq: bool):
    """dQ (``dq``) or (dK, dV) as the library's backward kernels compute
    them, over chunks of queries."""
    check_qkv(q, k, v)
    K.f32_matmuls()
    acc_t = _sum_type(q.dtype)
    qf, kf, vf, dof = (t.to(acc_t) for t in (q, k, v, dout))
    B, H, N, D = q.shape
    rows = max(BLOCK, _PLAIN_CHUNK_ENTRIES // max(B * H * N, 1) // BLOCK * BLOCK)
    out = [torch.zeros((B, H, N, D), dtype=acc_t, device=q.device) for _ in range(1 if dq else 2)]
    for i in range(0, N, rows):
        r = slice(i, i + rows)
        s = torch.matmul(qf[:, :, r], kf.transpose(-1, -2)) * sm_scale
        p = torch.exp(s - m[:, :, r, None].to(acc_t)) * (1.0 / l[:, :, r].to(acc_t))[..., None]
        dp = torch.matmul(dof[:, :, r], vf.transpose(-1, -2))
        ds = _as((dp - di[:, :, r, None].to(acc_t)) * p * sm_scale, q.dtype)
        if dq:
            out[0][:, :, r] = torch.matmul(ds, kf)
        else:
            out[0] += torch.matmul(ds.transpose(-1, -2), qf[:, :, r])
            out[1] += torch.matmul(_as(p, dout.dtype).transpose(-1, -2), dof[:, :, r])
    return [o.to(q.dtype) for o in out]


def flash_attention_bwd_dkv_plain(q, k, v, l, m, dout, di, sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel (``_flash_attention_dkv_kernel``):
    ``dk = (ds^T q)``, ``dv = (p^T dO)``, in q's type."""
    dk, dv = _bwd_plain(q, k, v, l, m, dout, di, sm_scale, dq=False)
    return dk, dv


def flash_attention_bwd_dq_plain(q, k, v, l, m, dout, di, sm_scale: float) -> torch.Tensor:
    """Plain version of the dQ kernel (``_flash_attention_dq_kernel``):
    ``dq = ds k``, in q's type."""
    return _bwd_plain(q, k, v, l, m, dout, di, sm_scale, dq=True)[0]


def row_di(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``di = sum(o * dO)`` over the head dimension in f32 (f64 for f64),
    as the library's ``_flash_attention_bwd`` computes it outside its
    kernels."""
    acc_t = _sum_type(o.dtype)
    return (o.to(acc_t) * dout.to(acc_t)).sum(dim=-1)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention differentiable in q, k and v: the forward kernel,
    then in the backward the dK/dV kernel and the dQ kernel, as the
    library's ``custom_vjp``. On CPU tensors each wrapper runs its plain
    version. Call as ``FlashAttentionFn.apply(q, k, v, sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, l, m = K.flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, l, m = ctx.saved_tensors
        dout = dout.contiguous()
        di = row_di(o, dout)
        dk, dv = K.flash_attention_bwd_dkv(q, k, v, l, m, dout, di, ctx.sm_scale)
        dq = K.flash_attention_bwd_dq(q, k, v, l, m, dout, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """``softmax(sm_scale * q k^T) v`` over ``(B, H, N, D)`` (the library's
    ``flash_attention(q, k, v, sm_scale=...)`` without mask, bias or
    causality), through the kernels on the card."""
    check_qkv(q, k, v)
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), sm_scale)


def flash_attention_fn(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                       dtype: Optional[torch.dtype] = None, dropout_rate: float = 0.0,
                       deterministic: bool = True) -> torch.Tensor:
    """``_flash_attention_fn``: ``(B, N, H, D)`` inputs moved to ``(B, H, N,
    D)`` in the compute type (``dtype``, else the query's), attention with
    ``sm_scale = 1 / sqrt(D)``, the result moved back to ``(B, N, H, D)``.
    Attention-probability dropout is not applied: with ``dropout_rate > 0``
    outside ``deterministic`` it warns, as the JAX function does."""
    if dropout_rate > 0.0 and not deterministic:
        warnings.warn(DROPOUT_WARNING % dropout_rate, stacklevel=2)
    d = query.shape[-1]
    compute = dtype or query.dtype
    q, k, v = (t.transpose(1, 2).to(compute) for t in (query, key, value))
    out = flash_attention(q, k, v, sm_scale=1.0 / (d ** 0.5))
    return out.transpose(1, 2).to(compute)
