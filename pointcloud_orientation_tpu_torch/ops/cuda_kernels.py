"""The two set-abstraction kernels of the serving path, with their plain
PyTorch versions and launch counters.

Each wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (built at first use by :mod:`._build`) or
raises; it never falls back. ``<wrapper>.launches`` counts kernel launches
and nothing else.

``sa_group`` (``csrc/sa_group.cu``) replaces the TPU kernel
``pointcloud_orientation_tpu/ops/pallas_kernels.py:_sa_group_call``
(``sa_group_coords_pallas`` / ``sa_group_feats_pallas``). On this card it is
held back by its K dependent block-wide argmin passes, not by bytes or
FLOPs; one block per centroid keeps the distances in shared memory and each
pass is a register-and-shuffle reduction (see the source).

``sa_mlp_max`` (``csrc/sa_mlp_max.cu``) replaces
``pallas_kernels.py:_sa_mlp_max_fwd_impl`` (``sa_mlp_max_pallas``, f32). It
is bound by f32 operations; activations stay in shared memory, and the last
layer is fused with the max so its outputs are never stored.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import geometry as G
from ._build import load_library

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (W (Cin,Cout), scale, shift)

MAX_MLP_LAYERS = 4
MAX_K = 128


def f32_matmuls() -> None:
    """Full-f32 products on the card, as the JAX side's HIGHEST precision:
    no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: fused SA grouping
# ---------------------------------------------------------------------------


def sa_group_plain(
    xyz: torch.Tensor, feats: Optional[torch.Tensor], cidx: torch.Tensor, nsample: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sa_group`: centroid gather, exact kNN by a
    stable sort of the elementwise distances, row gather, centering."""
    new_xyz = G.index_points(xyz, cidx)
    idx = G.knn_query(new_xyz, xyz, nsample)  # (B,S,K)
    grouped = G.index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, G.index_points(feats, idx)], dim=-1)
    return new_xyz, grouped.transpose(1, 2).contiguous(), idx.to(torch.int32)


def sa_group(
    xyz: torch.Tensor, feats: Optional[torch.Tensor], cidx: torch.Tensor, nsample: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused SA grouping.

    ``xyz (B,N,3)`` f32, ``feats (B,N,D)`` f32 or None, ``cidx (B,S)`` int32
    centroid indices in ``[0, N)``. Returns ``new_xyz (B,S,3)``, ``grouped
    (B,K,S,3+D)`` neighbour-major (the centred neighbour coordinates, then
    their features; the layout ``sa_mlp_max`` reads) and ``idx (B,S,K)``
    int32, nearest first, equal distances to the lowest index.
    """
    if xyz.dtype != torch.float32 or (feats is not None and feats.dtype != torch.float32):
        raise TypeError("sa_group takes float32 xyz and feats")
    if xyz.device.type == "cpu":
        return sa_group_plain(xyz, feats, cidx, nsample)
    if xyz.device.type != "cuda":
        raise ValueError(f"sa_group runs on cpu or cuda tensors, got {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if cidx.dim() != 2 or cidx.shape[0] != B:
        raise ValueError(f"cidx must be (B, S) with B={B}, got {tuple(cidx.shape)}")
    S = cidx.shape[1]
    if not 1 <= nsample <= min(N, MAX_K):
        raise ValueError(f"nsample={nsample} must lie in [1, min(N={N}, {MAX_K})]")
    if N > G.FUSED_GROUP_MAX_N:
        raise ValueError(
            f"N={N} exceeds the grouping kernel's {G.FUSED_GROUP_MAX_N} points "
            "(the JAX package uses another kernel above this size; not ported)")
    if B > 65535 or S > 65535:
        raise ValueError(f"B={B} and S={S} must be at most 65535")
    dev = xyz.device
    _check_cuda("xyz", xyz, torch.float32, (B, N, 3), dev)
    _check_cuda("cidx", cidx, torch.int32, (B, S), dev)
    D = 0
    if feats is not None:
        D = feats.shape[-1]
        _check_cuda("feats", feats, torch.float32, (B, N, D), dev)
    new_xyz = torch.empty((B, S, 3), dtype=torch.float32, device=dev)
    grouped = torch.empty((B, nsample, S, 3 + D), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_sa_group_f32(
            xyz.data_ptr(), None if feats is None else feats.data_ptr(), cidx.data_ptr(),
            new_xyz.data_ptr(), grouped.data_ptr(), idx.data_ptr(),
            B, N, S, nsample, D, stream)
    _raise_on(err, f"sa_group launch (B={B}, N={N}, S={S}, K={nsample}, D={D})")
    sa_group.launches += 1
    return new_xyz, grouped, idx


sa_group.launches = 0


# ---------------------------------------------------------------------------
# K2: fused shared MLP + max over neighbours
# ---------------------------------------------------------------------------


def sa_mlp_max_plain(grouped: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """Plain version of :func:`sa_mlp_max`: ``relu((x @ W) * s + t)`` per
    layer in full f32, then the max over the neighbour axis."""
    f32_matmuls()
    x = grouped
    for w, s, t in layers:
        x = torch.relu(torch.matmul(x, w) * s + t)
    return x.amax(dim=1)


def sa_mlp_max(grouped: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """Fused shared MLP + neighbour max-pool, f32.

    ``grouped (B,K,S,C)`` neighbour-major; ``layers`` a list of at most 4
    ``(W (Cin,Cout), scale (Cout,), shift (Cout,))`` with the Dense bias and
    the BatchNorm folded into scale and shift. Returns ``(B,S,C_last)``.
    """
    if grouped.dtype != torch.float32:
        raise TypeError(f"sa_mlp_max takes float32 (the bf16 variant is not ported), "
                        f"got {grouped.dtype}")
    if grouped.device.type == "cpu":
        return sa_mlp_max_plain(grouped, layers)
    if grouped.device.type != "cuda":
        raise ValueError(f"sa_mlp_max runs on cpu or cuda tensors, got {grouped.device}")
    if grouped.dim() != 4:
        raise ValueError(f"grouped must be (B, K, S, C), got {tuple(grouped.shape)}")
    if not 1 <= len(layers) <= MAX_MLP_LAYERS:
        raise ValueError(f"sa_mlp_max takes 1 to {MAX_MLP_LAYERS} layers, got {len(layers)}")
    B, K, S, C = grouped.shape
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535")
    dev = grouped.device
    _check_cuda("grouped", grouped, torch.float32, (B, K, S, C), dev)
    widths = [C]
    ptrs = []
    for i, (w, s, t) in enumerate(layers):
        if w.dim() != 2:
            raise ValueError(f"layer {i} W must be 2-D, got {tuple(w.shape)}")
        cin, cout = w.shape
        if cin != widths[-1]:
            raise ValueError(f"layer {i} takes {cin} channels, gets {widths[-1]}")
        _check_cuda(f"layer {i} W", w, torch.float32, (cin, cout), dev)
        _check_cuda(f"layer {i} scale", s, torch.float32, (cout,), dev)
        _check_cuda(f"layer {i} shift", t, torch.float32, (cout,), dev)
        widths.append(cout)
        ptrs += [w.data_ptr(), s.data_ptr(), t.data_ptr()]
    n_layers = len(layers)
    ptrs += [None] * (3 * (MAX_MLP_LAYERS - n_layers))
    widths_arg = widths + [0] * (MAX_MLP_LAYERS + 1 - len(widths))
    out = torch.empty((B, S, widths[-1]), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_sa_mlp_max_f32(
            grouped.data_ptr(), out.data_ptr(), B, K, S, n_layers, *ptrs, *widths_arg, stream)
    _raise_on(err, f"sa_mlp_max launch (B={B}, K={K}, S={S}, widths={widths}); "
                   "error 1 means arguments the kernel does not take, such as a tile "
                   "too wide for shared memory")
    sa_mlp_max.launches += 1
    return out


sa_mlp_max.launches = 0


def reset_launch_counts() -> None:
    sa_group.launches = 0
    sa_mlp_max.launches = 0


def launch_counts() -> dict:
    return {"sa_group": sa_group.launches, "sa_mlp_max": sa_mlp_max.launches}
