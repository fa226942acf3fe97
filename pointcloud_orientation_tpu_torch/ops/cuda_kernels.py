"""The set-abstraction kernels of the serving and training paths, with
their plain PyTorch versions, launch counters and autograd Functions.

Each wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (built at first use by :mod:`._build`) or
raises; it never falls back. ``<wrapper>.launches`` counts kernel launches
and nothing else.

``sa_group`` (``csrc/sa_group.cu``) replaces the TPU kernel
``pointcloud_orientation_tpu/ops/pallas_kernels.py:_sa_group_call``
(``sa_group_coords_pallas`` / ``sa_group_feats_pallas``). It selects by an
exact threshold select over unique (distance, index) keys
(``csrc/threshold_select.cuh``, the radix select of ``topk_min``): one warp
a centroid with its keys in registers up to 1,024 points, one block a
centroid with its keys in shared memory above.

``sa_mlp_max`` (``csrc/sa_mlp_max.cu``) replaces
``pallas_kernels.py:_sa_mlp_max_fwd_impl`` (``sa_mlp_max_pallas``), in f32
and, with ``bf16=True``, in its bf16 variant: both operands of every product
rounded to bf16, f32 accumulation. It runs on the tensor cores (``mma.sync``;
f32 as 3xTF32, three TF32 products of split operands, within 1e-4 of an
f32 product); activations stay in shared memory, and the last layer is
fused with the max so its outputs are never stored. Its arithmetic is the
backward's recompute, operation for operation, so :func:`sa_mlp_max_bwd`
finds the pooled neighbours the forward found.

``sa_group_scatter`` (``csrc/sa_scatter.cu``) replaces
``pallas_kernels.py:_sa_scatter_call``, the VJP of the grouping's feature
gather; ``SAGroupFeatsFn`` wires it in as the backward of ``sa_group``. It
is bound by bytes and deterministic: a stable counting sort by target row in
shared memory (warp primitives, no atomics), then each row summed in
ascending slot order, no float atomics.

``sa_mlp_max_bwd`` (``csrc/sa_mlp_max_bwd.cu``) replaces
``pallas_kernels.py:_sa_mlp_max_bwd_impl``, the recompute backward of the
MLP+max, in f32 and bf16; ``SAMlpMaxFn`` wires it in as the backward of
``sa_mlp_max``. Every product runs on the tensor cores (``mma.sync``: bf16,
and f32 as 3xTF32); only each layer's pre-activation z goes to a scratch
tensor in device memory, the BatchNorm backward and the max/tie split are
folded into the products' epilogues, and the partial sums over row chunks
are summed inside the library in a fixed order.

``knn`` (``csrc/knn.cu``) replaces ``pallas_kernels.py:knn_pallas``, the
kNN of clouds of 10,240 < N <= 20,480 points; ``fps`` (``csrc/fps.cu``)
replaces ``fps_pallas`` (one block a cloud for the classifier's small
clouds, from about 10,000 points a cloud over a thread-block cluster whose
blocks merge their winners through distributed shared memory) and ``ball_query`` (``csrc/ball_query.cu``)
replaces ``ball_query_pallas``, the sampling and grouping of the ModelNet40
classifier. All three return indices and compute their distances in the
difference form ``((dx*dx + dy*dy) + dz*dz)`` of the TPU kernels; the ball
query also takes the matmul form of the JAX package's XLA path, which
``geometry.ball_query`` picks where the JAX package does. kNN selects as
``sa_group`` does (one block a centroid); FPS is held back by its dependent
block-wide argmax steps; the ball query stages the cloud in shared memory
(a warp a centroid), or splits one centroid's scan over a block's warps
when the centroids are few and the cloud large, and stops scanning once it
has its points.

``topk_min`` (``csrc/topk_min.cu``) replaces ``pallas_kernels.py:topk_min_pallas``,
the K-smallest selection of the grid-pruned kNN (``geometry.grid_pruned_core``):
a radix select of the K-th smallest (value, position) key, 8 bits a pass
over a shared-memory histogram, then a sort of the K candidates; one block
per row, the row staged in shared memory while it fits.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import geometry as G
from ._build import load_library

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (W (Cin,Cout), scale, shift)

MAX_MLP_LAYERS = 4
MAX_K = 128
# FPS: one block holds this many points' running minima in registers (512
# threads of 64 each); a cloud over a cluster of 16 blocks holds 16 times as
# many, above that they live in a device buffer (csrc/fps.cu)
FPS_REGISTER_MAX_N = 32_768
FPS_CLUSTER_MAX_N = 16 * FPS_REGISTER_MAX_N
FPS_MAX_N = 1 << 30  # the kernel's int point index stays in range
TOPK_MIN_MAX_K = 64
TOPK_MIN_MAX_M = 1 << 24  # the kernel's limit on a row's entries


def f32_matmuls() -> None:
    """Full-f32 products on the card, as the JAX side's HIGHEST precision:
    no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bf16_matmuls() -> None:
    """bf16 products in cuBLAS accumulated in f32 throughout, as XLA
    accumulates a bf16 dot: no reduced-precision partial sums."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The value ``x`` enters a product with: itself, or rounded to bf16
    (to nearest even) and widened back to f32, where the product of two
    such values is exact."""
    return x.bfloat16().float() if bf16 else x


def sa_mlp_max_plain(grouped: torch.Tensor, layers: Sequence[Layer],
                     bf16: bool = False) -> torch.Tensor:
    """Plain version of :func:`sa_mlp_max`: ``relu((x @ W) * s + t)`` per
    layer, an f32 matmul (no TF32) of ``x`` and ``W`` as they are or, with
    ``bf16``, rounded to bf16, then the max over the neighbour axis. The
    rows are one 2-D product, as :func:`sa_mlp_max_bwd_plain` recomputes
    them, whether or not autograd records the call."""
    f32_matmuls()
    B, Kn, S, C = grouped.shape
    x = grouped.reshape(-1, C)
    for w, s, t in layers:
        x = torch.relu(torch.matmul(_operand(x, bf16), _operand(w, bf16)) * s + t)
    return x.reshape(B, Kn, S, -1).amax(dim=1)


def _layer_args(layers: Sequence[Layer], c0: int, dev: torch.device):
    """Check the layers against the input width ``c0``; returns the widths,
    and the 12 (W, scale, shift) pointers padded with None."""
    widths = [c0]
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
    ptrs += [None] * (3 * (MAX_MLP_LAYERS - len(layers)))
    return widths, ptrs


def sa_mlp_max(grouped: torch.Tensor, layers: Sequence[Layer],
               bf16: bool = False) -> torch.Tensor:
    """Fused shared MLP + neighbour max-pool.

    ``grouped (B,K,S,C)`` f32 neighbour-major; ``layers`` a list of at most
    4 f32 ``(W (Cin,Cout), scale (Cout,), shift (Cout,))`` with the Dense
    bias and the BatchNorm folded into scale and shift. Returns
    ``(B,S,C_last)`` f32. ``bf16``: both operands of every product rounded
    to bf16, f32 accumulation (``sa_mlp_max_pallas(bf16=True)``); scale,
    shift, ReLU and max in f32 either way.
    """
    if grouped.dtype != torch.float32:
        raise TypeError(f"sa_mlp_max takes float32 grouped features (bf16=True rounds "
                        f"them inside), got {grouped.dtype}")
    if grouped.device.type == "cpu":
        return sa_mlp_max_plain(grouped, layers, bf16)
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
    widths, ptrs = _layer_args(layers, C, dev)
    n_layers = len(layers)
    widths_arg = widths + [0] * (MAX_MLP_LAYERS + 1 - len(widths))
    out = torch.empty((B, S, widths[-1]), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_sa_mlp_max_f32(grouped.data_ptr(), out.data_ptr(), B, K, S, n_layers,
                                      *ptrs, *widths_arg, int(bf16), stream)
    _raise_on(err, f"sa_mlp_max launch (B={B}, K={K}, S={S}, widths={widths}, bf16={bf16}); "
                   "error 1 means arguments the kernel does not take, such as a tile "
                   "too wide for shared memory")
    if bf16:
        sa_mlp_max.launches_bf16 += 1
    else:
        sa_mlp_max.launches += 1
    return out


sa_mlp_max.launches = 0
sa_mlp_max.launches_bf16 = 0


# ---------------------------------------------------------------------------
# K3: scatter-add, the backward of the grouping's feature gather
# ---------------------------------------------------------------------------


def sa_group_scatter_plain(idx: torch.Tensor, dg: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`sa_group_scatter`: one ``index_add_`` over
    the flattened (cloud, row) index."""
    B, S, Kn = idx.shape
    D = dg.shape[-1]
    vals = dg.permute(0, 2, 1, 3).reshape(B * S * Kn, D)  # slots in (b, s, k) order
    base = torch.arange(B, device=idx.device)[:, None, None] * n
    flat = (idx.long() + base).reshape(-1)
    out = torch.zeros((B * n, D), dtype=dg.dtype, device=dg.device)
    out.index_add_(0, flat, vals)
    return out.reshape(B, n, D)


def sa_group_scatter(idx: torch.Tensor, dg: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic scatter-add of neighbour-slot cotangents.

    ``idx (B,S,K)`` int32 rows in ``[0, n)`` (the grouping's ``idx``);
    ``dg (B,K,S,D)`` f32 neighbour-major, contiguous or a column slice of a
    contiguous ``(B,K,S,C)`` tensor (the grouped cotangent's ``[..., 3:]``,
    read in place). Returns ``(B,n,D)``: row ``m`` of cloud ``b`` gets the
    sum of ``dg[b,k,s]`` over the slots with ``idx[b,s,k] == m``, summed in
    ascending slot order, so two launches give the same bits.
    """
    if dg.dtype != torch.float32:
        raise TypeError(f"sa_group_scatter takes float32 cotangents, got {dg.dtype}")
    if dg.device.type == "cpu":
        return sa_group_scatter_plain(idx, dg, n)
    if dg.device.type != "cuda":
        raise ValueError(f"sa_group_scatter runs on cpu or cuda tensors, got {dg.device}")
    if idx.dim() != 3 or dg.dim() != 4:
        raise ValueError(f"idx must be (B,S,K) and dg (B,K,S,D), got {tuple(idx.shape)} "
                         f"and {tuple(dg.shape)}")
    B, S, Kn = idx.shape
    D = dg.shape[-1]
    dev = dg.device
    _check_cuda("idx", idx, torch.int32, (B, S, Kn), dev)
    if tuple(dg.shape) != (B, Kn, S, D):
        raise ValueError(f"dg has shape {tuple(dg.shape)}, expected {(B, Kn, S, D)}")
    row = dg.stride(2)
    if dg.stride() != (Kn * S * row, S * row, row, 1) or row < D:
        raise ValueError(f"dg must be contiguous or a column slice of a contiguous tensor, "
                         f"got strides {dg.stride()}")
    if n < 1 or B > 65535:
        raise ValueError(f"n={n} must be >= 1 and B={B} at most 65535")
    out = torch.empty((B, n, D), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_sa_scatter_f32(idx.data_ptr(), dg.data_ptr(), out.data_ptr(),
                                      B, n, S, Kn, D, row, stream)
    _raise_on(err, f"sa_group_scatter launch (B={B}, N={n}, S={S}, K={Kn}, D={D}); error 1 "
                   "means arguments the kernel does not take, such as S*K and N too large "
                   "for shared memory")
    sa_group_scatter.launches += 1
    return out


sa_group_scatter.launches = 0


class SAGroupFeatsFn(torch.autograd.Function):
    """:func:`sa_group` with features, differentiable in ``feats``: the
    backward scatters the features' part of the grouped cotangent back to
    the source rows through :func:`sa_group_scatter`. ``xyz`` gets zeros
    (coordinates carry no parameters), ``cidx`` and ``idx`` nothing. The
    counterpart of ``sa_group_feats_pallas`` and its VJP: bf16 ``feats``
    are widened to the coordinates' type for the kernel (exactly) and their
    gradient is rounded back to bf16."""

    @staticmethod
    def forward(ctx, xyz, feats, cidx, nsample):
        new_xyz, grouped, idx = sa_group(xyz, feats.to(xyz.dtype), cidx, nsample)
        ctx.save_for_backward(idx)
        ctx.n = feats.shape[1]
        ctx.feats_dtype = feats.dtype
        ctx.xyz_meta = (xyz.shape, xyz.dtype, xyz.device)
        ctx.mark_non_differentiable(idx)
        return new_xyz, grouped, idx

    @staticmethod
    def backward(ctx, dnew_xyz, dgrouped, didx):
        (idx,) = ctx.saved_tensors
        dxyz = dfeats = None
        if ctx.needs_input_grad[0]:
            shape, dtype, device = ctx.xyz_meta
            dxyz = torch.zeros(shape, dtype=dtype, device=device)
        if ctx.needs_input_grad[1]:
            dfeats = sa_group_scatter(idx, dgrouped.contiguous()[..., 3:], ctx.n)
            dfeats = dfeats.to(ctx.feats_dtype)
        return dxyz, dfeats, None, None


# ---------------------------------------------------------------------------
# K4: recompute backward of the shared MLP + max
# ---------------------------------------------------------------------------


def sa_mlp_max_bwd_plain(grouped: torch.Tensor, layers: Sequence[Layer], dpooled: torch.Tensor,
                         need_dgrouped: bool = True, bf16: bool = False
                         ) -> Tuple[Optional[torch.Tensor], List[Layer]]:
    """Plain version of :func:`sa_mlp_max_bwd`, step by step as the TPU
    kernel (``_sa_mlp_max_bwd_kernel``): recompute the forward, split
    ``dpooled`` evenly over the neighbours equal to the maximum, then per
    layer from the last ``dy = da * (y > 0)``, ``dscale = sum(dy * z)``,
    ``dshift = sum(dy)``, ``dz = dy * scale``, ``dW = x^T dz`` and
    ``da = dz W^T``. With ``bf16`` both operands of every product (the
    recompute, dW and da) are rounded to bf16, which autograd through
    :func:`sa_mlp_max_plain` would not do for the backward's products."""
    f32_matmuls()
    B, Kn, S, C = grouped.shape
    acts = [grouped.reshape(-1, C)]
    pre = []
    for w, s, t in layers:
        z = torch.matmul(_operand(acts[-1], bf16), _operand(w, bf16))
        y = z * s + t
        pre.append((z, y))
        acts.append(torch.relu(y))
    a_last = acts[-1].reshape(B, Kn, S, -1)
    ties = (a_last == a_last.amax(dim=1, keepdim=True)).float()
    da = (ties * (dpooled / ties.sum(dim=1))[:, None]).reshape(-1, a_last.shape[-1])
    dlayers: List[Layer] = []
    for l in range(len(layers) - 1, -1, -1):
        (z, y), (w, s, _) = pre[l], layers[l]
        dy = da * (y > 0.0).float()
        dz = dy * s
        dw = torch.matmul(_operand(acts[l], bf16).t(), _operand(dz, bf16))
        dlayers.insert(0, (dw, (dy * z).sum(dim=0), dy.sum(dim=0)))
        if l > 0 or need_dgrouped:
            da = torch.matmul(_operand(dz, bf16), _operand(w, bf16).t())
    return (da.reshape(B, Kn, S, C) if need_dgrouped else None), dlayers


BWD_TILE_ROWS = 64  # rows of the kernel's product tile: one dscale/dshift partial each
# blocks the kernel's split-K dW aims at for its smallest layer: two an SM of
# the H100 (chip_sweep.py times one and four an SM beside it, PERF.md)
BWD_CHUNK_BLOCKS = 264


def _bwd_chunk_rows(rows: int, widths: Sequence[int]) -> int:
    """Rows per chunk of the kernel's split-K dW = x^T dz: BWD_CHUNK_BLOCKS
    blocks for the layer with the fewest 64 x 64 output tiles, chunks a
    multiple of 32 rows (the kernel's stage). A function of the shapes
    alone, so the partials are summed in the same order every launch."""
    tiles = min(-(-ci // 64) * -(-co // 64) for ci, co in zip(widths[:-1], widths[1:]))
    chunks = max(1, min(-(-BWD_CHUNK_BLOCKS // tiles), rows // 32))
    per_chunk = -(-rows // chunks)
    return -(-per_chunk // 32) * 32


def _bwd_scratch_floats(rows: int, widths: Sequence[int], chunk_rows: int) -> int:
    """The kernel's scratch: z of every layer, then per layer the dW
    partials (one per row chunk) and the dscale and dshift partials (one per
    tile of BWD_TILE_ROWS rows)."""
    chunks = -(-rows // chunk_rows)
    tiles = -(-rows // BWD_TILE_ROWS)
    pairs = list(zip(widths[:-1], widths[1:]))
    return rows * sum(widths[1:]) + sum(chunks * ci * co + 2 * tiles * co for ci, co in pairs)


def sa_mlp_max_bwd(grouped: torch.Tensor, layers: Sequence[Layer], dpooled: torch.Tensor,
                   need_dgrouped: bool = True, bf16: bool = False
                   ) -> Tuple[Optional[torch.Tensor], List[Layer]]:
    """Backward of :func:`sa_mlp_max`: recomputes the forward, splits
    ``dpooled (B,S,C_last)`` evenly over the neighbours equal to the
    recomputed maximum, and runs it back through relu, scale/shift and W
    (``bf16``: every product of operands rounded to bf16, as the forward).
    Returns ``dgrouped (B,K,S,C)`` f32 (None when ``need_dgrouped`` is
    false: the kernel then skips that product) and ``[(dW, dscale,
    dshift)]`` per layer, summed inside the kernel's library."""
    if grouped.dtype != torch.float32:
        raise TypeError(f"sa_mlp_max_bwd takes float32 grouped features (bf16=True rounds "
                        f"them inside), got {grouped.dtype}")
    if grouped.device.type == "cpu":
        return sa_mlp_max_bwd_plain(grouped, layers, dpooled, need_dgrouped, bf16)
    if grouped.device.type != "cuda":
        raise ValueError(f"sa_mlp_max_bwd runs on cpu or cuda tensors, got {grouped.device}")
    if grouped.dim() != 4:
        raise ValueError(f"grouped must be (B, K, S, C), got {tuple(grouped.shape)}")
    if not 1 <= len(layers) <= MAX_MLP_LAYERS:
        raise ValueError(f"sa_mlp_max_bwd takes 1 to {MAX_MLP_LAYERS} layers, got {len(layers)}")
    B, Kn, S, C = grouped.shape
    dev = grouped.device
    _check_cuda("grouped", grouped, torch.float32, (B, Kn, S, C), dev)
    widths, ptrs = _layer_args(layers, C, dev)
    grads, grad_ptrs = [], []
    _check_cuda("dpooled", dpooled, torch.float32, (B, S, widths[-1]), dev)
    rows = B * Kn * S
    chunk_rows = _bwd_chunk_rows(rows, widths)
    for cin, cout in zip(widths[:-1], widths[1:]):
        dw = torch.empty((cin, cout), dtype=torch.float32, device=dev)
        ds = torch.empty((cout,), dtype=torch.float32, device=dev)
        dt = torch.empty((cout,), dtype=torch.float32, device=dev)
        grads.append((dw, ds, dt))
        grad_ptrs += [dw.data_ptr(), ds.data_ptr(), dt.data_ptr()]
    n_layers = len(layers)
    grad_ptrs += [None] * (3 * (MAX_MLP_LAYERS - n_layers))
    scratch_floats = _bwd_scratch_floats(rows, widths, chunk_rows)
    if scratch_floats >= 2 ** 31:
        raise ValueError(f"scratch of {scratch_floats} floats exceeds the kernel's int range")
    scratch = torch.empty((scratch_floats,), dtype=torch.float32, device=dev)
    dgrouped = torch.empty_like(grouped) if need_dgrouped else None
    widths_arg = widths + [0] * (MAX_MLP_LAYERS + 1 - len(widths))
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_sa_mlp_max_bwd_f32(
            grouped.data_ptr(), dpooled.data_ptr(),
            None if dgrouped is None else dgrouped.data_ptr(), scratch.data_ptr(),
            scratch_floats, chunk_rows, B, Kn, S, n_layers, *ptrs, *grad_ptrs, *widths_arg,
            int(bf16), stream)
    _raise_on(err, f"sa_mlp_max_bwd launch (B={B}, K={Kn}, S={S}, widths={widths}, "
                   f"bf16={bf16})")
    if bf16:
        sa_mlp_max_bwd.launches_bf16 += 1
    else:
        sa_mlp_max_bwd.launches += 1
    return dgrouped, [tuple(layer) for layer in grads]


sa_mlp_max_bwd.launches = 0
sa_mlp_max_bwd.launches_bf16 = 0


class SAMlpMaxFn(torch.autograd.Function):
    """:func:`sa_mlp_max` differentiable in ``grouped`` and in every
    layer's W, scale and shift (so that scale and shift computed from
    batch statistics carry their gradients on); the backward is
    :func:`sa_mlp_max_bwd`. The counterpart of ``sa_mlp_max_pallas`` and its
    VJP. Call as ``SAMlpMaxFn.apply(grouped, bf16, w0, s0, t0, w1, ...)``."""

    @staticmethod
    def forward(ctx, grouped, bf16, *flat):
        ctx.save_for_backward(grouped, *flat)
        ctx.bf16 = bf16
        return sa_mlp_max(grouped, [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)], bf16)

    @staticmethod
    def backward(ctx, dpooled):
        grouped, *flat = ctx.saved_tensors
        layers = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        dgrouped, dlayers = sa_mlp_max_bwd(grouped, layers, dpooled.contiguous(),
                                           need_dgrouped=ctx.needs_input_grad[0], bf16=ctx.bf16)
        return (dgrouped, None, *[d for layer in dlayers for d in layer])


# ---------------------------------------------------------------------------
# K5-K7: the index kernels (kNN above the fused grouping's size, FPS, ball query)
# ---------------------------------------------------------------------------


def _check_points(name: str, fn: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{fn} takes float32 {name}, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name} must be (B, M, 3), got {tuple(t.shape)}")


def _cuda_only(fn: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn} runs on cpu or cuda tensors, got {t.device}")


def knn_plain(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Plain version of :func:`knn`: difference-form distances, then the
    first ``nsample`` of a stable sort."""
    dist = G.diff_square_distance(new_xyz, xyz)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :nsample].to(torch.int32)


def knn(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Exact kNN indices ``(B,S,nsample)`` int32 of ``new_xyz (B,S,3)`` in
    ``xyz (B,N,3)``, f32, nearest first, equal distances to the lowest
    index; distances in the difference form. The kernel takes
    ``N <= geometry.KNN_KERNEL_MAX_N`` and ``nsample <= 128``."""
    _check_points("new_xyz", "knn", new_xyz)
    _check_points("xyz", "knn", xyz)
    if xyz.device.type == "cpu":
        return knn_plain(new_xyz, xyz, nsample)
    _cuda_only("knn", xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if not 1 <= nsample <= min(N, MAX_K):
        raise ValueError(f"nsample={nsample} must lie in [1, min(N={N}, {MAX_K})]")
    if N > G.KNN_KERNEL_MAX_N or B > 65535 or S > 65535:
        raise ValueError(f"N={N} must be at most {G.KNN_KERNEL_MAX_N}, B={B} and S={S} "
                         "at most 65535")
    dev = xyz.device
    _check_cuda("xyz", xyz, torch.float32, (B, N, 3), dev)
    _check_cuda("new_xyz", new_xyz, torch.float32, (B, S, 3), dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_knn_f32(new_xyz.data_ptr(), xyz.data_ptr(), idx.data_ptr(),
                               B, N, S, nsample, stream)
    _raise_on(err, f"knn launch (B={B}, N={N}, S={S}, K={nsample})")
    knn.launches += 1
    return idx


knn.launches = 0


def fps_plain(xyz: torch.Tensor, seeds: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of :func:`fps`: the step loop over ``(B, N)`` tensors."""
    B, N, _ = xyz.shape
    batch = torch.arange(B, device=xyz.device)
    far = seeds.long().clamp(0, N - 1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        if i + 1 == npoint:
            break
        diff = xyz - xyz[batch, far][:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)  # the first of equal maxima
    return out


def fps(xyz: torch.Tensor, seeds: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling: ``(B,npoint)`` int32 indices into ``xyz
    (B,N,3)`` f32, starting at ``seeds (B,)`` int32 in ``[0, N)``. Each step
    lowers the running minimum squared distance (from 1e10) and moves to its
    largest entry, equal values to the lowest index. The kernel takes
    ``N <= FPS_MAX_N``; above ``FPS_CLUSTER_MAX_N`` points the running
    minima live in a ``(B, N)`` buffer allocated here."""
    _check_points("xyz", "fps", xyz)
    if npoint < 1:
        raise ValueError(f"npoint={npoint} must be >= 1")
    if xyz.device.type == "cpu":
        return fps_plain(xyz, seeds, npoint)
    _cuda_only("fps", xyz)
    B, N, _ = xyz.shape
    if N > FPS_MAX_N:
        raise ValueError(f"N={N} exceeds the FPS kernel's {FPS_MAX_N} points")
    dev = xyz.device
    _check_cuda("xyz", xyz, torch.float32, (B, N, 3), dev)
    _check_cuda("seeds", seeds, torch.int32, (B,), dev)
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    dist = (torch.empty((B, N), dtype=torch.float32, device=dev)
            if N > FPS_CLUSTER_MAX_N else None)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_fps_f32(xyz.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                               None if dist is None else dist.data_ptr(), B, N, npoint, stream)
    _raise_on(err, f"fps launch (B={B}, N={N}, npoint={npoint})")
    fps.launches += 1
    return out


fps.launches = 0


def radius_sq_f32(radius: float) -> float:
    """``float(radius) ** 2`` in double, as JAX squares it, then rounded to
    f32, the type the comparison runs in."""
    return float(torch.tensor(float(radius) ** 2, dtype=torch.float32))


def ball_query_plain(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
                     nsample: int, matmul_form: bool = False) -> torch.Tensor:
    """Plain version of :func:`ball_query`: the in-radius indices (others
    N), sorted, the first ``nsample``, N replaced by the first, clipped."""
    N = xyz.shape[1]
    distance = G.square_distance if matmul_form else G.diff_square_distance
    dist = distance(new_xyz, xyz)
    r2 = torch.tensor(radius_sq_f32(radius), dtype=torch.float32, device=xyz.device)
    cols = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(dist <= r2, cols, torch.full_like(cols, N))
    take = torch.sort(cand, dim=-1).values[..., :nsample]
    if nsample > N:  # more slots than points: the rest hold the sentinel too
        take = torch.cat([take, torch.full((*take.shape[:-1], nsample - N), N,
                                           dtype=take.dtype, device=take.device)], dim=-1)
    take = torch.where(take == N, take[..., :1], take)
    return take.clamp(0, N - 1).to(torch.int32)


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int, matmul_form: bool = False) -> torch.Tensor:
    """Radius ball query: ``(B,S,nsample)`` int32, for each centroid of
    ``new_xyz (B,S,3)`` the smallest indices of ``xyz (B,N,3)`` whose
    squared distance is ``<= radius**2`` (squared in double, compared in
    f32), ascending, short rows padded with the first one found; a centroid
    with no point in its radius gets ``N - 1`` everywhere. The distance is
    the difference form, or with ``matmul_form`` the matmul form
    ``(c2 - 2*cross) + x2`` of :func:`geometry.square_distance`."""
    _check_points("new_xyz", "ball_query", new_xyz)
    _check_points("xyz", "ball_query", xyz)
    if nsample < 1:
        raise ValueError(f"nsample={nsample} must be >= 1")
    if xyz.device.type == "cpu":
        return ball_query_plain(new_xyz, xyz, radius, nsample, matmul_form)
    _cuda_only("ball_query", xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535")
    dev = xyz.device
    _check_cuda("xyz", xyz, torch.float32, (B, N, 3), dev)
    _check_cuda("new_xyz", new_xyz, torch.float32, (B, S, 3), dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_ball_query_f32(new_xyz.data_ptr(), xyz.data_ptr(), idx.data_ptr(),
                                      B, N, S, nsample, radius_sq_f32(radius),
                                      int(matmul_form), stream)
    _raise_on(err, f"ball_query launch (B={B}, N={N}, S={S}, K={nsample}, "
                   f"matmul_form={matmul_form})")
    ball_query.launches += 1
    return idx


ball_query.launches = 0


# ---------------------------------------------------------------------------
# K8: K smallest of a candidate tile (the grid-pruned kNN's selection)
# ---------------------------------------------------------------------------


def topk_min_plain(d: torch.Tensor, nsample: int) -> torch.Tensor:
    """Plain version of :func:`topk_min`: the first ``nsample`` positions of
    a stable sort of each row, and 0 wherever the sorted value is ``+inf``
    (``topk_min_pallas`` evicts each winner to ``+inf``, so once the finite
    entries are taken every pass picks position 0)."""
    srt = torch.sort(d, dim=-1, stable=True)
    idx = srt.indices[..., :nsample]
    return torch.where(srt.values[..., :nsample] == float("inf"), torch.zeros_like(idx),
                       idx).to(torch.int32)


def topk_min(d: torch.Tensor, nsample: int) -> torch.Tensor:
    """Positions ``(B,S,nsample)`` int32 of the ``nsample`` smallest entries
    of each row of ``d (B,S,M)`` f32, nearest first, equal values to the
    lowest position. Entries are finite or ``+inf`` (an empty slot); past a
    row's finite entries the positions are 0, as ``topk_min_pallas`` gives
    them. The kernel takes ``nsample <= TOPK_MIN_MAX_K`` and ``M <=
    TOPK_MIN_MAX_M``."""
    if d.dtype != torch.float32:
        raise TypeError(f"topk_min takes float32 distances, got {d.dtype}")
    if d.dim() != 3:
        raise ValueError(f"d must be (B, S, M), got {tuple(d.shape)}")
    B, S, M = d.shape
    if not 1 <= nsample <= min(M, TOPK_MIN_MAX_K):
        raise ValueError(f"nsample={nsample} must lie in [1, min(M={M}, {TOPK_MIN_MAX_K})]")
    if d.device.type == "cpu":
        return topk_min_plain(d, nsample)
    _cuda_only("topk_min", d)
    if M > TOPK_MIN_MAX_M or B * S > 2 ** 31 - 1:
        raise ValueError(f"M={M} must be at most {TOPK_MIN_MAX_M} and B*S={B * S} below 2^31")
    dev = d.device
    _check_cuda("d", d, torch.float32, (B, S, M), dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcot_topk_min_f32(d.data_ptr(), idx.data_ptr(), B * S, M, nsample, stream)
    _raise_on(err, f"topk_min launch (B={B}, S={S}, M={M}, K={nsample})")
    topk_min.launches += 1
    return idx


topk_min.launches = 0

# counter name -> (wrapper, its attribute); the bf16 variants count apart
_COUNTERS = {fn.__name__: (fn, "launches") for fn in
             (sa_group, sa_mlp_max, sa_group_scatter, sa_mlp_max_bwd, knn, fps, ball_query,
              topk_min)}
_COUNTERS["sa_mlp_max_bf16"] = (sa_mlp_max, "launches_bf16")
_COUNTERS["sa_mlp_max_bwd_bf16"] = (sa_mlp_max_bwd, "launches_bf16")


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}
