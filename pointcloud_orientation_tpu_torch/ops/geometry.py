"""Point-cloud geometry for the PointNet++ serving and training paths, in PyTorch.

Counterpart of ``pointcloud_orientation_tpu/ops/geometry.py``: ``first``,
``random`` or farthest-point (``fps``) centroids, kNN (exact, ``approx`` or
``grid``: :func:`set_knn_impl`) or radius ball query (``ball``) grouping,
neighbour-major layout. Other modes raise.

kNN grouping follows the JAX package's dispatch on the TPU by cloud size:
the fused grouping kernel up to ``FUSED_GROUP_MAX_N`` points, the kNN kernel
and gathers up to ``KNN_KERNEL_MAX_N``, and above it a stable sort of the
matmul-form distances (the JAX package's XLA ``top_k`` path; it has no
kernel there either). FPS and the ball query run through their kernels at
every size. The ball query takes the distance form that the JAX package's
dispatch gives on the TPU (``ball_query_matmul_form``): the difference form
of ``ball_query_pallas`` for ``BALL_KERNEL_MIN_N <= N <= KNN_KERNEL_MAX_N``,
the matmul form of its XLA path elsewhere, the classifier's second stage
(512 points) among them. FPS below 1024 points takes the XLA loop there,
whose distances are the kernel's difference form.

Two distance forms, each in one fixed order with every product and sum
rounded on its own (no ``bmm``, no ``cdist``), so that each kernel and its
plain version agree bit for bit on the card: ``square_distance``, the
matmul form ``c2 - 2*c.x + x2`` of the fused grouping kernel and of the
ball query outside the TPU kernel's sizes, and ``diff_square_distance``,
the difference form ``((dx*dx + dy*dy) + dz*dz)`` of the kNN, FPS and
ball-query kernels (and of their TPU counterparts).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

# Largest cloud the fused grouping kernel takes: its N distances must fit in
# 48 KB of shared memory. The JAX package switches to its kNN kernel above
# this size (``_FUSED_GROUP_MAX_N`` there), and so does this port.
FUSED_GROUP_MAX_N = 10_240
# Largest cloud the kNN kernel takes (``_PALLAS_KNN_MAX_N`` there); above it
# kNN is a sort of the matmul-form distances, in both packages.
KNN_KERNEL_MAX_N = 20_480
# Smallest cloud the JAX package sends to its ball-query kernel on the TPU
# (``_pallas_eligible`` there); smaller clouds take its XLA path.
BALL_KERNEL_MIN_N = 1024

# kNN formulation, as the JAX package's module state (``set_knn_impl``
# there): "exact", or "approx" or "grid" for stages of at least
# _KNN_APPROX_MIN_N points; the recall target that "approx" keeps.
_KNN_IMPL = "exact"
_KNN_RECALL = 0.95
_KNN_APPROX_MIN_N = 4096


def set_knn_impl(impl: str, recall_target: Optional[float] = None,
                 approx_min_n: Optional[int] = None) -> None:
    """Select the kNN grouping formulation: ``"exact"`` (default),
    ``"approx"`` (:func:`approx_knn` for stages with at least
    ``approx_min_n`` candidate points) or ``"grid"`` (exact spatial pruning
    for the same stages; :func:`grid_pruned_knn`). Validates every argument
    as the JAX package does before changing anything, so a failed call
    leaves the state as it was. ``recall_target`` is stored as there; the
    port's ``"approx"`` selects exactly (recall 1), which meets any
    target."""
    global _KNN_IMPL, _KNN_RECALL, _KNN_APPROX_MIN_N
    if impl not in ("exact", "approx", "grid"):
        raise ValueError(f"bad knn impl: {impl}")
    if recall_target is not None and not 0.0 < recall_target <= 1.0:
        raise ValueError(f"bad recall_target: {recall_target}")
    if approx_min_n is not None and approx_min_n < 1:
        raise ValueError(f"bad approx_min_n: {approx_min_n}")
    _KNN_IMPL = impl
    if recall_target is not None:
        _KNN_RECALL = recall_target
    if approx_min_n is not None:
        _KNN_APPROX_MIN_N = approx_min_n


def knn_impl() -> str:
    """The kNN formulation :func:`set_knn_impl` selected."""
    return _KNN_IMPL


def approx_eligible(n: int) -> bool:
    """Whether a stage of ``n`` candidate points takes the approx path."""
    return _KNN_IMPL == "approx" and n >= _KNN_APPROX_MIN_N


def grid_eligible(n: int) -> bool:
    """Whether a stage of ``n`` candidate points takes the grid path."""
    return _KNN_IMPL == "grid" and n >= _KNN_APPROX_MIN_N


# The environment knobs go through the validating setter, as in the JAX
# package, so a typo (PCOT_KNN=Approx) fails at import instead of running
# the exact path under another name.
if ("PCOT_KNN" in os.environ or "PCOT_KNN_RECALL" in os.environ
        or "PCOT_KNN_APPROX_MIN_N" in os.environ):
    set_knn_impl(
        os.environ.get("PCOT_KNN", "exact").strip(),
        float(os.environ["PCOT_KNN_RECALL"]) if "PCOT_KNN_RECALL" in os.environ else None,
        int(os.environ["PCOT_KNN_APPROX_MIN_N"])
        if "PCOT_KNN_APPROX_MIN_N" in os.environ else None,
    )

# Grid-pruned kNN: G bins per axis, a Chebyshev-r cell cube around each
# centroid, at most M candidates a centroid (more fails the certificate).
_KNN_GRID_G = int(os.environ.get("PCOT_KNN_GRID_G", "8"))
_KNN_GRID_R = int(os.environ.get("PCOT_KNN_GRID_R", "1"))
_KNN_GRID_M = int(os.environ.get("PCOT_KNN_GRID_M", "1024"))


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather of ``points (B, N, C)`` by ``idx (B, S)`` or ``(B, S, K)``."""
    B, _, C = points.shape
    if idx.dim() == 2:
        return torch.gather(points, 1, idx.long()[:, :, None].expand(-1, -1, C))
    if idx.dim() == 3:
        _, S, K = idx.shape
        flat = idx.long().reshape(B, S * K, 1).expand(-1, -1, C)
        return torch.gather(points, 1, flat).reshape(B, S, K, C)
    raise ValueError(f"idx must be rank 2 or 3, got shape {tuple(idx.shape)}")


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``(B,S,3) x (B,N,3) -> (B,S,N)`` in f32, as
    ``(c2 - 2*cross) + x2`` with every product and sum rounded on its own."""
    src = src.float()
    dst = dst.float()
    s = src[:, :, None, :]
    d = dst[:, None, :, :]
    cross = (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]) + s[..., 2] * d[..., 2]
    return (_sq_norm(src)[:, :, None] - 2.0 * cross) + _sq_norm(dst)[:, None, :]


def diff_square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``(B,S,3) x (B,N,3) -> (B,S,N)`` in f32 in
    the difference form ``((dx*dx + dy*dy) + dz*dz)``, ``d = src - dst``,
    every product and sum rounded on its own."""
    diff = src.float()[:, :, None, :] - dst.float()[:, None, :, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def knn_query(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Indices ``(B, S, nsample)`` int64 of the nearest points by the
    matmul-form distances, nearest first, equal distances to the lowest
    index (a stable sort): the JAX package's XLA kNN."""
    if nsample > xyz.shape[1]:
        raise ValueError(f"nsample={nsample} exceeds the {xyz.shape[1]} points")
    dist = square_distance(new_xyz, xyz)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :nsample]


def exact_full_knn(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """kNN indices ``(B, S, nsample)`` as the JAX package selects them on the
    TPU (``knn_query`` / ``_exact_full_knn`` there): the kNN kernel
    (difference-form distances) up to ``KNN_KERNEL_MAX_N`` points, above it
    :func:`knn_query`."""
    from . import cuda_kernels as K  # cuda_kernels imports this module

    if xyz.shape[1] <= KNN_KERNEL_MAX_N:
        return K.knn(new_xyz.contiguous(), xyz.contiguous(), nsample)
    return knn_query(new_xyz, xyz, nsample)


def approx_knn(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """kNN indices ``(B, S, nsample)`` int32 of the JAX package's
    ``"approx"`` path (``_approx_knn``: ``jax.lax.approx_min_k`` over the
    matmul-form distances): :func:`square_distance`, then each row's
    ``nsample`` smallest through the ``topk_min`` kernel (its plain version
    on the CPU). The card gives the exact K nearest, nearest first, equal
    distances to the first occurrence: recall 1, whatever the recall target
    (off the TPU, ``approx_min_k`` is an exact selection too). ``nsample``
    is at most the kernel's ``TOPK_MIN_MAX_K``."""
    from . import cuda_kernels as K

    return K.topk_min(square_distance(new_xyz, xyz).contiguous(), nsample)


def knn_indices(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """kNN indices ``(B, S, nsample)`` through the formulation
    :func:`set_knn_impl` selected for a stage of this size (the JAX
    package's ``knn_query`` dispatch): :func:`approx_knn`,
    :func:`grid_pruned_knn` or :func:`exact_full_knn`."""
    if approx_eligible(xyz.shape[1]):
        return approx_knn(new_xyz, xyz, nsample)
    if grid_eligible(xyz.shape[1]):
        return grid_pruned_knn(new_xyz, xyz, nsample)
    return exact_full_knn(new_xyz, xyz, nsample)


def _cells(p: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, g: int) -> torch.Tensor:
    """Integer cell coordinates ``(..., 3)`` of ``p`` in the ``g^3`` grid
    over ``[lo, lo + g*h)``: ``(p - lo) / h`` in f32, clipped, truncated."""
    return ((p - lo) / h).clamp(0, g - 1).to(torch.int32)


def grid_bins(x: torch.Tensor, g: int):
    """The grid's index over ``x (B, N, 3)`` f32: ``lo (B,1,3)`` and ``h
    (B,1,3)`` (the bounding box widened by 1e-6, cut in ``g`` bins an axis),
    ``order (B, N)`` (a stable sort of the points by linear cell id, z
    fastest), the sorted points ``(B, N, 3)`` and ``starts (B, g^3 + 1)``,
    the sorted position where each cell's run starts."""
    lo = x.amin(dim=1, keepdim=True) - 1e-6
    hi = x.amax(dim=1, keepdim=True) + 1e-6
    h = (hi - lo) / g
    cell = _cells(x, lo, h, g)
    cid = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]  # (B, N)
    order = torch.sort(cid, dim=-1, stable=True).indices  # window order decides ties
    cid_s = torch.gather(cid, 1, order)
    cells = torch.arange(g ** 3 + 1, dtype=cid.dtype, device=x.device)
    starts = torch.searchsorted(cid_s, cells.expand(x.shape[0], -1).contiguous())
    return lo, h, order, index_points(x, order), starts


def run_of_slot(o: torch.Tensor, m: int) -> torch.Tensor:
    """For the inclusive cumulative run lengths ``o (B, S, R)``, the run
    that holds each window slot ``t < m``: the number of runs whose ``o`` is
    ``<= t``, ``(B, S, m)``. The JAX package sums a ``(B, S, m, R)``
    comparison for it; a binary search needs no such temporary."""
    t = torch.arange(m, device=o.device, dtype=o.dtype)
    return torch.searchsorted(o.contiguous(), t.expand(*o.shape[:-1], m).contiguous(),
                              right=True)


def grid_window(c: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, starts: torch.Tensor,
                pts_s: torch.Tensor, g: int, r: int, m: int):
    """Each centroid's candidate window: the ``(2r+1)^3`` cell cube around
    its cell, ``(2r+1)^2`` contiguous runs of the sorted points laid end to
    end in ``m`` slots. Returns the centroids' cells ``(B,S,3)``, the
    window's sorted positions ``(B,S,m)`` (0 in empty slots), the cube's
    point count ``(B,S)`` and the difference-form distances ``(B,S,m)``
    (``+inf`` in empty slots)."""
    B, S, _ = c.shape
    ccell = _cells(c, lo, h, g)  # (B,S,3)
    offs = torch.arange(-r, r + 1, dtype=torch.int32, device=c.device)
    dx = offs.repeat_interleave(2 * r + 1)  # (R2,)
    dy = offs.repeat(2 * r + 1)
    cx = ccell[..., 0:1] + dx  # (B,S,R2)
    cy = ccell[..., 1:2] + dy
    in_range = (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g)
    z0 = (ccell[..., 2:3] - r).clamp_min(0)
    z1 = (ccell[..., 2:3] + r).clamp_max(g - 1)
    base = (cx.clamp(0, g - 1) * g + cy.clamp(0, g - 1)) * g
    runs = starts[:, None, :].expand(B, S, -1)
    run_s = torch.gather(runs, 2, (base + z0).long())
    run_e = torch.gather(runs, 2, (base + z1 + 1).long())
    lens = torch.where(in_range, run_e - run_s, torch.zeros_like(run_s))
    o = lens.cumsum(-1)
    total = o[..., -1]  # (B,S) candidates in the cube
    prev = o - lens
    t = torch.arange(m, device=c.device)
    jc = run_of_slot(o, m).clamp_max(lens.shape[-1] - 1)
    idx_sorted = torch.gather(run_s, 2, jc) + t - torch.gather(prev, 2, jc)
    valid = t < total[..., None]
    idx_sorted = torch.where(valid, idx_sorted, torch.zeros_like(idx_sorted))
    diff = index_points(pts_s, idx_sorted) - c[:, :, None, :]  # (B,S,m,3)
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    return ccell, idx_sorted, total, d


def grid_pruned_core(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-pruned candidate selection without the fallback: ``(idx (B,S,K)
    int32, ok ()`` bool tensor``)``, ``ok`` the batch's exactness certificate
    (:func:`grid_pruned_knn`). The JAX package's ``_grid_pruned_core``, with
    the K-smallest selection through the ``topk_min`` kernel."""
    from . import cuda_kernels as K

    B, N, _ = xyz.shape
    g, r = _KNN_GRID_G, _KNN_GRID_R
    m = max(min(_KNN_GRID_M, N), nsample)  # the window holds at least K slots
    x, c = xyz.float(), new_xyz.float()
    lo, h, order, pts_s, starts = grid_bins(x, g)
    ccell, idx_sorted, total, d = grid_window(c, lo, h, starts, pts_s, g, r, m)
    sel = K.topk_min(d.contiguous(), nsample).long()  # (B,S,K) window slots
    idx_in_sorted = torch.gather(idx_sorted, 2, sel)
    idx = torch.gather(order[:, None, :].expand(B, c.shape[1], N), 2, idx_in_sorted)

    d_k = torch.gather(d, 2, sel[..., -1:])[..., 0]  # (B,S) the K-th distance
    cube_lo = lo + (ccell - r).float() * h
    cube_hi = lo + (ccell + r + 1).float() * h
    inf = torch.full_like(c, float("inf"))
    m_lo = torch.where(ccell - r <= 0, inf, c - cube_lo)
    m_hi = torch.where(ccell + r + 1 >= g, inf, cube_hi - c)
    margin = torch.minimum(m_lo, m_hi).amin(-1)  # (B,S)
    ok = ((d_k <= margin * margin) & (total <= m) & (total >= nsample)).all()
    return idx.to(torch.int32), ok


def grid_pruned_knn(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Exact kNN with spatial candidate pruning (the JAX package's
    ``_grid_pruned_knn``): bin the cloud into a ``G^3`` grid, rescore the
    cell cube around each centroid (``grid_window``), keep its K nearest
    (``topk_min``). Every point outside the cube lies at least ``margin``
    from the centroid, so ``d_K <= margin^2`` proves the K nearest are
    inside. If any centroid fails that, or its cube holds more than M or
    fewer than K points, the whole batch takes :func:`exact_full_knn`. The
    JAX package decides with a ``lax.cond`` on the device. Eagerly the
    certificate is read on the host, one device-to-host sync per grid
    stage (so a grid stage cannot be captured in a CUDA graph), and only
    the branch taken runs. Under ``torch.export`` the batch branches in
    the program, with ``torch.cond`` as the JAX package's ``lax.cond``:
    both branches give ``(B, S, K)`` int32 (the pruned ``idx`` is copied,
    as a branch may not return its operand)."""
    idx, ok = grid_pruned_core(new_xyz, xyz, nsample)
    if torch.compiler.is_exporting():
        return torch.cond(
            ok,
            lambda i, c, x: i.clone(),
            lambda i, c, x: exact_full_knn(c, x, nsample).to(torch.int32),
            (idx, new_xyz, xyz))
    if bool(ok):
        return idx
    return exact_full_knn(new_xyz, xyz, nsample)


def ball_query_matmul_form(n: int) -> bool:
    """Whether the JAX package's ball query on the TPU measures a cloud of
    ``n`` points in the matmul form (its XLA path) rather than the
    difference form (``ball_query_pallas``, ``BALL_KERNEL_MIN_N <= n <=
    KNN_KERNEL_MAX_N``)."""
    return not BALL_KERNEL_MIN_N <= n <= KNN_KERNEL_MAX_N


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Radius ball query ``(B, S, nsample)`` int32 through the ball-query
    kernel, in the distance form the JAX package uses on the TPU at this
    cloud size (:func:`ball_query_matmul_form`): the smallest in-radius
    indices, ascending, padded with the first; N - 1 where none lies in the
    radius. Argument order as in the JAX package."""
    from . import cuda_kernels as K

    return K.ball_query(new_xyz.contiguous(), xyz.contiguous(), radius, nsample,
                        ball_query_matmul_form(xyz.shape[1]))


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Farthest-point sampling ``(B, npoint)`` int32 through the FPS kernel.
    Each cloud starts at index 0, or, with ``generator``, at an index drawn
    uniformly from it (``jax.random.randint`` there; the numbers differ)."""
    from . import batch_shard, cuda_kernels as K

    B, N, _ = xyz.shape
    if generator is None:
        seeds = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    else:
        seeds = batch_shard.draw(lambda shape: torch.randint(
            0, N, shape, generator=generator, device=xyz.device, dtype=torch.int32), B)
    return K.fps(xyz.contiguous(), seeds, npoint)


def topk_of_uniform(u: torch.Tensor, npoint: int) -> torch.Tensor:
    """Positions of the ``npoint`` largest entries of each row of ``u``, in
    the order of ``jax.lax.top_k``: descending, equal values by index."""
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :npoint]


def random_sample_indices(
    generator: torch.Generator, batch: int, n: int, npoint: int,
    device: torch.device | str,
) -> torch.Tensor:
    """Per-cloud random choice of ``npoint`` distinct indices out of ``n``:
    one uniform draw, then its top ``npoint``. Same distribution as the JAX
    function; the numbers differ because the generators differ."""
    from . import batch_shard

    u = batch_shard.draw(lambda shape: torch.rand(shape, generator=generator, device=device),
                         batch, n)
    return topk_of_uniform(u, npoint)


def sample_and_group(
    xyz: torch.Tensor,
    points: Optional[torch.Tensor],
    npoint: int,
    nsample: int,
    generator: Optional[torch.Generator] = None,
    sampling: str = "random",
    grouping: str = "knn",
    radius: float = 0.2,
    neighbor_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``npoint`` centroids and group ``nsample`` points for each.

    ``sampling``: ``"random"`` (needs ``generator``), ``"fps"`` (starts at
    index 0, or at a random index with ``generator``) or ``"first"``.
    ``grouping``: ``"knn"`` or ``"ball"`` (within ``radius``). Returns
    ``new_xyz (B,S,3)`` and the grouped ``[centered xyz | feats]``,
    ``(B,S,K,3+D)``, or ``(B,K,S,3+D)`` with ``neighbor_major``. kNN up to
    ``FUSED_GROUP_MAX_N`` points runs through the ``sa_group`` kernel
    wrapper unless the stage takes the approx or the grid path
    (:func:`approx_eligible`, :func:`grid_eligible`);
    otherwise the centroids, the indices (:func:`knn_indices` or
    :func:`ball_query`) and the rows are gathered apart, as the JAX
    package does (each wrapper takes its plain version for CPU tensors).
    bf16 ``points`` are widened to f32 in the grouped tensor, as the JAX
    package's grouping kernel and its concatenation do.
    """
    from . import cuda_kernels as K  # cuda_kernels imports this module

    B, N, _ = xyz.shape
    if grouping not in ("knn", "ball"):
        raise NotImplementedError(f"grouping={grouping!r}: only 'knn' and 'ball' are ported")
    if sampling == "random":
        if generator is None:
            raise ValueError("sampling='random' requires a torch.Generator")
        cidx = random_sample_indices(generator, B, N, npoint, xyz.device)
    elif sampling == "fps":
        cidx = farthest_point_sample(xyz, npoint, generator)
    elif sampling == "first":
        if npoint > N:
            raise ValueError(f"npoint={npoint} exceeds the {N} points")
        cidx = torch.arange(npoint, device=xyz.device).expand(B, npoint)
    else:
        raise NotImplementedError(
            f"sampling={sampling!r}: only 'first', 'random' and 'fps' are ported")
    cidx = cidx.to(torch.int32).contiguous()
    if grouping == "knn" and N <= FUSED_GROUP_MAX_N and not approx_eligible(N) \
            and not grid_eligible(N):
        if points is None:  # coordinates carry no parameters: nothing to differentiate
            new_xyz, grouped, _ = K.sa_group(xyz.contiguous(), None, cidx, nsample)
        else:
            new_xyz, grouped, _ = K.SAGroupFeatsFn.apply(
                xyz.contiguous(), points.contiguous(), cidx, nsample)
        return new_xyz, (grouped if neighbor_major else grouped.transpose(1, 2))

    new_xyz = index_points(xyz, cidx)
    if grouping == "knn":
        idx = knn_indices(new_xyz, xyz, nsample)
    else:
        idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]  # (B,S,K,3)
    if points is not None:
        grouped = torch.cat([grouped, index_points(points, idx).to(grouped.dtype)], dim=-1)
    return new_xyz, (grouped.transpose(1, 2) if neighbor_major else grouped)


def group_all(
    xyz: torch.Tensor, points: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole cloud as one group: ``(B,1,3)`` zeros and ``(B,1,N,3+D)``
    with the coordinates NOT centered (the reference's group-all branch);
    bf16 ``points`` are widened to f32, as the JAX concatenation promotes
    them."""
    B = xyz.shape[0]
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None].to(xyz.dtype)], dim=-1)
    return new_xyz, grouped
