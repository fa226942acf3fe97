"""Point-cloud geometry for the PointNet++ serving and training paths, in PyTorch.

Counterpart of ``pointcloud_orientation_tpu/ops/geometry.py``: ``first``,
``random`` or farthest-point (``fps``) centroids, exact kNN or radius ball
query (``ball``) grouping, neighbour-major layout. Other modes raise.

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
    from . import cuda_kernels as K

    B, N, _ = xyz.shape
    if generator is None:
        seeds = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    else:
        seeds = torch.randint(0, N, (B,), generator=generator, device=xyz.device,
                              dtype=torch.int32)
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
    u = torch.rand((batch, n), generator=generator, device=device)
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
    wrapper; otherwise the centroids, the indices (:func:`exact_full_knn`
    or :func:`ball_query`) and the rows are gathered apart, as the JAX
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
    if grouping == "knn" and N <= FUSED_GROUP_MAX_N:
        if points is None:  # coordinates carry no parameters: nothing to differentiate
            new_xyz, grouped, _ = K.sa_group(xyz.contiguous(), None, cidx, nsample)
        else:
            new_xyz, grouped, _ = K.SAGroupFeatsFn.apply(
                xyz.contiguous(), points.contiguous(), cidx, nsample)
        return new_xyz, (grouped if neighbor_major else grouped.transpose(1, 2))

    new_xyz = index_points(xyz, cidx)
    if grouping == "knn":
        idx = exact_full_knn(new_xyz, xyz, nsample)
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
