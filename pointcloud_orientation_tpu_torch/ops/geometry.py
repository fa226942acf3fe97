"""Point-cloud geometry for the PointNet++ serving and training paths, in PyTorch.

Counterpart of ``pointcloud_orientation_tpu/ops/geometry.py`` for the modes
the ported slices run: ``first`` or ``random`` centroids, exact kNN
grouping, neighbour-major layout. Every other mode raises.

Distances are the elementwise ``c2 - 2*c.x + x2`` sequence in one fixed
order (no ``bmm``, no ``cdist``), the same sequence the CUDA grouping kernel
computes, so the two agree bit for bit on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Largest cloud the fused grouping kernel takes: its N distances must fit in
# 48 KB of shared memory. The JAX package switches to another kernel above
# this size (``_FUSED_GROUP_MAX_N`` there), which this port does not have.
FUSED_GROUP_MAX_N = 10_240


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


def knn_query(new_xyz: torch.Tensor, xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Indices ``(B, S, nsample)`` int64 of the nearest points, nearest first,
    equal distances to the lowest index (a stable sort of the distances)."""
    if nsample > xyz.shape[1]:
        raise ValueError(f"nsample={nsample} exceeds the {xyz.shape[1]} points")
    dist = square_distance(new_xyz, xyz)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :nsample]


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
    neighbor_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``npoint`` centroids and group their ``nsample`` nearest points.

    Returns ``new_xyz (B,S,3)`` and the grouped ``[centered xyz | feats]``,
    ``(B,S,K,3+D)``, or ``(B,K,S,3+D)`` with ``neighbor_major``. Grouping
    runs through the ``sa_group`` kernel wrapper (its plain version for CPU
    tensors).
    """
    from . import cuda_kernels as K  # cuda_kernels imports this module

    B, N, _ = xyz.shape
    if grouping != "knn":
        raise NotImplementedError(f"grouping={grouping!r}: only 'knn' is ported")
    if sampling == "random":
        if generator is None:
            raise ValueError("sampling='random' requires a torch.Generator")
        cidx = random_sample_indices(generator, B, N, npoint, xyz.device)
    elif sampling == "first":
        if npoint > N:
            raise ValueError(f"npoint={npoint} exceeds the {N} points")
        cidx = torch.arange(npoint, device=xyz.device).expand(B, npoint)
    else:
        raise NotImplementedError(f"sampling={sampling!r}: only 'first' and 'random' are ported")
    cidx = cidx.to(torch.int32).contiguous()
    if points is None:  # coordinates carry no parameters: nothing to differentiate
        new_xyz, grouped, _ = K.sa_group(xyz.contiguous(), None, cidx, nsample)
    else:
        new_xyz, grouped, _ = K.SAGroupFeatsFn.apply(
            xyz.contiguous(), points.contiguous(), cidx, nsample)
    if not neighbor_major:
        grouped = grouped.transpose(1, 2)
    return new_xyz, grouped


def group_all(
    xyz: torch.Tensor, points: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole cloud as one group: ``(B,1,3)`` zeros and ``(B,1,N,3+D)``
    with the coordinates NOT centered (the reference's group-all branch)."""
    B = xyz.shape[0]
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped
