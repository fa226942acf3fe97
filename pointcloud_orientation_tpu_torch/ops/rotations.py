"""Yaw rotations, point-cloud rotation and orientation ground truth.

Counterpart of ``pointcloud_orientation_tpu/ops/rotations.py`` (yaw only;
SO(3) sampling is not ported yet) and of ``wrap_angle`` from its
``ops/von_mises.py``. Random draws come from an explicit
``torch.Generator``, so the numbers differ from ``jax.random``'s; the
distributions are the same.
"""

from __future__ import annotations

import math

import torch

# Canonical object axes in ModelNet40's frame: rows are (side, up, forward).
CANONICAL_AXES = torch.tensor(
    [[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], dtype=torch.float32)


def yaw_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about the vertical (+y) axis; ``theta (...,) -> (..., 3, 3)``."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([
        torch.stack([c, z, s], dim=-1),
        torch.stack([z, o, z], dim=-1),
        torch.stack([-s, z, c], dim=-1),
    ], dim=-2)


def random_yaw_matrix(generator: torch.Generator, batch: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Random yaw-only rotations, ``theta ~ U[0, 2 pi)``; returns (B, 3, 3)."""
    theta = torch.rand((batch,), generator=generator, device=device) * (2.0 * math.pi)
    return yaw_matrix(theta)


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``p' = R p`` for every point of ``points (B,N,3)``, ``rot (B,3,3)``."""
    return torch.einsum("bij,bnj->bni", rot, points)


def axes_gt_from_rotation(rot: torch.Tensor) -> torch.Tensor:
    """Ground-truth axes rows (side, up, forward) ``(B,3,3)``:
    ``row_a = R @ canonical_axis_a``, unit-normalized."""
    axes = torch.einsum("bij,aj->bai", rot, CANONICAL_AXES.to(rot.device, rot.dtype))
    norm = torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    return axes / torch.where(norm > 1e-6, norm, torch.ones_like(norm))


def forward_to_mu(forward: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Yaw angle of a forward vector, ``atan2(fx, -fz)`` of its x-z
    projection; a near-vertical forward gives 0."""
    fx, fz = forward[..., 0], forward[..., 2]
    degenerate = torch.hypot(fx, fz) < eps
    fx = torch.where(degenerate, torch.zeros_like(fx), fx)
    fz = torch.where(degenerate, -torch.ones_like(fz), fz)
    return torch.atan2(fx, -fz)


def wrap_angle(delta: torch.Tensor) -> torch.Tensor:
    """Wrap an angle difference to ``[-pi, pi)``: ``(d + pi) mod 2 pi - pi``."""
    return torch.remainder(delta + math.pi, 2.0 * math.pi) - math.pi
