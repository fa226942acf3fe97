"""Yaw and SO(3) rotations, point-cloud rotation and orientation ground truth.

Counterpart of ``pointcloud_orientation_tpu/ops/rotations.py`` and of
``wrap_angle`` from its ``ops/von_mises.py``. Random draws come from an explicit
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


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of ``(..., 3, 3)`` matrices written out elementwise in f32,
    ``(a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j``: no TF32 on the card, whatever
    the matmul settings (the JAX function multiplies at ``HIGHEST``)."""
    p = a[..., :, :, None] * b[..., None, :, :]  # (..., i, k, j)
    return (p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]


def so3_matrix(angles: torch.Tensor) -> torch.Tensor:
    """``R = Rz @ Ry @ Rx`` of the Euler angles ``angles (B, 3)`` = (tx, ty,
    tz); returns ``(B, 3, 3)``."""
    c, s = torch.cos(angles), torch.sin(angles)
    cx, cy, cz = c.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    z, o = torch.zeros_like(cx), torch.ones_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat((o, z, z), (z, cx, -sx), (z, sx, cx))
    ry = mat((cy, z, sy), (z, o, z), (-sy, z, cy))
    rz = mat((cz, -sz, z), (sz, cz, z), (z, z, o))
    return _matmul3(_matmul3(rz, ry), rx)


def random_so3_matrix(generator: torch.Generator, batch: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Random rotations :func:`so3_matrix` of Euler angles ~ U[0, 2 pi),
    drawn as one ``(B, 3)`` uniform; returns (B, 3, 3). Euler sampling is
    not Haar-uniform on SO(3); it is the reference's distribution."""
    angles = torch.rand((batch, 3), generator=generator, device=device) * (2.0 * math.pi)
    return so3_matrix(angles)


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
