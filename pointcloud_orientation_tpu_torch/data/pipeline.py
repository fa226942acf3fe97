"""Batch pipeline on the device: subsample -> rotate -> every target.

Counterpart of ``pointcloud_orientation_tpu/data/pipeline.py``: one function
produces the augmented clouds and all orientation targets (axes, forward,
8-direction soft label, single-peak von Mises, mixture of von Mises) from a
yaw, SO(3) or identity rotation. Random draws come from an explicit
``torch.Generator``: subsample uniforms first, then the rotation's draws.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.geometry import topk_of_uniform
from ..ops.rotations import (
    axes_gt_from_rotation,
    random_so3_matrix,
    random_yaw_matrix,
    rotate_points,
)
from .gt import KAPPA_DEFAULT, eight_dir_gt, mvm_gt, single_peak_gt


def subsample_by_uniform(pts: torch.Tensor, u: torch.Tensor, num_points: int) -> torch.Tensor:
    """The points at the ``num_points`` largest entries of each row of the
    uniforms ``u (B, M)``, in ``jax.lax.top_k``'s order."""
    idx = topk_of_uniform(u, num_points)
    return torch.gather(pts, 1, idx[:, :, None].expand(-1, -1, pts.shape[-1]))


def subsample_points(generator: torch.Generator, pts: torch.Tensor, num_points: int
                     ) -> torch.Tensor:
    """Random per-cloud subsample of ``num_points`` from ``pts (B, M, 3)``
    without replacement: one uniform draw and its top ``num_points``. The
    trainer never asks for more points than the clouds hold (the JAX
    function's with-replacement branch for that case is not ported)."""
    B, M, _ = pts.shape
    if M < num_points:
        raise ValueError(f"{num_points} points asked of clouds of {M}")
    if M == num_points:
        return pts
    u = torch.rand((B, M), generator=generator, device=pts.device)
    return subsample_by_uniform(pts, u, num_points)


ROTATION_MODES = ("yaw", "so3", "none")


def random_rotation(generator: torch.Generator, batch: int, rotation_mode: str,
                    device: torch.device | str) -> torch.Tensor:
    """``(B, 3, 3)`` rotations of ``rotation_mode``: ``"yaw"`` (about +y),
    ``"so3"`` (Euler angles, :func:`random_so3_matrix`) or ``"none"`` (the
    identity, no draw)."""
    if rotation_mode == "yaw":
        return random_yaw_matrix(generator, batch, device)
    if rotation_mode == "so3":
        return random_so3_matrix(generator, batch, device)
    if rotation_mode == "none":
        return torch.eye(3, device=device).expand(batch, 3, 3)
    raise ValueError(f"unknown rotation_mode: {rotation_mode}")


def rotate_batch(pts: torch.Tensor, rot: torch.Tensor, uniform_mask: torch.Tensor,
                 symm_mask: torch.Tensor, k_spec: torch.Tensor,
                 kappa_default: float = KAPPA_DEFAULT, max_k: int = 4
                 ) -> Dict[str, torch.Tensor]:
    """Rotate the subsampled clouds ``pts (B, N, 3)`` by ``rot (B, 3, 3)``
    and synthesize every target from ``rot``: the dict of
    :func:`augment_batch`. The seam where a caller gives the rotation."""
    pts = rotate_points(pts, rot)
    axes = axes_gt_from_rotation(rot)
    side, forward = axes[:, 0], axes[:, 2]
    vm_mu, vm_kappa = single_peak_gt(forward, symm_mask, kappa_default)
    mvm_mu, mvm_kappa, mvm_w, mvm_k = mvm_gt(side, forward, k_spec, kappa_default, max_k)
    return {
        "points": pts,
        "rotation": rot,
        "axes": axes,
        "forward": forward,
        "probs_8dir": eight_dir_gt(forward, uniform_mask),
        "vm_mu": vm_mu,
        "vm_kappa": vm_kappa,
        "mvm_mu": mvm_mu,
        "mvm_kappa": mvm_kappa,
        "mvm_weight": mvm_w,
        "mvm_k": mvm_k,
    }


def augment_batch(generator: torch.Generator, pts: torch.Tensor, uniform_mask: torch.Tensor,
                  symm_mask: torch.Tensor, k_spec: torch.Tensor, num_points: int,
                  rotation_mode: str = "yaw", kappa_default: float = KAPPA_DEFAULT,
                  max_k: int = 4) -> Dict[str, torch.Tensor]:
    """Subsample, rotate, and synthesize every target.

    ``pts (B, M, 3)`` canonical clouds; ``uniform_mask``, ``symm_mask``
    (bool) and ``k_spec`` (int) ``(B,)``, the per-sample class behaviour
    (see :func:`.gt.class_masks`). ``rotation_mode``: ``"yaw"`` (the 2D
    tasks), ``"so3"`` (the 3D tasks) or ``"none"``. Returns ``points
    (B,N,3)``, ``rotation (B,3,3)``, ``axes (B,3,3)`` (side, up, forward
    rows), ``forward (B,3)``, ``probs_8dir (B,8)``, ``vm_mu``/``vm_kappa
    (B,)``, ``mvm_mu``/``mvm_kappa``/``mvm_weight (B, max_k)`` and ``mvm_k
    (B,)``.
    """
    if rotation_mode not in ROTATION_MODES:
        raise ValueError(f"unknown rotation_mode: {rotation_mode}")
    pts = subsample_points(generator, pts, num_points)
    rot = random_rotation(generator, pts.shape[0], rotation_mode, pts.device)
    return rotate_batch(pts, rot, uniform_mask, symm_mask, k_spec, kappa_default, max_k)
