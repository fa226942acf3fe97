"""Von Mises distribution math, in PyTorch.

Counterpart of ``pointcloud_orientation_tpu/ops/von_mises.py`` (``log_i0``,
``bessel_ratio``, ``inv_bessel_ratio``, ``vm_mixture_moment_match``,
``wrap_angle``, ``kl_von_mises``, ``von_mises_pdf``,
``mixture_von_mises_pdf``): every Bessel term goes through the exponentially
scaled ``i0e``/``i1e`` (``torch.special``), so nothing overflows at large
kappa. The moment matching is what the von Mises head's test-time
augmentation (``infer.py``) folds the views with.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import torch
from torch.special import i0e, i1e

from .rotations import wrap_angle

TWO_PI = 2.0 * math.pi

__all__ = ["TWO_PI", "bessel_ratio", "inv_bessel_ratio", "kl_von_mises", "log_i0",
           "mixture_von_mises_pdf", "vm_mixture_moment_match", "von_mises_pdf", "wrap_angle"]


def log_i0(kappa: torch.Tensor) -> torch.Tensor:
    """``log I0(kappa)`` as ``log(i0e(kappa)) + kappa``."""
    return torch.log(i0e(kappa)) + kappa


def bessel_ratio(kappa: torch.Tensor) -> torch.Tensor:
    """``A(kappa) = I1(kappa) / I0(kappa)`` through the scaled Bessels."""
    return i1e(kappa) / i0e(kappa)


def inv_bessel_ratio(r: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """The ``kappa`` with ``A(kappa) = r``: Banerjee et al.'s (2005) seed
    ``r (2 - r^2) / (1 - r^2)`` refined by ``iters`` Newton steps with
    ``A'(k) = 1 - A/k - A^2``, its derivative held at or above 1e-6 and
    kappa at or above 0. ``r`` is clipped to ``[0, 1 - 1e-6]``; ``r = 0``
    gives ``kappa = 0``."""
    r = torch.clamp(r, 0.0, 1.0 - 1e-6)
    kappa = r * (2.0 - r * r) / torch.clamp_min(1.0 - r * r, 1e-12)
    for _ in range(iters):
        a = bessel_ratio(kappa)
        da = torch.clamp_min(1.0 - a / torch.clamp_min(kappa, 1e-12) - a * a, 1e-6)
        kappa = torch.clamp_min(kappa - (a - r) / da, 0.0)
    return kappa


def vm_mixture_moment_match(mu: torch.Tensor, kappa: torch.Tensor,
                            weight: Optional[torch.Tensor] = None, dim: int = -1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single von Mises with the first circular moment of the mixture
    of components along ``dim``: ``m1 = sum_k w_k A(kappa_k) e^{i mu_k}``,
    then ``mu* = arg m1`` and ``kappa* = A^-1(|m1|)``. ``weight=None`` is
    equal weights."""
    a = bessel_ratio(kappa)
    if weight is None:
        weight = torch.ones_like(mu) / mu.shape[dim]
    cr = (weight * a * torch.cos(mu)).sum(dim=dim)
    sr = (weight * a * torch.sin(mu)).sum(dim=dim)
    return torch.atan2(sr, cr), inv_bessel_ratio(torch.hypot(cr, sr))


def kl_von_mises(mu_p: torch.Tensor, kappa_p: torch.Tensor, mu_q: torch.Tensor,
                 kappa_q: torch.Tensor, kappa_min: float = 1e-6,
                 kappa_max: float = 500.0) -> torch.Tensor:
    """``KL(vM(mu_p, kappa_p) || vM(mu_q, kappa_q)) = log(I0(kq)/I0(kp)) +
    A(kp) * (kp - kq * cos(mu_p - mu_q))``, both kappas clamped to
    ``[kappa_min, kappa_max]`` and the mean difference wrapped."""
    kappa_p = kappa_p.clamp(kappa_min, kappa_max)
    kappa_q = kappa_q.clamp(kappa_min, kappa_max)
    a_p = bessel_ratio(kappa_p)
    delta = wrap_angle(mu_p - mu_q)
    log_ratio = log_i0(kappa_q) - log_i0(kappa_p)
    return log_ratio + a_p * (kappa_p - kappa_q * torch.cos(delta))


def von_mises_pdf(theta: torch.Tensor, mu: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """``exp(kappa cos(theta - mu)) / (2 pi I0(kappa))``, stable at any
    kappa; ``kappa = 0`` gives the uniform density ``1 / (2 pi)``."""
    return torch.exp(kappa * (torch.cos(theta - mu) - 1.0)) / (TWO_PI * i0e(kappa))


def mixture_von_mises_pdf(theta: torch.Tensor, mu: torch.Tensor, kappa: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """The mixture's density at ``theta (..., T)`` for components ``(...,
    K)``: the components broadcast over a trailing grid axis."""
    vm = von_mises_pdf(theta[..., None, :], mu[..., :, None], kappa[..., :, None])
    return (weight[..., :, None] * vm).sum(dim=-2)


def mvm_density_on_grid(mu: torch.Tensor, kappa: torch.Tensor, weight: torch.Tensor,
                        num: int = 360) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixture's density on ``num - 1`` angles covering ``[0, 2 pi)``
    (``linspace(0, 2 pi, num)[:-1]``): ``(theta (num - 1,), p (B, num -
    1))``, ``p`` normalized to sum to one (with a ``1e-8`` guard)."""
    theta = torch.linspace(0.0, TWO_PI, num, dtype=mu.dtype, device=mu.device)[:-1]
    p = mixture_von_mises_pdf(theta[None, :], mu, kappa, weight)
    return theta, p / (p.sum(dim=-1, keepdim=True) + 1e-8)
