"""Von Mises distribution math, in PyTorch.

Counterpart of ``pointcloud_orientation_tpu/ops/von_mises.py`` (``log_i0``,
``bessel_ratio``, ``wrap_angle``, ``kl_von_mises``, ``von_mises_pdf``): every
Bessel term goes through the exponentially scaled ``i0e``/``i1e``
(``torch.special``), so nothing overflows at large kappa. The moment matching
that the distribution heads' test-time augmentation needs is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch.special import i0e, i1e

from .rotations import wrap_angle

TWO_PI = 2.0 * math.pi

__all__ = ["TWO_PI", "bessel_ratio", "kl_von_mises", "log_i0", "von_mises_pdf", "wrap_angle"]


def log_i0(kappa: torch.Tensor) -> torch.Tensor:
    """``log I0(kappa)`` as ``log(i0e(kappa)) + kappa``."""
    return torch.log(i0e(kappa)) + kappa


def bessel_ratio(kappa: torch.Tensor) -> torch.Tensor:
    """``A(kappa) = I1(kappa) / I0(kappa)`` through the scaled Bessels."""
    return i1e(kappa) / i0e(kappa)


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
