"""Traffic made from the seed on the device: ModelNet40-shaped clouds and
the serving cells' request pool.

``clouds`` is the port's ``synthetic_modelnet`` stand-in (a box with a
class aspect ratio whose points lie on its faces, a forward "nose" cluster
on the -z face, centred, scaled to unit max-norm, 0.005 noise) rewritten in
torch, so that set-up draws every cloud in a few large calls on the card.
Class counts come from the configuration, and each cloud's points are put
in a random order, so that any prefix is a uniform subsample.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def clouds(class_counts: Sequence[Tuple[str, int]], num_points: int, seed: int,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
    """``(points (S, num_points, 3) f32, labels (S,) int64, class names)``
    on ``device``: ``class_counts`` clouds of each class, classes in the
    given order, drawn from one generator seeded with ``seed``."""
    names = [c for c, _ in class_counts]
    labels = torch.cat([torch.full((n,), i, dtype=torch.int64)
                        for i, (_, n) in enumerate(class_counts)]).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    S = labels.shape[0]
    n_nose = max(num_points // 10, 1)
    n_body = num_points - n_nose
    dims = (0.3 + 0.7 * torch.rand((len(names), 3), generator=g, device=device))[labels]
    body = (torch.rand((S, n_body, 3), generator=g, device=device) - 0.5) * dims[:, None]
    axis = torch.randint(0, 3, (S, n_body, 1), generator=g, device=device)
    sign = torch.randint(0, 2, (S, n_body, 1), generator=g, device=device).float() - 0.5
    face = sign * torch.gather(dims[:, None].expand(-1, n_body, -1), 2, axis)
    body.scatter_(2, axis, face)
    nose = torch.randn((S, n_nose, 3), generator=g, device=device) * 0.03
    nose[..., 2] -= dims[:, None, 2] * 0.5 + 0.15
    pts = torch.cat([body, nose], dim=1)
    pts -= pts.mean(dim=1, keepdim=True)
    pts /= pts.abs().amax(dim=(1, 2), keepdim=True) + 1e-8
    pts += torch.randn(pts.shape, generator=g, device=device) * 0.005
    order = torch.argsort(torch.rand((S, num_points), generator=g, device=device), dim=1)
    pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    return pts.contiguous(), labels, names


def spread(lo: int, hi: int, n: int, log: bool) -> np.ndarray:
    """``n`` whole numbers at the quantile midpoints of a uniform (or, with
    ``log``, log-uniform) distribution over ``[lo, hi]``: every seed gets
    the same sizes, in its own order."""
    q = (np.arange(n) + 0.5) / n
    if log:
        vals = np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))
    else:
        vals = lo + q * (hi + 1 - lo)
    return np.clip(np.floor(vals).astype(np.int64), lo, hi)


def request_pool(traffic: Dict, bank: torch.Tensor, seed: int) -> List[np.ndarray]:
    """The serving cell's requests, drawn in set-up: ``pool`` requests whose
    cloud counts and point counts are :func:`spread` over the traffic's
    ranges and shuffled by the seed; each request takes distinct clouds of
    ``bank`` drawn by the seed and the first points of each. Returned as the
    host arrays a client sends."""
    rng = np.random.default_rng(seed)
    n = traffic["pool"]
    sizes = rng.permutation(spread(*traffic["clouds"], n, traffic["clouds_log_uniform"]))
    points = rng.permutation(spread(*traffic["points"], n, False))
    pool = []
    for b, p in zip(sizes, points):
        rows = torch.from_numpy(rng.choice(bank.shape[0], int(b), replace=False)).to(bank.device)
        pool.append(bank.index_select(0, rows)[:, : int(p)])
    flat = torch.cat([r.reshape(-1) for r in pool]).cpu().numpy()
    out, off = [], 0
    for r in pool:
        out.append(flat[off: off + r.numel()].reshape(tuple(r.shape)))
        off += r.numel()
    return out


def arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """The times (s from the window's start) at which requests fall due: a
    Poisson stream at ``rate_per_s``, its gaps the exponential's quantile
    midpoints (every seed the same gaps, in its own order), enough of them
    to cover ``seconds``."""
    n = int(math.ceil(rate_per_s * seconds)) + 1
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_per_s
    return np.cumsum(np.random.default_rng(seed).permutation(gaps))
