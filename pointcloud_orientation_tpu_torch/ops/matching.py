"""Exact minimum-cost assignment of small mixtures, on the device.

Counterpart of ``pointcloud_orientation_tpu/ops/matching.py``: for K <= 4
the optimum is found by enumerating all ``K!`` permutations with a batched
argmin (equal totals to the first permutation in ``itertools.permutations``
order), and the matched mixture-of-von-Mises loss takes its gradient through
the matched costs and the weights only, as the reference detaches its
Hungarian assignment.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from .von_mises import kl_von_mises

_PERMS: Dict[Tuple[int, str], torch.Tensor] = {}  # (K, device) -> (K!, K) int64


def _perms(k: int, device: torch.device) -> torch.Tensor:
    """All permutations of ``range(k)`` as ``(k!, k)``, built once as numpy
    and moved to ``device`` once."""
    key = (k, str(device))
    if key not in _PERMS:
        table = np.asarray(list(itertools.permutations(range(k))), dtype=np.int64)
        _PERMS[key] = torch.from_numpy(table).to(device)
    return _PERMS[key]


def hungarian_small(cost: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimum-cost assignment of a batched ``(B, K, K)`` cost matrix over
    the top-left ``k[b] x k[b]`` block of each sample (rows and columns
    beyond it are ignored; its rows map to themselves). Returns ``(col
    (B, K) int32, total (B,))``: ``col[b, i]`` the column matched to row
    ``i``, ``total`` the matched cost over the block (0 where ``k <= 0``)."""
    B, K, _ = cost.shape
    perms = _perms(K, cost.device)  # (P, K)
    rows = torch.arange(K, device=cost.device)
    valid_row = rows[None, :] < k[:, None]  # (B, K)
    # a permutation is admissible for sample b iff it maps {0..k-1} onto itself
    perm_ok = (~valid_row[:, None, :] | (perms[None] < k[:, None, None])).all(-1)  # (B, P)
    gathered = cost[:, rows[None, :], perms]  # (B, P, K): cost[b, i, perms[p, i]]
    masked = torch.where(valid_row[:, None, :], gathered, torch.zeros_like(gathered))
    totals = masked.sum(-1)
    totals = torch.where(perm_ok, totals, torch.full_like(totals, float("inf")))
    best = torch.argmin(totals, dim=-1)  # the first of equal totals
    col = torch.where(valid_row, perms[best], rows[None, :])
    total = torch.gather(totals, 1, best[:, None])[:, 0]
    total = torch.where(k > 0, total, torch.zeros_like(total))
    return col.to(torch.int32), total


def matched_mvm_loss(mu_pred: torch.Tensor, kappa_pred: torch.Tensor, w_pred: torch.Tensor,
                     mu_gt: torch.Tensor, kappa_gt: torch.Tensor, k_gt: torch.Tensor,
                     unmatched_penalty: float = 0.0) -> torch.Tensor:
    """Hungarian-matched, weight-normalised mixture-of-von-Mises KL, per
    sample ``(B,)``: ``cost[i, j] = KL(pred_i || gt_j)`` with non-finite
    entries set to 1e6; the assignment minimising the unweighted cost over
    the first ``k`` peaks (detached); then ``sum_i w_i cost[i, match(i)] /
    (sum_i w_i + 1e-8)`` over ``i < k``, plus ``unmatched_penalty * (1 -
    sum_{i<k} w_i)`` when the penalty is set; 0 where ``k <= 0``."""
    K = mu_pred.shape[1]
    cost = kl_von_mises(mu_pred[:, :, None], kappa_pred[:, :, None],
                        mu_gt[:, None, :], kappa_gt[:, None, :])
    cost = torch.nan_to_num(cost, nan=1e6, posinf=1e6, neginf=1e6)
    col, _ = hungarian_small(cost.detach(), k_gt)
    matched = torch.gather(cost, 2, col.long()[:, :, None])[..., 0]  # (B, K)
    valid = torch.arange(K, device=mu_pred.device)[None, :] < k_gt[:, None]
    w_valid = torch.where(valid, w_pred, torch.zeros_like(w_pred))
    ws_sum = w_valid.sum(-1)
    loss = (w_valid * torch.where(valid, matched, torch.zeros_like(matched))).sum(-1) / (
        ws_sum + 1e-8)
    if unmatched_penalty:
        loss = loss + unmatched_penalty * (1.0 - ws_sum)
    return torch.where(k_gt > 0, loss, torch.zeros_like(loss))
