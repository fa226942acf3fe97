"""Hold one train step's gradients through the kernels against the same
step through the kernels' plain versions, leaf by leaf.

Three kinds of leaf have a gradient that is zero in exact arithmetic, so
that both sides carry only rounding noise and a relative bound reads noise
against noise:
* an attention layer's key bias: it adds ``q . b`` to every score of a
  query's row alike, which the softmax removes. These leaves are left out
  (:func:`zero_gradient_leaves`).

* a Dense bias whose output a train-mode BatchNorm normalises (every
  shared-MLP layer's, the BatchNorm funnel's ``fc1``/``fc2``, and each
  ``DenseBN`` of the PointNet backbones, which name them in
  ``bn_fed_biases``): the batch mean removes it whatever the data. These
  leaves are left out.
* the shift of a group-all stage's last layer (``sa3.mlp.bns.2.bias``)
  where its pooled output feeds ``fc1`` and a train-mode BatchNorm: the
  BatchNorm centres ``fc1``'s gradient over the batch, so a shift that
  moves every pooled value of a channel alike gets a zero sum, but only
  while every pooled maximum is positive (a maximum that the ReLU clamps
  to 0 does not move with the shift). :func:`record_group_all` reads the
  pooled values of the step with a forward hook; where all are positive
  the leaf is held by an absolute bound, ``|g - g_plain| <= tol *
  |g_plain of the sibling scale leaf bns.2.weight|``, and otherwise by the
  relative bound of every other leaf.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterator, List, Set

import torch
from torch import nn

from ..models.layers import PointNetPPTrunk, SetAbstraction, SharedMLP
from ..models.point_transformer import MultiHeadAttention
from ..models.pointnet_pp import PointNetPPCls


def _group_all_stages(model: nn.Module) -> Dict[str, SetAbstraction]:
    """The group-all set abstractions (by module name) whose pooled output
    feeds fc1 and a train-mode BatchNorm."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, PointNetPPCls) or (isinstance(m, PointNetPPTrunk)
                                            and m.fc_norm == "batch"):
            out[f"{name}.sa3" if name else "sa3"] = m.sa3
    return out


def bias_leaves_feeding_batch_norm(model: nn.Module) -> Set[str]:
    """The Dense biases that a train-mode BatchNorm normalises, by
    parameter name: zero gradient in exact arithmetic on any data."""
    names = set()
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, SharedMLP):
            names.update(f"{prefix}linears.{i}.bias" for i in range(len(m.linears)))
        elif isinstance(m, PointNetPPCls) or (isinstance(m, PointNetPPTrunk)
                                              and m.fc_norm == "batch"):
            names.update((f"{prefix}fc1.bias", f"{prefix}fc2.bias"))
        elif hasattr(m, "bn_fed_biases"):
            names.update(prefix + n for n in m.bn_fed_biases())
    return names


def zero_gradient_leaves(model: nn.Module) -> Set[str]:
    """Every leaf left out of the comparison, by parameter name: the Dense
    biases that a train-mode BatchNorm normalises, and each attention
    layer's key bias (the softmax removes a shift shared by a row)."""
    names = bias_leaves_feeding_batch_norm(model)
    for mname, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            names.add(f"{mname}.key.bias" if mname else "key.bias")
    return names


def group_all_shift_leaves(model: nn.Module) -> Dict[str, str]:
    """Each group-all shift leaf whose gradient the BatchNorm after fc1
    zeroes when every pooled value is positive, and its sibling scale leaf
    (the bound's scale), by parameter name."""
    out = {}
    for stage, sa in _group_all_stages(model).items():
        last = len(sa.mlp.bns) - 1
        out[f"{stage}.mlp.bns.{last}.bias"] = f"{stage}.mlp.bns.{last}.weight"
    for mname, m in model.named_modules():
        if hasattr(m, "shift_biases"):
            prefix = f"{mname}." if mname else ""
            out.update({prefix + b: prefix + w for b, w in m.shift_biases().items()})
    return out


@contextlib.contextmanager
def record_group_all(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Within the block, every forward of a group-all stage of ``model``
    that feeds a train-mode BatchNorm appends its pooled output ``(B, 1,
    C)`` (detached) to the yielded list."""
    pooled: List[torch.Tensor] = []
    hooks = [sa.register_forward_hook(lambda mod, args, out: pooled.append(out[1].detach()))
             for sa in _group_all_stages(model).values()]
    try:
        yield pooled
    finally:
        for h in hooks:
            h.remove()


def pooled_all_positive(pooled: List[torch.Tensor]) -> bool:
    """The shift leaves' premise: at least one pooled tensor was read and
    every value in each is > 0."""
    return bool(pooled) and all(bool((p > 0).all()) for p in pooled)


def compare_grads(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], tol: float,
                  skip: Set[str], shifts: Dict[str, str], premise: bool) -> dict:
    """Every leaf of ``want`` but those in ``skip``, relative in norm,
    ``|g - w| / |w|``; a leaf of ``shifts`` where ``premise`` holds
    absolute, ``|g - w| / |w[sibling]|``. Returns the worst leaf, its
    error, each shift leaf's rule and error, the median error, whether all
    of ``got`` is finite, and ``ok``: finite and the worst error within
    ``tol``."""
    errs, rules = {}, {}
    for name, w in want.items():
        if name in skip:
            continue
        diff = float((got[name] - w).norm())
        if name in shifts and premise:
            errs[name] = diff / float(want[shifts[name]].norm().clamp_min(1e-30))
            rules[name] = "absolute"
        else:
            errs[name] = diff / float(w.norm().clamp_min(1e-30))
            if name in shifts:
                rules[name] = "relative"
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    return {"worst": worst, "norm_rel_err": errs[worst], "tol": tol, "finite": finite,
            "ok": finite and errs[worst] <= tol,
            "median_norm_rel_err": statistics.median(errs.values()),
            "group_all_shift": {n: {"rule": r, "err": errs[n]} for n, r in rules.items()},
            "pooled_all_positive": premise}
