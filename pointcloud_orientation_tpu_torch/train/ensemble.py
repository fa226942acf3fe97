"""The per-label protocol trained in lockstep: every label's model, epoch by epoch.

Counterpart of ``pointcloud_orientation_tpu/train/ensemble.py``
(``run_per_label_vmapped``). The reference's canonical protocol
(``train.py:250-276``) trains one model per category; the JAX package runs
the L models as one ``jax.vmap``\\ ped program. ``torch.func.vmap`` cannot
map over the port's kernels (``torch.autograd.Function``\\ s over ctypes
launches, with no batching rule), so the port trains the L members in
lockstep instead (:func:`run_lockstep`): each epoch runs every member's
:meth:`.trainer.Trainer.fit` over that one epoch, member by member, then
saves and polls for preemption. A member's epoch so takes the path its
sequential run takes (a block of one epoch on the resident splits, with
the best val chosen on the device in float32 as the JAX protocols' block
program chooses it; the step path under ``host_resident`` or
``debug_checks``). L members cost L times the launches of one,
and the lockstep is no faster than the sequential ``run_per_label``
(``train/run.py``): it exists so that every member stands at the same epoch
when the protocol's one ``step_<E>`` checkpoint is written. A launch over
stacked members is untried (ROADMAP.md).

The JAX contract holds in its strongest form: each member is a
:class:`.trainer.Trainer` of its own, seeded as its sequential run, so its
result is bit-equal to that run and does not depend on which members train
beside it or in which slot. With unequal label subsets each member runs its
own epoch's steps: no member shares a program with another, so there is
nothing to pad and no empty step to freeze, as the JAX package must.
Periodic saves land on ``checkpoint_every`` multiples, a preemption save
at the epoch where the guard fired, and ``resume_from`` reproduces the
uninterrupted run exactly.

With a mesh the members go over its first axis, as the JAX package shards
its member axis: a rank trains its consecutive ``L/n`` members in lockstep
(:func:`member_rows`), each on the rank's device; the saves gather every
rank's members into the one checkpoint (``protocol_ckpt.py``) and the
results are gathered, so every rank returns all of them and only the
first writes files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ..data.dataset import OrientationDataset
from .metrics import write_summary_txt
from .protocol_ckpt import checkpoint_and_maybe_stop, gather_members, resume_protocol
from .trainer import Trainer


def member_rows(mesh, n: int, what: str):
    """``(rows, group, writes)``: this rank's consecutive members of ``n``
    over the mesh's first axis, the axis's group and whether this rank
    writes the files (all of them, the group None and True, without a
    mesh). The JAX package's ``ValueError`` when ``n`` does not divide over
    the axis."""
    if mesh is None:
        return slice(0, n), None, True
    axis = mesh.mesh_dim_names[0]
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"{what} count {n} must divide over mesh axis '{axis}' of size {size}")
    k, r = n // size, mesh.get_local_rank(axis)
    return slice(r * k, (r + 1) * k), mesh.get_group(axis), r == 0


def run_lockstep(trainers: List[Trainer], keys: Sequence, epochs: int, checkpoint_every: int,
                 log_every: int, what: str, checkpoint_dir: Optional[str] = None,
                 resume_from: Optional[str] = None, preemption_guard=None,
                 group=None, all_keys: Optional[Sequence] = None, rows: Optional[slice] = None
                 ) -> Optional[Dict[Any, dict]]:
    """Train the member ``trainers`` (one a key of ``keys``) from epoch 1,
    or from after ``resume_from``'s, to ``epochs`` in lockstep. After each
    epoch of every member, a save and the preemption poll
    (:func:`.protocol_ckpt.checkpoint_and_maybe_stop`). Returns the history
    by key (the rank's), or None when a preemption stopped the run early.
    With ``group`` the members are the rank's ``rows`` of ``all_keys``."""
    if resume_from:
        first = resume_protocol(resume_from, trainers, all_keys or keys, rows)[2]
    else:
        first = 1
    for epoch in range(first, epochs + 1):
        t0 = time.perf_counter()
        for t in trainers:
            t.fit(epochs=epoch, start_epoch=epoch, log_every=0)
        dt = time.perf_counter() - t0
        if log_every and (epoch % log_every == 0 or epoch == epochs):
            n_clouds = sum(len(t.train_ds) for t in trainers)
            print(f"Ep {epoch:03}/{epochs} x {len(trainers)} {what}  {dt:.3f}s/ep  "
                  f"({n_clouds / max(dt, 1e-9):.0f} clouds/s across {what})", flush=True)
        history = {k: t.history for k, t in zip(keys, trainers)}
        if checkpoint_and_maybe_stop(epoch, epochs, trainers, history, keys, checkpoint_dir,
                                     checkpoint_every, preemption_guard, group):
            return None
    return {k: t.history for k, t in zip(keys, trainers)}


def run_per_label_vmapped(
    cfg,
    dataset: OrientationDataset,
    out_dir: Optional[str] = None,
    labels: Optional[Sequence[str]] = None,
    log_every: int = 50,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    preemption_guard=None,
    device: str = "cuda",
    fused_mlp_train: bool = False,
    **model_kwargs: Any,
) -> Optional[Dict[str, dict]]:
    """Train one model per label, the labels in lockstep (the name is the
    JAX package's). ``cfg`` with ``classes=(label,)`` and ``per_label=False``
    trains each label's subset of ``dataset`` (``labels``: the dataset's
    class names by default) on ``device``; ``fused_mlp_train`` and
    ``model_kwargs`` go to each :class:`.trainer.Trainer`. ``mesh``: the
    labels over its first axis (module docstring; the label count must
    divide over it).

    Reliability, as the sequential ``Trainer.fit``'s: ``checkpoint_dir``
    with ``cfg.checkpoint_every`` saves every member on its multiples
    (``train/protocol_ckpt.py``); a fired ``preemption_guard`` saves and
    returns None; ``resume_from`` (a ``step_<E>`` directory) restores and
    continues, reproducing the uninterrupted run exactly.

    Returns ``{label: {"best_val", "best_val_epoch", "test_loss",
    "test_angular", "history"}}`` and, with ``out_dir``, writes
    ``summary.txt`` (each label's best val loss) and ``<label>/metrics.json``
    with the JAX package's keys.
    """
    labels = list(labels if labels is not None else dataset.class_names)
    rows, group, writes = member_rows(mesh, len(labels), "label")
    sub_cfg = cfg.replace(classes=(labels[0],), per_label=False)
    t_start = time.time()
    trainers = [Trainer(sub_cfg.replace(classes=(label,)), dataset.select_classes([label]),
                        device=device, fused_mlp_train=fused_mlp_train, **model_kwargs)
                for label in labels[rows]]
    history = run_lockstep(trainers, labels[rows], sub_cfg.epochs, cfg.checkpoint_every,
                           log_every, "labels", checkpoint_dir, resume_from, preemption_guard,
                           group, labels, rows)
    if history is None:
        return None
    local = []
    for label, t in zip(labels[rows], trainers):
        test = t.test()  # each label's best-val weights
        local.append((label, {"best_val": float(t.best_val),
                              "best_val_epoch": int(t.best_val_epoch or 0),
                              "test_loss": test.mean_loss,
                              "test_angular": test.mean_angular_error,
                              "history": history[label]}))
    results = dict(gather_members(local, group))
    wall = time.time() - t_start
    if out_dir and writes:
        os.makedirs(out_dir, exist_ok=True)
        write_summary_txt(os.path.join(out_dir, "summary.txt"),
                          {label: results[label]["best_val"] for label in labels})
        for label in labels:
            ldir = os.path.join(out_dir, label)
            os.makedirs(ldir, exist_ok=True)
            payload = {
                "config": dataclasses.asdict(sub_cfg.replace(classes=(label,))),
                "history": results[label]["history"],
                "best_val": results[label]["best_val"],
                "best_val_epoch": results[label]["best_val_epoch"],
                "test": {"loss": results[label]["test_loss"],
                         "mean_angular_error_deg": results[label]["test_angular"]},
                "vmapped_protocol": {"labels": len(labels), "wall_seconds": wall},
            }
            with open(os.path.join(ldir, "metrics.json"), "w") as f:
                json.dump(payload, f, indent=2, default=float)
    return results
