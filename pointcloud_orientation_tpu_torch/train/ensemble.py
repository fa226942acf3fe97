"""The per-label protocol trained in lockstep: every label's model, epoch by epoch.

Counterpart of ``pointcloud_orientation_tpu/train/ensemble.py``
(``run_per_label_vmapped``). The reference's canonical protocol
(``train.py:250-276``) trains one model per category; the JAX package runs
the L models as one ``jax.vmap``\\ ped program. ``torch.func.vmap`` cannot
map over the port's kernels (``torch.autograd.Function``\\ s over ctypes
launches, with no batching rule), so the port trains the L members in
lockstep instead (:func:`run_lockstep`): each epoch runs every member's
stepwise epoch (:meth:`.trainer.Trainer.run_epoch`), member by member, then
saves and polls for preemption. L members cost L times the launches of one,
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
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ..data.dataset import OrientationDataset
from .metrics import write_summary_txt
from .protocol_ckpt import checkpoint_and_maybe_stop, resume_protocol
from .trainer import Trainer


def run_lockstep(trainers: List[Trainer], keys: Sequence, epochs: int, checkpoint_every: int,
                 log_every: int, what: str, checkpoint_dir: Optional[str] = None,
                 resume_from: Optional[str] = None, preemption_guard=None
                 ) -> Optional[Dict[Any, dict]]:
    """Train the member ``trainers`` (one a key of ``keys``) from epoch 1,
    or from after ``resume_from``'s, to ``epochs`` in lockstep. After each
    epoch of every member, a save and the preemption poll
    (:func:`.protocol_ckpt.checkpoint_and_maybe_stop`). Returns the history
    by key, or None when a preemption stopped the run early."""
    first = resume_protocol(resume_from, trainers, keys)[2] if resume_from else 1
    for epoch in range(first, epochs + 1):
        t0 = time.perf_counter()
        for t in trainers:
            t.run_epoch(epoch)
        dt = time.perf_counter() - t0
        if log_every and (epoch % log_every == 0 or epoch == epochs):
            n_clouds = sum(len(t.train_ds) for t in trainers)
            print(f"Ep {epoch:03}/{epochs} x {len(trainers)} {what}  {dt:.3f}s/ep  "
                  f"({n_clouds / max(dt, 1e-9):.0f} clouds/s across {what})", flush=True)
        history = {k: t.history for k, t in zip(keys, trainers)}
        if checkpoint_and_maybe_stop(epoch, epochs, trainers, history, keys, checkpoint_dir,
                                     checkpoint_every, preemption_guard):
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
    ``model_kwargs`` go to each :class:`.trainer.Trainer`. ``mesh`` is not
    ported (``NotImplementedError``).

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
    if mesh is not None:
        raise NotImplementedError("mesh is not ported: the port trains on one device")
    labels = list(labels if labels is not None else dataset.class_names)
    sub_cfg = cfg.replace(classes=(labels[0],), per_label=False)
    t_start = time.time()
    trainers = [Trainer(sub_cfg.replace(classes=(label,)), dataset.select_classes([label]),
                        device=device, fused_mlp_train=fused_mlp_train, **model_kwargs)
                for label in labels]
    history = run_lockstep(trainers, labels, sub_cfg.epochs, cfg.checkpoint_every, log_every,
                           "labels", checkpoint_dir, resume_from, preemption_guard)
    if history is None:
        return None
    results = {}
    for label, t in zip(labels, trainers):
        test = t.test()  # each label's best-val weights
        results[label] = {"best_val": float(t.best_val),
                          "best_val_epoch": int(t.best_val_epoch or 0),
                          "test_loss": test.mean_loss, "test_angular": test.mean_angular_error,
                          "history": history[label]}
    wall = time.time() - t_start
    if out_dir:
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
