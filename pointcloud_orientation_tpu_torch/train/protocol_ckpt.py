"""Checkpoint and resume of the lockstep protocols (per label, multi-seed).

Counterpart of ``pointcloud_orientation_tpu/train/protocol_ckpt.py``. The
protocols' carry is their list of member :class:`.trainer.Trainer`\\ s, and
it saves as one artifact at an epoch's end: every member's model,
optimizer and best-val state (:meth:`.trainer.Trainer.state_payload`) and
the protocol's history. A resumed run reproduces the uninterrupted one
exactly: each member's random draws are keyed by its seed and the absolute
epoch and step.

Layout per save: ``<dir>/step_<E>/carry.pt`` (``torch.save`` of
``{"members": [payload, ...], "configs": [asdict(config), ...]}``, written
as :func:`.trainer.write_torch_file` writes) and
``<dir>/step_<E>/history.json`` (the JAX file's keys: ``epoch``, ``keys``
and ``history``, one ``{train, val, train_ang, val_ang}`` a key). The JAX
package's own checkpoints keep their carry in Orbax (``step_<E>/carry``,
the eight fields of its ``_carry_to_np`` stacked on a member axis): the
port reads them too (:func:`read_protocol_carry`, without orbax), so a
protocol that the JAX package checkpointed resumes here and serves as an
ensemble (``OrientationPredictor.from_protocol_checkpoint``).

With a mesh the members are split over its first axis
(:func:`.ensemble.member_rows`): a save gathers every rank's members on the
axis's first rank, which writes the same layout in key order; a resume reads
the whole carry and keeps the rank's members.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.orbax_format import read_pytree
from .trainer import write_torch_file

# the fields of the JAX package's protocol carry (its ``_carry_to_np``)
JAX_CARRY = ("step", "params", "batch_stats", "opt_state", "best_val", "best_params",
             "best_batch_stats", "best_epoch")


def gather_members(local: List, group) -> List:
    """Every rank's list of ``group`` concatenated in rank order (``local``
    itself without a group)."""
    if group is None:
        return list(local)
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, list(local), group=group)
    return [x for part in parts for x in part]


def save_protocol_checkpoint(directory: str, epoch: int, carry, history: Dict,
                             keys: Sequence, group=None) -> str:
    """Synchronous save of the protocol's state after ``epoch``. ``carry``
    is the member trainers in key order; ``history`` is ``{key: {metric:
    [floats]}}`` with label-string or seed-int keys, ``keys`` their order
    for the JSON round trip. With ``group`` (the members split over its
    ranks) ``carry``, ``history`` and ``keys`` are the rank's; the first
    rank writes every rank's, in rank order."""
    path = os.path.join(os.path.abspath(directory), f"step_{int(epoch)}")
    members = gather_members([t.state_payload() for t in carry], group)
    configs = gather_members([dataclasses.asdict(t.cfg) for t in carry], group)
    histories = gather_members([history[k] for k in keys], group)
    keys = gather_members(keys, group)
    history = dict(zip(keys, histories))
    if group is not None and dist.get_rank(group) != 0:
        return path
    os.makedirs(path, exist_ok=True)
    write_torch_file({"members": members, "configs": configs}, os.path.join(path, "carry.pt"))
    payload = {"epoch": int(epoch), "keys": [str(k) for k in keys],
               "history": {str(k): history[k] for k in keys}}
    tmp = os.path.join(path, "history.json.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(path, "history.json"))
    return path


def _member(tree, i: int):
    """Member ``i`` of a tree stacked on a leading member axis."""
    if isinstance(tree, dict):
        return {k: _member(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_member(v, i) for v in tree]
    return None if tree is None else np.asarray(tree)[i]


def read_protocol_carry(path: str) -> Dict:
    """The carry of a ``step_<E>`` directory: the port's ``carry.pt``
    (``{"members": [payload, ...], "configs": [...]}``, tensors on the
    host), or the JAX package's Orbax ``carry/`` as ``{"members": [tree,
    ...], "configs": None}``, each member's tree the JAX carry's fields
    (``JAX_CARRY``) at its index of the member axis, in the layout that
    :meth:`.trainer.Trainer.load_flax_state` takes."""
    pt = os.path.join(path, "carry.pt")
    if not os.path.exists(pt) and os.path.isdir(os.path.join(path, "carry")):
        tree = read_pytree(os.path.join(path, "carry"))
        missing = sorted(set(JAX_CARRY) - set(tree))
        if missing:
            raise ValueError(f"{path}/carry has no {missing}: not a JAX protocol carry")
        n = int(np.asarray(tree["best_val"]).shape[0])
        return {"members": [_member(tree, i) for i in range(n)], "configs": None}
    return torch.load(pt, map_location="cpu", weights_only=False)


def restore_protocol_checkpoint(path: str, carry_template, keys: Sequence,
                                rows: Optional[slice] = None) -> Tuple[list, Dict, int]:
    """Restore ``(carry, history, epoch)`` from a protocol checkpoint, the
    port's or the JAX package's, into the freshly built member trainers
    ``carry_template`` (in place; the same list is returned). ``keys`` are
    the protocol's label or seed keys in construction order, checked
    against the artifact's; ``rows``: the rank's members among them (all by
    default). A JAX member loads by :meth:`.trainer.Trainer.load_flax_state`
    (weights, optimizer, step, best-val snapshot) and takes its history from
    ``history.json``."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "history.json")) as f:
        payload = json.load(f)
    if payload["keys"] != [str(k) for k in keys]:
        raise ValueError(f"checkpoint at {path} was written for keys {payload['keys']}, "
                         f"but this protocol runs {[str(k) for k in keys]}")
    rows = rows or slice(0, len(keys))
    keys = list(keys)[rows]
    carry = read_protocol_carry(path)
    history = {k: payload["history"][str(k)] for k in keys}
    for key, trainer, state in zip(keys, carry_template, carry["members"][rows]):
        if carry["configs"] is not None:
            trainer.load_payload(state)  # its history too: the same as history.json's
            continue
        trainer.load_flax_state(state)  # a JAX member: its history is history.json's
        trainer.history = {k: list(v) for k, v in history[key].items()}
        trainer.epoch = int(payload["epoch"])
    return carry_template, history, int(payload["epoch"])


def resume_protocol(resume_from: str, carry_template, keys: Sequence,
                    rows: Optional[slice] = None) -> Tuple[list, Dict, int]:
    """The protocols' shared resume: restore the members (the rank's
    ``rows`` of ``keys``) and the history, and return the epoch to continue
    from (``saved + 1``)."""
    carry, history, last_epoch = restore_protocol_checkpoint(resume_from, carry_template, keys,
                                                             rows)
    return carry, history, last_epoch + 1


def checkpoint_and_maybe_stop(epoch: int, epochs: int, carry, history: Dict, keys: Sequence,
                              checkpoint_dir, checkpoint_every: int, preemption_guard,
                              group=None) -> bool:
    """The protocols' bookkeeping after each epoch of every member: a
    periodic or preemption save, then the stop decision. Returns True only
    when the run must stop early: a preemption after the final epoch is a
    finished run, which goes on to its test phase and artifacts; the save
    still gives the preemption contract's durable state. (The JAX package
    calls it at the end of each compiled block of epochs; in the port a
    block is one epoch, so the guard is read after every epoch.) With
    ``group`` the guard fires when it fired on any rank."""
    fired = preemption_guard is not None and preemption_guard.requested
    if group is not None:
        fired = any(gather_members([fired], group))
    if checkpoint_dir and (fired or (checkpoint_every and epoch % checkpoint_every == 0
                                     and epoch < epochs)):
        if group is None:
            save_protocol_checkpoint(checkpoint_dir, epoch, carry, history, keys)
        else:
            save_protocol_checkpoint(checkpoint_dir, epoch, carry, history, keys, group)
    if fired and epoch < epochs:
        print(f"[preempt] graceful stop after epoch {epoch}"
              + (f"; checkpoint in {checkpoint_dir}" if checkpoint_dir else ""), flush=True)
        return True
    return False
