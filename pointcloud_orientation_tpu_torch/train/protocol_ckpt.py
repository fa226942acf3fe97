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
package's own checkpoints keep their carry in Orbax (``step_<E>/carry``):
the port does not read them (``NotImplementedError``), as it does not read
``from_orbax_checkpoint``'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence, Tuple

import torch

from .trainer import write_torch_file


def save_protocol_checkpoint(directory: str, epoch: int, carry, history: Dict,
                             keys: Sequence) -> str:
    """Synchronous save of the protocol's state after ``epoch``. ``carry``
    is the member trainers in key order; ``history`` is ``{key: {metric:
    [floats]}}`` with label-string or seed-int keys, ``keys`` their order
    for the JSON round trip."""
    path = os.path.join(os.path.abspath(directory), f"step_{int(epoch)}")
    os.makedirs(path, exist_ok=True)
    write_torch_file({"members": [t.state_payload() for t in carry],
                      "configs": [dataclasses.asdict(t.cfg) for t in carry]},
                     os.path.join(path, "carry.pt"))
    payload = {"epoch": int(epoch), "keys": [str(k) for k in keys],
               "history": {str(k): history[k] for k in keys}}
    tmp = os.path.join(path, "history.json.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(path, "history.json"))
    return path


def read_protocol_carry(path: str) -> Dict:
    """``carry.pt`` of a ``step_<E>`` directory, tensors on the host.
    ``NotImplementedError`` for the JAX package's Orbax carry."""
    pt = os.path.join(path, "carry.pt")
    if not os.path.exists(pt) and os.path.isdir(os.path.join(path, "carry")):
        raise NotImplementedError(
            f"{path} holds the JAX package's Orbax carry; the port reads only its own "
            "carry.pt (Orbax is not ported)")
    return torch.load(pt, map_location="cpu", weights_only=False)


def restore_protocol_checkpoint(path: str, carry_template, keys: Sequence
                                ) -> Tuple[list, Dict, int]:
    """Restore ``(carry, history, epoch)`` from a protocol checkpoint into
    the freshly built member trainers ``carry_template`` (in place; the
    same list is returned). ``keys`` are the protocol's label or seed keys
    in construction order, checked against the artifact's."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "history.json")) as f:
        payload = json.load(f)
    if payload["keys"] != [str(k) for k in keys]:
        raise ValueError(f"checkpoint at {path} was written for keys {payload['keys']}, "
                         f"but this protocol runs {[str(k) for k in keys]}")
    for trainer, state in zip(carry_template, read_protocol_carry(path)["members"]):
        trainer.load_payload(state)  # its history too: the same as history.json's
    return carry_template, {k: payload["history"][str(k)] for k in keys}, int(payload["epoch"])


def resume_protocol(resume_from: str, carry_template, keys: Sequence) -> Tuple[list, Dict, int]:
    """The protocols' shared resume: restore the members and the history,
    and return the epoch to continue from (``saved + 1``). (The JAX
    package's ``place`` argument re-places the carry on a mesh; the port
    has none.)"""
    carry, history, last_epoch = restore_protocol_checkpoint(resume_from, carry_template, keys)
    return carry, history, last_epoch + 1


def checkpoint_and_maybe_stop(epoch: int, epochs: int, carry, history: Dict, keys: Sequence,
                              checkpoint_dir, checkpoint_every: int, preemption_guard) -> bool:
    """The protocols' bookkeeping after each epoch of every member: a
    periodic or preemption save, then the stop decision. Returns True only
    when the run must stop early: a preemption after the final epoch is a
    finished run, which goes on to its test phase and artifacts; the save
    still gives the preemption contract's durable state. (The JAX package
    calls it at the end of each compiled block of epochs; in the port a
    block is one epoch, so the guard is read after every epoch.)"""
    fired = preemption_guard is not None and preemption_guard.requested
    if checkpoint_dir and (fired or (checkpoint_every and epoch % checkpoint_every == 0
                                     and epoch < epochs)):
        save_protocol_checkpoint(checkpoint_dir, epoch, carry, history, keys)
    if fired and epoch < epochs:
        print(f"[preempt] graceful stop after epoch {epoch}"
              + (f"; checkpoint in {checkpoint_dir}" if checkpoint_dir else ""), flush=True)
        return True
    return False
