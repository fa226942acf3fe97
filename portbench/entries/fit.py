"""The training cells: ``Trainer.fit`` on its default path (splits resident
on the device, one block of epochs a call), ``epochs_per_call`` epochs a
call with the start epoch chained, a val pass every epoch.

Set-up builds one trainer on clouds made from the seed, loads weights made
from the seed, and makes the window's first call, whose first three steps
the comparison follows: each step's loss, the first gradient as the
optimizer gets it and the state after the third step, read by hooks on the
optimizer and on the trainer's step. The window then repeats the call.
After it, the next chained call is followed the same way, from the
program's state before it (weights, running statistics, Adam's moments
and count). The reference then follows both calls' first three steps, from
the same weights and from that state, and recomputes the last val pass and
the best-val snapshot's val loss from the program's state after its last
call.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, Tuple

import numpy as np
import torch

from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer
from pointcloud_orientation_tpu_torch.train.config import TrainConfig, preset
from pointcloud_orientation_tpu_torch.utils.jax_weights import (
    load_flax_variables,
    to_flax_variables,
)

from .. import costs, synth, trace, weights
from ..harness import Run, leaf_gap
from ..reference import TrainReference, precision

STEPS_FOLLOWED = 3


def make_trainer(run: Run, dataset: OrientationDataset) -> Trainer:
    spec = run.config["trainer"]
    fields = {**spec["config"], "batch_size": run.config["batch_size"],
              "num_points": run.config["num_points"], "lr": run.config["lr"],
              "seed": run.seed_for("trainer")}
    cfg = preset(spec["preset"], **fields) if spec["preset"] else TrainConfig(**fields)
    return Trainer(cfg, dataset, device=run.device)


def params_tree(trainer: Trainer, value) -> Dict:
    """A flax params tree of ``value(p)`` for each parameter ``p`` the
    optimizer updates, read through ``.grad``."""
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    held = [p.grad for p in params]
    for p in params:
        p.grad = value(p)
    tree = to_flax_variables(trainer.model, grads=True)
    for p, g in zip(params, held):
        p.grad = g
    return tree


def adam_state(trainer: Trainer, p: torch.Tensor, key: str) -> torch.Tensor:
    """Adam's ``key`` (``exp_avg``, ``exp_avg_sq``) of ``p``; zeros before
    the first step."""
    state = trainer.optimizer.state[p]
    return state[key] if key in state else torch.zeros_like(p)


def start_of(trainer: Trainer, epoch: int) -> Dict:
    """The program's state before a fit call from ``epoch``: the weights and
    running statistics, Adam's moments (flax trees) and update count."""
    return {"state": to_flax_variables(trainer.model),
            **{k: params_tree(trainer, lambda p, k=k: adam_state(trainer, p, k))
               for k in ("exp_avg", "exp_avg_sq")},
            "count": trainer.step, "epoch": epoch}


def follow_steps(trainer: Trainer, steps: int):
    """Hooks that read the trainer's next ``steps`` steps: each step's loss
    (on the device, read later), the first gradient as the optimizer got it
    (worked out from Adam's first moment before and after that step,
    ``(m1 - beta1 m0) / (1 - beta1)``) and the model's state after the
    last step."""
    opt = trainer.optimizer
    count = trainer.step
    seen: Dict = {"losses": []}
    beta1 = {p: g["betas"][0] for g in opt.param_groups for p in g["params"]}
    before = {p: adam_state(trainer, p, "exp_avg").clone() for p in beta1}

    def post(_opt, args, kwargs):
        if trainer.step == count:
            seen["grad"] = params_tree(trainer, lambda p: (
                (opt.state[p]["exp_avg"] - beta1[p] * before[p]) / (1.0 - beta1[p])))
        if trainer.step == count + steps - 1:
            seen["state"] = to_flax_variables(trainer.model)

    step = trainer.train_step

    def train_step(batch, valid, generator):
        m = step(batch, valid, generator)
        if len(seen["losses"]) < steps:
            seen["losses"].append(m["loss"])
        return m

    hook = opt.register_step_post_hook(post)
    trainer.train_step = train_step

    def remove():
        hook.remove()
        del trainer.train_step
        seen["losses"] = [float(x) for x in seen["losses"]]

    return seen, remove


def make_inputs(run: Run):
    """The cell's clouds and initial weights, made on the device from the
    seed: ``(points, labels, class names, weights)``."""
    cfg = run.config
    dev = torch.device(run.device)
    pts, labels, names = synth.clouds([(c, n) for c, n in cfg["data"]["classes"]],
                                      cfg["data"]["source_points"], run.seed_for("clouds"), dev)
    W0 = weights.make_weights(cfg, run.seed_for("weights"), dev, serving=False)
    return pts, labels, names, W0


def run(run: Run) -> Dict:
    cfg, traffic = run.config, run.traffic
    dev = torch.device(run.device)
    pts, labels, names, W0 = make_inputs(run)
    run.mark("inputs")
    dataset = OrientationDataset(pts.cpu().numpy(), labels.cpu().numpy().astype(np.int32), names)
    trainer = make_trainer(run, dataset)
    load_flax_variables(trainer.model, weights.to_flax(cfg, W0))
    run.mark("program")
    E = traffic["epochs_per_call"]
    first, unhook = follow_steps(trainer, STEPS_FOLLOWED)
    accumulate = trainer._accumulate
    passes: Dict = {}

    def last_pass(res):  # a block's passes end with its last epoch's val pass
        passes["last"] = res
        return accumulate(res)

    trainer._accumulate = last_pass
    trainer.fit(epochs=E, start_epoch=1, log_every=0)
    unhook()
    n_train, n_val = len(trainer.train_ds), len(trainer.val_ds)
    run.mark("first_call")
    setup_s = time.perf_counter() - run.t0

    calls, start = [], E + 1
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < run.seconds:
        t = time.perf_counter()
        trainer.fit(epochs=start + E - 1, start_epoch=start, log_every=0)
        calls.append(time.perf_counter() - t)
        start += E
    window_s = sum(calls)
    steps_per_epoch = -(-n_train // cfg["batch_size"])
    metrics = {"train_clouds_per_s": len(calls) * E * n_train / window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the next chained call, followed as set-up's: the reference takes its
    # first steps from the program's state before it
    late_start = start_of(trainer, start)
    late, unhook = follow_steps(trainer, STEPS_FOLLOWED)
    trainer.fit(epochs=start + E - 1, start_epoch=start, log_every=0)
    unhook()
    start += E
    fwd = costs.forward_flops(cfg, cfg["num_points"])
    layer_ctx = None
    if run.trace:
        layer_ctx = traced_call(run, trainer, start, E, steps_per_epoch)
        layer_ctx.update(flops=len(calls) * E * (3 * n_train + n_val) * fwd, window_s=window_s)

    # the program's state after its last call, then the program freed
    final = to_flax_variables(trainer.model)
    last_val = passes["last"]["per_sample"].astype(np.float64)
    best_val = trainer.best_val
    trainer.model.load_state_dict(trainer.best_state)
    best = to_flax_variables(trainer.model)
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings = compare(run, pts, labels, names, W0, first, late_start, late, final, last_val,
                       best, best_val)
    return {
        "attempted": len(calls) * E * steps_per_epoch, "failed": 0, "metrics": metrics,
        "memory_peak_bytes": peak, "layer_ctx": layer_ctx, "readings": readings,
    }


def traced_call(run: Run, trainer: Trainer, start: int, E: int, steps_per_epoch: int) -> Dict:
    """One more fit call under the profiler: the per-layer metrics' context."""
    red, launches = trace.profile(
        lambda: trainer.fit(epochs=start + E - 1, start_epoch=start, log_every=0),
        torch.device(run.device))
    cfg = run.config
    n_val_batches = -(-len(trainer.val_ds) // cfg["batch_size"])
    per_epoch = [costs.kernel_calls(cfg, cfg["num_points"], cfg["batch_size"], True)] \
        * steps_per_epoch + [costs.kernel_calls(cfg, cfg["num_points"], cfg["batch_size"],
                                                False)] * n_val_batches
    calls = costs.merge_calls(per_epoch * E)
    return {"kind": "train", "trace": red, "units": E * steps_per_epoch, "launches": launches,
            "calls": {k: [least for _, least in v] for k, v in calls.items()}}


def reference_start(cfg: Dict, start: Dict, dev) -> Tuple[Dict, Dict]:
    """A followed call's start (:func:`start_of`) for the reference: the
    state in the benchmark's layout and :meth:`.TrainReference.steps_from`'s
    keywords."""
    moments = tuple(weights.from_flax(cfg, start[k], dev, stats=False)
                    for k in ("exp_avg", "exp_avg_sq"))
    return (weights.from_flax(cfg, start["state"], dev),
            {"epoch": start["epoch"], "count": start["count"], "moments": moments})


def compare(run: Run, pts, labels, names, W0, first, late_start, late, final, last_val, best,
            best_val) -> Dict[str, float]:
    """The reference, from the same inputs, against the program: set-up's
    followed steps from ``W0`` (``first``), the chained call's after the
    window from the program's state before it (``late_start``, ``late``),
    the program's last val pass (``last_val``, its per-sample losses)
    recomputed on its final state, and the best val the program chose
    recomputed on its best-val snapshot (:func:`readings`)."""
    cfg, dev = run.config, pts.device
    ref = TrainReference(cfg, run.seed_for("trainer"), pts, labels, names)
    W_late, kw = reference_start(cfg, late_start, dev)
    with precision(False):
        steps = ref.steps_from(W0, STEPS_FOLLOWED, cfg["lr"])
        steps_late = ref.steps_from(W_late, STEPS_FOLLOWED, cfg["lr"], **kw)
        val_final = ref.val_pass(weights.from_flax(cfg, final, dev))
        val_best = ref.val_loss(weights.from_flax(cfg, best, dev))

    def program(seen):
        return (seen["losses"], weights.from_flax(cfg, seen["grad"], dev, stats=False),
                weights.from_flax(cfg, seen["state"], dev))

    return readings((W0, *program(first), steps), (W_late, *program(late), steps_late),
                    last_val, val_final, best_val, val_best)


def step_readings(start, losses, grad_p, state_p, steps) -> Dict[str, float]:
    """The numbers of a followed call, from the state it started from, the
    program's values (``losses``, ``grad_p``, ``state_p``) and the
    reference's (``steps`` of :meth:`.TrainReference.steps_from`):
    ``loss1`` the first step's loss, ``loss`` the worst of the followed
    steps (relative gaps); ``grad`` the first gradient's worst leaf;
    ``change`` the worst and ``change_med`` the median leaf's change over
    the followed steps, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone); ``stats`` the running statistics' change, worst
    leaf."""
    g_norm = {k: float(v.norm()) for k, v in steps["grad"].items()}
    med = float(np.median(list(g_norm.values())))
    moved = [k for k in sorted(g_norm) if g_norm[k] >= 1e-3 * med]
    stats = [k for k in sorted(start) if not weights.is_param(k)]
    d_prog = {k: state_p[k] - start[k] for k in start}
    d_ref = {k: steps["state"][k] - start[k] for k in start}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, steps["losses"])]
    return {
        "loss1": gaps[0],
        "loss": max(gaps),
        "grad": leaf_gap(grad_p, steps["grad"], sorted(g_norm)),
        "change": leaf_gap(d_prog, d_ref, moved),
        "change_med": leaf_gap(d_prog, d_ref, moved, statistics.median),
        "stats": leaf_gap(d_prog, d_ref, stats),
    }


def readings(first, late, val_p, val_r, best_p, best_r) -> Dict[str, float]:
    """The numbers compared: set-up's followed call's and, prefixed
    ``late_``, the chained call's after the window (``first``, ``late``:
    :func:`step_readings`' arguments); ``val`` the widest and ``val_mean``
    the mean gap of a cloud's val loss (``val_p`` a val pass's per-sample
    losses, ``val_r`` :meth:`.TrainReference.val_pass`'s), over the pass's
    mean loss; ``best_val`` the relative gap of the best val."""
    per_r, valid = val_r
    mask = valid > 0
    return {
        **step_readings(*first),
        **{f"late_{k}": v for k, v in step_readings(*late).items()},
        "val": float(np.abs(val_p - per_r)[mask].max() / np.abs(per_r[mask].mean())),
        "val_mean": float(np.abs(val_p - per_r)[mask].mean() / np.abs(per_r[mask].mean())),
        "best_val": abs(best_p - best_r) / abs(best_r),
    }


def control(run: Run) -> Dict[str, Dict[str, float]]:
    """The cell's control, a planted fault and a witness, at its own size on
    its seed's inputs, each put in the program's place against the
    reference in f32, from ``W0`` and from the program's state after one
    fit call (as the chained call after the window starts): the reference
    in TF32 (``tf32``); the reference with half of each batch left out of
    the loss's mean (``half_batch``); the reference with its gradients
    jittered (``jitter_<size>``: at 1e-7 of each leaf's root mean square,
    round-off's size, and at 1e-4, about the program's first-gradient
    gap). The val passes are of the f32 state after the followed steps;
    the fault and the witness leave them as they are."""
    cfg = run.config
    pts, labels, names, W0 = make_inputs(run)
    E = run.traffic["epochs_per_call"]
    trainer = make_trainer(run, OrientationDataset(
        pts.cpu().numpy(), labels.cpu().numpy().astype(np.int32), names))
    load_flax_variables(trainer.model, weights.to_flax(cfg, W0))
    trainer.fit(epochs=E, start_epoch=1, log_every=0)
    W_late, kw = reference_start(cfg, start_of(trainer, E + 1), pts.device)
    del trainer
    ref = TrainReference(cfg, run.seed_for("trainer"), pts, labels, names)
    lr, n = cfg["lr"], STEPS_FOLLOWED

    def both(**fault):
        return ref.steps_from(W0, n, lr, **fault), ref.steps_from(W_late, n, lr, **kw, **fault)

    def place(steps, steps_late, base, base_late):
        return ((W0, steps["losses"], steps["grad"], steps["state"], base),
                (W_late, steps_late["losses"], steps_late["grad"], steps_late["state"],
                 base_late))

    out = {}
    with precision(False):
        base, base_late = both()
        val = ref.val_pass(base["state"])
        best = ref.val_loss(base["state"])
        for name, fault in (("half_batch", {"half_batch": True}),
                            ("jitter_1e-7", {"jitter": 1e-7}), ("jitter_1e-4", {"jitter": 1e-4})):
            out[name] = readings(*place(*both(**fault), base, base_late), val[0], val, best, best)
    with precision(True):
        tf, tf_late = both()
        val_tf = ref.val_pass(base["state"])
        best_tf = ref.val_loss(base["state"])
    out["tf32"] = readings(*place(tf, tf_late, base, base_late), val_tf[0], val, best_tf, best)
    return out
