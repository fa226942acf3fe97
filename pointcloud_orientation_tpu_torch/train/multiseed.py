"""The multi-seed protocol trained in lockstep: S seeds of one preset.

Counterpart of ``pointcloud_orientation_tpu/train/multiseed.py``
(``run_multi_seed``). Seed studies separate an optimisation's signal from
run-to-run noise; the JAX package trains the S seeds as one ``jax.vmap``\\ ped
program. The port runs them on the per-label protocol's lockstep machinery
(:func:`.ensemble.run_lockstep`): one :class:`.trainer.Trainer` a seed (its
own split, shuffles, initialisation and random draws), every member's epoch
in turn, epoch by epoch. Each seed's result is bit-equal to its sequential
run and independent of the seeds beside it; S members cost S times the
launches of one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..data.dataset import OrientationDataset
from ..utils.jax_weights import to_flax_variables
from .ensemble import run_lockstep
from .trainer import Trainer


def run_multi_seed(
    cfg,
    dataset: OrientationDataset,
    seeds: Sequence[int],
    out_dir: Optional[str] = None,
    log_every: int = 50,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    preemption_guard=None,
    return_params: bool = False,
    device: str = "cuda",
    fused_mlp_train: bool = False,
    **model_kwargs: Any,
) -> Optional[Dict[int, dict]]:
    """Train ``cfg`` once per seed, the seeds in lockstep, on ``device``
    (``fused_mlp_train`` and ``model_kwargs`` go to each
    :class:`.trainer.Trainer`; ``mesh`` is not ported,
    ``NotImplementedError``). The JAX package's ``ValueError``\\ s: duplicate
    seeds, and a ``per_label`` config.

    ``return_params=True`` also returns each seed's best-val weights as a
    flax tree (``"params"``/``"batch_stats"``, numpy), ready for
    ``OrientationPredictor.from_seed_sweep``. Reliability as in
    ``run_per_label_vmapped``: saves on ``checkpoint_every`` multiples, a
    preemption save that returns None, an exact ``resume_from``.

    A seed whose val loss was never finite is tested on its final weights
    and reported with ``best_val`` and ``best_val_epoch`` None (the JAX
    package's diverged-seed guard).

    Returns ``{seed: {"best_val", "best_val_epoch", "test_loss",
    "test_angular", "history"}}`` and, with ``out_dir``, writes
    ``seed_<s>/metrics.json`` and ``seeds_summary.json`` (the across-seed
    mean, std, min and max of the end metrics) with the JAX keys.
    """
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds: {seeds}")
    if mesh is not None:
        raise NotImplementedError("mesh is not ported: the port trains on one device")
    if cfg.per_label:
        raise ValueError("multi-seed vmapping composes with single-model "
                         "presets; per-label protocols sweep seeds label-wise")
    t_start = time.time()
    trainers = [Trainer(cfg.replace(seed=s), dataset, device=device,
                        fused_mlp_train=fused_mlp_train, **model_kwargs) for s in seeds]
    history = run_lockstep(trainers, seeds, cfg.epochs, cfg.checkpoint_every, log_every, "seeds",
                           checkpoint_dir, resume_from, preemption_guard)
    if history is None:
        return None
    diverged = [s for s, t in zip(seeds, trainers) if not math.isfinite(t.best_val)]
    if diverged:
        print(f"WARNING: seeds {diverged} never produced a finite val loss; testing their "
              "final state", flush=True)
    results = {}
    for s, t in zip(seeds, trainers):
        test = t.test()  # the best-val weights; a diverged seed's final ones
        finite = math.isfinite(t.best_val)
        results[s] = {"best_val": float(t.best_val) if finite else None,
                      "best_val_epoch": int(t.best_val_epoch) if finite else None,
                      "test_loss": test.mean_loss, "test_angular": test.mean_angular_error,
                      "history": history[s]}
        if return_params:
            results[s].update(to_flax_variables(t.model))
    wall = time.time() - t_start
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        agg = {}
        for k in ("best_val", "test_loss", "test_angular"):
            vals = np.asarray([results[s][k] for s in seeds if results[s][k] is not None
                               and np.isfinite(results[s][k])], np.float64)
            agg[k] = ({"mean": float(vals.mean()), "std": float(vals.std()),
                       "min": float(vals.min()), "max": float(vals.max()), "n": int(vals.size)}
                      if vals.size else {"n": 0})
        with open(os.path.join(out_dir, "seeds_summary.json"), "w") as f:
            json.dump({"seeds": seeds, "aggregate": agg, "wall_seconds": wall}, f, indent=2)
        for s in seeds:
            sdir = os.path.join(out_dir, f"seed_{s}")
            os.makedirs(sdir, exist_ok=True)
            payload = {
                "config": dataclasses.asdict(cfg.replace(seed=s)),
                "history": results[s]["history"],
                "best_val": results[s]["best_val"],
                "best_val_epoch": results[s]["best_val_epoch"],
                "test": {"loss": results[s]["test_loss"],
                         "mean_angular_error_deg": results[s]["test_angular"]},
                "multiseed_protocol": {"seeds": len(seeds), "wall_seconds": wall},
            }
            with open(os.path.join(sdir, "metrics.json"), "w") as f:
                json.dump(payload, f, indent=2, default=float)
    return results
