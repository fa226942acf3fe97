"""Trace train steps on the card: where a step's time goes.

    python -m pointcloud_orientation_tpu_torch.train.profile_step [--out DIR] \
        [--preset NAME] [--compute-dtype bfloat16] [--moe-dispatch capacity]

Builds the ``Trainer`` of a preset (``8dir_kl`` by default, or any other of
``train/config.py``: its batch and cloud size, full width, initialised from
the preset's seed; the trunk in f32 or, with ``--compute-dtype bfloat16``,
in bf16; ``--moe-dispatch`` for the MoE transformer) on a synthetic set of
the preset's classes, warms up, then runs ``STEPS`` train steps in each
train configuration (the shared MLPs' two; one for a model without them)
twice: once timed with the host clock around synchronised steps, once
under ``torch.profiler``. Prints one
JSON line per configuration: wall ms per step, device busy ms per step (the
sum of the CUDA kernels' and copies' durations on the card, one stream),
the device's idle share, kernel launches per step, and the kernels with the
most device time. Writes a Chrome trace per configuration to ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time
from collections import defaultdict

import torch

from ..data import OrientationDataset, synthetic_modelnet
from ..models import MODEL_REGISTRY
from .config import PRESETS, preset
from .trainer import Trainer

STEPS = 5


def device_events(prof):
    """(name, microseconds) of every kernel, copy and fill that ran on the
    card (not the annotations that span them)."""
    out = []
    for evt in prof.events():
        if (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            out.append((evt.name, evt.time_range.elapsed_us()))
    return out


def profile_mode(trainer: Trainer, steps: int, out_dir: str, mode: str) -> dict:
    ds = trainer.train_ds
    idx, valid, _ = next(ds.batches(trainer.cfg.batch_size))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 0, 0))
    for i in range(3):  # warm-up: cuBLAS handles, the kernel library, allocator
        trainer.train_step(batch, valid, trainer.generator(0, 1, i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(batch, valid, trainer.generator(0, 2, i))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            trainer.train_step(batch, valid, trainer.generator(0, 3, i))
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"train_step_{mode}.json"))
    events = device_events(prof)
    busy_ms = sum(us for _, us in events) / 1e3 / steps
    by_name = defaultdict(float)
    for name, us in events:
        by_name[name] += us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return {
        "mode": mode, "steps": steps, "wall_ms_per_step": wall_ms,
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms if events else None,
        "device_idle_share": 1.0 - busy_ms / traced_ms if events else None,
        "kernel_launches_per_step": launches / steps,
        "device_events_per_step": len(events) / steps,
        "top_device_ms_per_step": [{"name": n[:120], "ms": ms} for n, ms in top],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--preset", default="8dir_kl", choices=sorted(PRESETS))
    ap.add_argument("--compute-dtype", default=None, dest="compute_dtype",
                    help="trunk compute dtype: float32 (default) or bfloat16")
    ap.add_argument("--moe-dispatch", default=None, dest="moe_dispatch",
                    choices=("masked", "capacity"),
                    help="moe_point_transformer's dispatch (the preset's own by default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile: no CUDA device")
    cfg = preset(args.preset, compute_dtype=args.compute_dtype,
                 **({"moe_dispatch": args.moe_dispatch} if args.moe_dispatch else {}))
    ds = OrientationDataset(*synthetic_modelnet(num_points=cfg.num_points, samples_per_class=8,
                                                class_names=list(cfg.classes)))
    tag = (f"_{args.preset}" if args.preset != "8dir_kl" else "") + (
        f"_{cfg.compute_dtype}" if cfg.compute_dtype else "") + (
        f"_{args.moe_dispatch}" if args.moe_dispatch else "")
    shared_mlp = "fused_mlp_train" in inspect.signature(MODEL_REGISTRY[cfg.model]).parameters
    for mode in ("default", "fused") if shared_mlp else ("default",):
        trainer = Trainer(cfg, ds, device="cuda", fused_mlp_train=mode == "fused")
        print(json.dumps(profile_mode(trainer, STEPS, args.out, mode + tag)), flush=True)


if __name__ == "__main__":
    main()
