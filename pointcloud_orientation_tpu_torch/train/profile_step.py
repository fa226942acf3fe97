"""Trace train steps on the card: where a step's time goes.

    python -m pointcloud_orientation_tpu_torch.train.profile_step [--out DIR] \
        [--preset NAME] [--compute-dtype bfloat16] [--moe-dispatch capacity] \
        [--mesh data:1]

Builds the ``Trainer`` of a preset (``8dir_kl`` by default, or any other of
``train/config.py``: its batch and cloud size, full width, initialised from
the preset's seed; the trunk in f32 or, with ``--compute-dtype bfloat16``,
in bf16; ``--moe-dispatch`` for the MoE transformer) on a synthetic set of
the preset's classes (data-parallel over ``--mesh data:N``, run under
torchrun or, for ``data:1``, alone: one rank on NCCL, every collective of
the DP step at world size 1), warms up, then runs ``STEPS`` train steps in each
train configuration (the shared MLPs' two; one for a model without them)
twice: once timed with the host clock around synchronised steps, once
under ``torch.profiler``. Prints one
JSON line per configuration: wall ms per step, device busy ms per step (the
sum of the CUDA kernels' and copies' durations on the card, one stream),
the device's idle share, kernel launches per step, and the kernels with the
most device time and the host operations with the most self time. At
``--mesh data:1`` each configuration runs twice more: with its collectives
made no calls (:func:`collectives_as_identity`), and without the mesh in
the same process, beside the live process group; a last line gives the
host cost of one collective call (:func:`collective_costs`). Writes a
Chrome trace per configuration to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import sys
import time
from collections import defaultdict
from unittest import mock

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
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    return {
        "mode": mode, "steps": steps, "wall_ms_per_step": wall_ms,
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms if events else None,
        "device_idle_share": 1.0 - busy_ms / traced_ms if events else None,
        "kernel_launches_per_step": launches / steps,
        "device_events_per_step": len(events) / steps,
        "top_device_ms_per_step": [{"name": n[:120], "ms": ms} for n, ms in top],
        "top_host_self_ms_per_step": [{"name": e.key[:120], "calls": e.count / steps,
                                       "ms": e.self_cpu_time_total / 1e3 / steps}
                                      for e in host],
    }


@contextlib.contextmanager
def collectives_as_identity():
    """At world size 1 each collective of the DP step (a sum, a gather or a
    broadcast over one rank) is the identity: no call is made, so a step
    under this context times the DP path without its collectives."""
    if torch.distributed.get_world_size() != 1:
        raise ValueError("collectives are the identity at world size 1 only")

    def all_gather(parts, t, *a, **k):
        parts[0].copy_(t)

    with mock.patch.object(torch.distributed, "all_reduce", lambda *a, **k: None), \
            mock.patch.object(torch.distributed, "broadcast", lambda *a, **k: None), \
            mock.patch.object(torch.distributed, "all_gather", all_gather):
        yield


def collective_costs(mesh, dev, calls: int = 200, channels: int = 128) -> dict:
    """Host microseconds a call, ``calls`` calls in a row on a ``(2,
    channels)`` tensor on the card (BatchNorm's stacked moments): a bare
    ``all_reduce`` over the data group, the same with the card synchronised
    after each, the port's differentiable ``sum_over_group`` (a clone and
    the all-reduce), one elementwise launch for scale, and the three mesh
    lookups (``get_group``, ``get_local_rank``, ``mesh[axis].size()``)."""
    from ..parallel.comm import sum_over_group

    group = mesh.get_group("data")
    t = torch.ones((2, channels), device=dev)

    def per_call_us(fn, sync_each: bool = False) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / calls

    return {
        "calls": calls, "shape": [2, channels],
        "all_reduce_us": per_call_us(lambda: torch.distributed.all_reduce(t, group=group)),
        "all_reduce_synced_us": per_call_us(
            lambda: torch.distributed.all_reduce(t, group=group), sync_each=True),
        "sum_over_group_us": per_call_us(lambda: sum_over_group(t, group)),
        "elementwise_launch_us": per_call_us(lambda: t.mul_(1.0)),
        "mesh_lookups_us": per_call_us(lambda: (mesh.get_group("data"),
                                                mesh.get_local_rank("data"),
                                                mesh["data"].size())),
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
    ap.add_argument("--mesh", default=None,
                    help="data:N: the data-parallel Trainer (N=1 alone, else under torchrun)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile: no CUDA device")
    mesh = None
    if args.mesh:
        from ..parallel import make_mesh
        from .run import parse_mesh

        axis, n = parse_mesh(args.mesh)
        mesh = make_mesh((axis,), None if n is None else (n,), device="cuda")
    cfg = preset(args.preset, compute_dtype=args.compute_dtype,
                 **({"moe_dispatch": args.moe_dispatch} if args.moe_dispatch else {}))
    ds = OrientationDataset(*synthetic_modelnet(num_points=cfg.num_points, samples_per_class=8,
                                                class_names=list(cfg.classes)))
    tag = (f"_{args.preset}" if args.preset != "8dir_kl" else "") + (
        f"_{cfg.compute_dtype}" if cfg.compute_dtype else "") + (
        f"_{args.moe_dispatch}" if args.moe_dispatch else "") + ("_mesh" if mesh else "")
    shared_mlp = "fused_mlp_train" in inspect.signature(MODEL_REGISTRY[cfg.model]).parameters
    for mode in ("default", "fused") if shared_mlp else ("default",):
        trainer = Trainer(cfg, ds, device=f"cuda:{torch.cuda.current_device()}",
                          fused_mlp_train=mode == "fused", mesh=mesh)
        result = profile_mode(trainer, STEPS, args.out, mode + tag)
        if trainer.writes:
            print(json.dumps(result), flush=True)
        if mesh is not None and torch.distributed.get_world_size() == 1:
            with collectives_as_identity():
                result = profile_mode(trainer, STEPS, args.out, mode + tag + "_no_collectives")
            print(json.dumps(result), flush=True)
            meshless = Trainer(cfg, ds, device=f"cuda:{torch.cuda.current_device()}",
                               fused_mlp_train=mode == "fused")
            result = profile_mode(meshless, STEPS, args.out, mode + "_meshless_beside_group")
            print(json.dumps(result), flush=True)
    if mesh is not None:
        costs = collective_costs(mesh, torch.device("cuda", torch.cuda.current_device()))
        if trainer.writes:
            print(json.dumps({"collectives": costs, "backend": torch.distributed.get_backend(),
                              "world": torch.distributed.get_world_size()}), flush=True)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
