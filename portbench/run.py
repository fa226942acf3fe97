"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration and its traffic
are found by name through ``BENCHMARK.json``. The run makes its inputs and
weights from ``--seed``, warms up the cell's own shapes (set-up), measures
for ``--seconds`` seconds, and with ``--trace 1`` traces one more segment
of the same work for the per-layer metrics. Then it checks what the timed
path produced against the plain reference and prints one JSON line: the
end-to-end metrics (``--trace 0``) or the per-layer metrics (``--trace
1``), the device, and each number compared beside its limit, last. It
exits non-zero, printing no result, without a CUDA device, or where JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    port's environment knobs left at their defaults; no flax through
    other libraries."""
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("PCOT_")]:
        del os.environ[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    run = harness.load_run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < run.workload["chips"]:
        print(f"portbench: needs {run.workload['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    entry = importlib.import_module(f"portbench.entries.{run.traffic['entry']}")
    run.mark("imports")
    torch.cuda.init()
    torch.empty(1, device="cuda")
    run.mark("cuda_context")
    return report(run, entry)


def report(run, entry) -> int:
    """Run the cell's entry and print its result line."""
    import torch
    from portbench import harness

    out = entry.run(run)
    from pointcloud_orientation_tpu_torch.ops._build import LIBRARY

    marks = " ".join(f"{k} {v:.3f}" for k, v in run.marks.items())
    print(f"set-up phases (s from start): {marks}; nvcc build s: {LIBRARY.build_seconds}",
          file=sys.stderr)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    ends = harness.end_to_end_names()
    dev = torch.device(run.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": run.workload["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    checks = harness.judge(out["readings"], run.limits)
    result = {"correct": harness.correct(checks), "attempted": out["attempted"],
              "failed": out["failed"]}
    if run.trace:
        ctx = out["layer_ctx"]
        for w in sorted(set(ctx["calls"]) | {k for k, n in ctx["launches"].items() if n}):
            print(f"launches {w} {ctx['launches'].get(w, 0)} needed {len(ctx['calls'].get(w, []))}",
                  file=sys.stderr)
        result["metrics"] = harness.read_layers(run, ctx)
        device["busy_s"] = ctx["trace"]["busy_us"] / 1e6
        device["window_s"] = ctx["trace"]["window_us"] / 1e6
        result["device"] = device
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    else:
        result["metrics"] = {k: {"value": v, "unit": ends[k]["unit"]}
                             for k, v in out["metrics"].items()}
        result["device"] = device
    if out["failed"]:
        result["correct"] = False
    harness.emit(result, checks, out["readings"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
