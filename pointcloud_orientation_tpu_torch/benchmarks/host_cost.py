"""The host cost of the kernel wrappers' launch path, between two checkouts.

    python -m pointcloud_orientation_tpu_torch.benchmarks.host_cost --against DIR

``DIR`` is another checkout of this repo (a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists). One process a
run, on one CUDA card, in turns: this checkout, ``DIR``, ``DIR``, this
checkout. Each run imports the package of its own checkout (each builds its
own kernels) and times, with the same code:

- ``host_us``: the host's time to enqueue one call of the ``sa_group`` and
  ``sa_mlp_max`` wrappers (sa1 of the 8-dir model at B=1 N=1,024, so the
  card keeps up), over rounds of 100 back-to-back calls, the card drained
  between rounds; also of ``torch.ops.pcot.<name>`` (the custom op,
  through the dispatcher) and of the op's CUDA implementation called
  directly, where the checkout has them. The routes take turns round by
  round; median and least of 15 rounds;
- ``request_ms``: the 8-dir request (``OrientationPredictor``, random
  weights from seed 0) at N=1,024 B=1 and B=64 and N=10,000 B=16, host clock
  around a request (it ends in a copy to the host), median of 30 after 2
  warm-ups;
- ``step_ms``: a train step of the ``8dir_kl`` preset at B=16 N=10,000
  (forward, backward, Adam; host clock around a synchronised step), median
  of 15 after 2 warm-ups.

Where the checkout has ``cuda_kernels.kernel_mode``, each request and step
is timed also under ``kernel_mode("ops")`` (every forward launch through
the dispatcher), the two modes taking turns call by call. Prints one JSON
line a run, then the card's name and power limit
(``nvidia-smi``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REQUESTS = ((1024, 1), (1024, 64), (10_000, 16))
STEP_N, STEP_B = 10_000, 16
HOST_CALLS, HOST_ROUNDS = 100, 15
REQUEST_ITERS, STEP_ITERS, WARMUP = 30, 15, 2
ORDER = ("this", "against", "against", "this")


def _host_us(calls: dict) -> dict:
    """Per route, the median and least over rounds of the host's time per
    call, ``HOST_CALLS`` calls back to back, the routes in turns, the card
    drained after each."""
    import numpy as np
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    ts = {name: [] for name in calls}
    for r in range(HOST_ROUNDS):
        names = list(calls)[r % len(calls):] + list(calls)[:r % len(calls)]
        for name in names:
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                calls[name]()
            ts[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    return {name: {"median": float(np.median(t)), "least": float(np.min(t))}
            for name, t in ts.items()}


def _median_ms(fns: dict, iters: int, sync: bool) -> dict:
    """Per mode, the median host ms of ``fns[mode](i)`` after ``WARMUP``
    calls, the modes taking turns call by call."""
    import numpy as np
    import torch

    ts = {mode: [] for mode in fns}
    for i in range(WARMUP + iters):
        for mode, fn in fns.items():
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i)
            if sync:
                torch.cuda.synchronize()
            if i >= WARMUP:
                ts[mode].append((time.perf_counter() - t0) * 1e3)
    return {mode: float(np.median(t)) for mode, t in ts.items()}


def worker() -> dict:
    """One run in the checkout on ``sys.path``: the timings above."""
    import numpy as np
    import torch

    from pointcloud_orientation_tpu_torch import OrientationPredictor, random_flax_variables
    from pointcloud_orientation_tpu_torch.data import OrientationDataset, synthetic_modelnet
    from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
    from pointcloud_orientation_tpu_torch.ops.geometry import random_sample_indices
    from pointcloud_orientation_tpu_torch.train import Trainer, preset

    if not torch.cuda.is_available():
        raise SystemExit("host_cost needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xyz = torch.randn((1, 1024, 3), generator=gen, device=dev)
    cidx = random_sample_indices(gen, 1, 1024, 128, dev).to(torch.int32).contiguous()
    grouped = K.sa_group(xyz, None, cidx, 32)[1]
    layers = []
    for ci, co in ((3, 64), (64, 64), (64, 128)):
        layers.append((torch.randn((ci, co), generator=gen, device=dev) / ci ** 0.5,
                       torch.rand((co,), generator=gen, device=dev) + 0.5,
                       0.1 * torch.randn((co,), generator=gen, device=dev)))
    flat = [t for layer in layers for t in layer]
    calls = {"sa_group": lambda: K.sa_group(xyz, None, cidx, 32),
             "sa_mlp_max": lambda: K.sa_mlp_max(grouped, layers)}
    has_ops = hasattr(K, "kernel_mode")
    if has_ops:
        calls["op sa_group"] = lambda: torch.ops.pcot.sa_group(xyz, None, cidx, 32)
        calls["op sa_mlp_max"] = lambda: torch.ops.pcot.sa_mlp_max(grouped, flat, False)
        calls["launch sa_group"] = lambda: K._sa_group_cuda(xyz, None, cidx, 32)
        calls["launch sa_mlp_max"] = lambda: K._sa_mlp_max_cuda(grouped, flat, False)
    host_us = _host_us(calls)

    v = random_flax_variables(0)
    rng = np.random.default_rng(0)
    predictors = {n: OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                          num_points=n, max_batch=64 if n == 1024 else 16,
                                          seed=0, device=dev)
                  for n in {n for n, _ in REQUESTS}}
    clouds = {(n, b): rng.normal(size=(b, n, 3)).astype(np.float32) for n, b in REQUESTS}
    ds = OrientationDataset(*synthetic_modelnet(num_points=STEP_N, samples_per_class=8))
    trainer = Trainer(preset("8dir_kl", epochs=1, batch_size=STEP_B), ds, device=dev)
    idx, valid, _ = next(trainer.train_ds.batches(STEP_B))
    batch, valid_t, _ = trainer.device_batch(trainer.train_ds, idx, valid,
                                             trainer.generator(0, 98, 0))

    def in_mode(mode, fn):
        def run(i):
            with K.kernel_mode(mode) if has_ops else contextlib.nullcontext():
                fn(i)
        return run

    modes = ("auto", "ops") if has_ops else ("auto",)
    request_ms = {}
    for n, b in REQUESTS:
        request = lambda i, n=n, b=b: predictors[n](clouds[(n, b)])
        request_ms[f"N={n} B={b}"] = _median_ms({m: in_mode(m, request) for m in modes},
                                                REQUEST_ITERS, sync=False)

    def step(i):
        trainer.train_step(batch, valid_t, trainer.generator(0, 97, i))

    step_ms = _median_ms({m: in_mode(m, step) for m in modes}, STEP_ITERS, sync=True)
    return {"host_us": host_us, "request_ms": request_ms, "step_ms": step_ms,
            "kernel_mode": has_ops, "torch": torch.__version__}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="the other checkout's root")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return
    if not args.against:
        ap.error("--against DIR is required")
    trees = {"this": Path(__file__).resolve().parents[2], "against": Path(args.against).resolve()}
    if not (trees["against"] / "pointcloud_orientation_tpu_torch").is_dir():
        ap.error(f"{trees['against']} holds no pointcloud_orientation_tpu_torch package")
    for label in ORDER:
        env = {**os.environ, "PYTHONPATH": str(trees[label])}
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker"],
                             cwd=trees[label], env=env, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            raise SystemExit(f"the {label} run failed with exit code {run.returncode}")
        print(json.dumps({"tree": label, "root": str(trees[label]),
                          **json.loads(run.stdout.strip().splitlines()[-1])}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
