"""How far a data-parallel epoch lands from the one-device epoch, and why.

    python -m pointcloud_orientation_tpu_torch.parallel.dp_gap [--world 2] \
        [--device cuda] [--dtype float32] [--seeds 0 1 2] [--preset 8dir_kl] \
        [--num-points 10000] [--batch-size 16] [--samples-per-class 8] \
        [--classes chair sofa] [--optimizer sgd]

For each seed (the config's ``seed``: initial weights, split, shuffle and
augmentation) runs one epoch of the preset on one device and as ``world``
ranks over ``gloo`` (on one card the ranks share it; ``--device cpu`` runs
the kernels' plain versions), and prints one JSON line a seed: the largest
difference over the weights and over BatchNorm's running statistics after
the epoch, with the leaf that holds each; the first step's gradient (the
global batch's, summed over the ranks) against the one-device gradient on
the same weights; the train and val losses' relative differences.

Both runs compute the same function of the same global batch (the DP
``Trainer`` draws at the global shape, takes BatchNorm's moments and the
valid count over the ranks and sums the gradients), in another order. With
``--dtype float64`` (the model and the batches cast; on the CPU) what is
left is that order's rounding at float64, so a gap far below the float32
one says the float32 gap is rounding carried through the epoch, and a gap
of the same size would be a fault of the DP path.

The dataset is the procedural ModelNet stand-in (``data.synthetic_modelnet``)
at ``--num-points``, its classes all or ``--classes``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..data import OrientationDataset, synthetic_modelnet
from ..ops import cuda_kernels as K
from ..train.config import PRESETS, preset
from ..train.trainer import Trainer


@contextlib.contextmanager
def plain_kernels() -> Iterator[None]:
    """The kernels' plain versions in place of their wrappers (which take
    float32 alone) on the 8-dir train and eval paths: float64 on the CPU."""
    names = ("sa_group", "sa_group_scatter", "sa_mlp_max", "sa_mlp_max_bwd")
    saved = {n: getattr(K, n) for n in names}
    for n in names:
        setattr(K, n, getattr(K, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def make_trainer(seed: int, device: str = "cuda", dtype: str = "float32",
                 preset_name: str = "8dir_kl", num_points: int = 10_000, batch_size: int = 16,
                 samples_per_class: int = 8, classes: Optional[Sequence[str]] = None,
                 optimizer: str = "sgd", mesh=None) -> Trainer:
    """The preset's one-epoch Trainer on the procedural set; in float64 the
    model and every batch cast (run it under :func:`plain_kernels`)."""
    cfg = preset(preset_name, epochs=1, optimizer=optimizer, seed=seed, num_points=num_points,
                 batch_size=batch_size, classes=classes)
    ds = OrientationDataset(*synthetic_modelnet(num_points=num_points,
                                                samples_per_class=samples_per_class,
                                                class_names=classes))
    t = Trainer(cfg, ds, device=device, mesh=mesh)
    if dtype == "float64":
        t.model.double()  # the optimizer holds the same Parameter objects
        build = t.build_batch  # every path builds its batches here

        def build_batch(*a, **k):
            return {n: v.double() if v.is_floating_point() else v
                    for n, v in build(*a, **k).items()}

        t.build_batch = build_batch
    return t


def _spec(args) -> dict:
    return dict(device=args.device, dtype=args.dtype, preset_name=args.preset,
                num_points=args.num_points, batch_size=args.batch_size,
                samples_per_class=args.samples_per_class, classes=args.classes,
                optimizer=args.optimizer)


def first_grads(t: Trainer) -> Dict[str, np.ndarray]:
    """The first train batch's gradient at the initial weights (the
    ranks' summed gradient under a mesh)."""
    idx, valid, _ = next(t.train_ds.batches(t.cfg.batch_size))
    batch, valid, _ = t.device_batch(t.train_ds, idx, valid, t.generator(0, 0, 0))
    t.train_step(batch, valid, t.generator(0, 1, 0))
    return {n: p.grad.detach().cpu().double().numpy() for n, p in t.model.named_parameters()}


def run(args, seed: int, mesh=None) -> Dict[str, np.ndarray]:
    """The first step's gradients, the epoch's state and its losses."""
    with plain_kernels() if args.dtype == "float64" else contextlib.nullcontext():
        grads = first_grads(make_trainer(seed, mesh=mesh, **_spec(args)))
        t = make_trainer(seed, mesh=mesh, **_spec(args))
        t.fit(epochs=1, log_every=0)
    out = {f"grad::{n}": g for n, g in grads.items()}
    out.update({f"state::{n}": v.detach().cpu().double().numpy()
                for n, v in t.model.state_dict().items()})
    out["train"], out["val"] = np.float64(t.history["train"][0]), np.float64(t.history["val"][0])
    out["params"] = np.array([n for n, _ in t.model.named_parameters()])
    return out


def rank_main(args) -> None:
    from .mesh import make_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                      WORLD_SIZE=str(args.world), RANK=str(args.rank), LOCAL_RANK="0")
    if args.device.startswith("cuda"):
        torch.cuda.set_device(0)  # every rank shares the one card
    mesh = make_mesh(("data",), device=args.device, backend="gloo")
    try:
        for seed in args.seeds:
            res = run(args, seed, mesh)
            if args.rank == 0:
                np.savez(os.path.join(args.out, f"seed{seed}.npz"), **res)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def start_ranks(args, argv: list, out: str) -> None:
    from .mesh import free_port

    base = [sys.executable, "-m", "pointcloud_orientation_tpu_torch.parallel.dp_gap",
            "--port", str(free_port()), "--out", out, *argv]
    env = {**os.environ, "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(args.world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=args.timeout)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    if any(p.returncode for p in procs):
        sys.exit("dp_gap: ranks failed: " + " | ".join(
            f"rank {r} rc {p.returncode}: {log[-2000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))


def _largest(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], names) -> tuple:
    diffs = {n: float(np.max(np.abs(a[n] - b[n]))) if a[n].size else 0.0 for n in names}
    leaf = max(diffs, key=diffs.get)
    return diffs[leaf], leaf


def compare(one: Dict[str, np.ndarray], ranks: Dict[str, np.ndarray]) -> dict:
    params = [str(n) for n in one["params"]]
    grad = {n: one[f"grad::{n}"] for n in params}
    state = {k[len("state::"):]: v for k, v in one.items() if k.startswith("state::")}
    g_diff, g_leaf = _largest(grad, {n: ranks[f"grad::{n}"] for n in params}, params)
    other = {k: ranks[f"state::{k}"] for k in state}
    p_diff, p_leaf = _largest(state, other, params)
    buffers = [k for k in state if k not in params]
    b_diff, b_leaf = _largest(state, other, buffers) if buffers else (0.0, None)
    rel = lambda k: float(abs(ranks[k] - one[k]) / abs(one[k]))  # noqa: E731
    return {"grad0_max_abs_diff": g_diff, "grad0_leaf": g_leaf,
            "grad0_leaf_max_abs": float(np.max(np.abs(grad[g_leaf]))),
            "params_max_abs_diff": p_diff, "params_leaf": p_leaf,
            "buffers_max_abs_diff": b_diff, "buffers_leaf": b_leaf,
            "train_loss_rel": rel("train"), "val_loss_rel": rel("val")}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--preset", default="8dir_kl", choices=sorted(PRESETS))
    ap.add_argument("--num-points", type=int, default=10_000, dest="num_points")
    ap.add_argument("--batch-size", type=int, default=16, dest="batch_size")
    ap.add_argument("--samples-per-class", type=int, default=8, dest="samples_per_class")
    ap.add_argument("--classes", nargs="+", default=None)
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adam"))
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("dp_gap: no CUDA device (pass --device cpu)")
    if args.dtype == "float64" and args.device != "cpu":
        sys.exit("dp_gap: --dtype float64 runs the kernels' plain versions: --device cpu")
    if args.rank is not None:
        rank_main(args)
        return
    if args.device.startswith("cuda"):
        from ..ops._build import load_library

        load_library()  # once, before the ranks load it
    with tempfile.TemporaryDirectory() as out:
        start_ranks(args, argv, out)
        for seed in args.seeds:
            one = run(args, seed)
            with np.load(os.path.join(out, f"seed{seed}.npz")) as z:
                ranks = {k: z[k] for k in z.files}
            print(json.dumps({"seed": seed, "world": args.world, "device": args.device,
                              "dtype": args.dtype, "preset": args.preset,
                              "num_points": args.num_points, **compare(one, ranks)}),
                  flush=True)


if __name__ == "__main__":
    main()
