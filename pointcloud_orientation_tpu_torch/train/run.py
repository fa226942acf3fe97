"""CLI: ``python -m pointcloud_orientation_tpu_torch.train.run``.

Counterpart of ``pointcloud_orientation_tpu/train/run.py`` for the flags
the port supports. Trains a preset (``pointnet_pp_forward``,
``point_transformer`` (``--attention xla|flash``), ``axes_all_labels``,
``moe_point_transformer`` (``--moe-dispatch masked|capacity``),
``8dir``, ``8dir_kl``, ``8dir_mse``, ``multi_8dir``,
``vm_kl``, ``vm_kl_atan2``, ``mvm``, ``mvm_guarded``, ``mvm_spread``,
``mvm_robust``, ``mvm_debug``) on the card (``--device cuda``, the default)
or the CPU, tests the best-val weights and writes ``metrics.json`` and
``summary.txt`` (and, for ``mvm_debug``, ``debug_log.txt``) to ``--out``.
A per-label preset (``axes_all_labels``, ``8dir``) trains one model per
category into ``--out/<label>`` and keeps ``--out/summary.txt``, one line
a label (:func:`run_per_label`).

    python -m pointcloud_orientation_tpu_torch.train.run --preset vm_kl \\
        --data synthetic --epochs 5 --device cuda --out results/torch_vm_kl

After training, :func:`run_single` also writes ``pred_ply/`` (up to 10 test
clouds with their predicted axes), for the 8-direction tasks two lines of
mean ground-truth and predicted distributions at the end of
``summary.txt``, for ``mvm`` ``results.txt`` and the polar plots of a few
test predictions (``figs/``), and ``loss_curve.png``; the PNGs only where
matplotlib imports (the card's machine has none: one printed line says so).

Data (:func:`load_dataset`): ``synthetic``, ``hdf5:DIR`` (the ModelNet40
archive, read by ``data/h5format.py``: no h5py), ``ply:DIR`` (a PLY tree ``DIR/<class>/*.ply``) or
``plygt:DIR`` (a pre-rotated PLY tree with its ground-truth sidecars, which
sets ``rotation_mode="none"`` so that the stored targets are trained on):

    python -m pointcloud_orientation_tpu_torch.train.run --preset 8dir_kl \\
        --data plygt:data/rotated --out results/torch_8dir_kl

The grid-pruned kNN is reached through ``PCOT_KNN=grid``, as in the JAX
package; ``--knn`` offers the JAX flag's ``exact`` and ``approx`` (the
matmul-form distances and the ``topk_min`` kernel: the exact K nearest on
the card, see ``ops/geometry.py``). The run is wrapped in a
:class:`.reliability.PreemptionGuard`: SIGTERM stops it after the epoch,
with a checkpoint under ``--out/ckpt`` when ``--checkpoint-every`` is set.

The protocols (``train/ensemble.py``, ``train/multiseed.py``): ``--seeds
1,2,3`` trains a single-model preset once per seed into
``--out/seed_<s>/`` with ``seeds_summary.json``; ``--vmap-labels`` trains a
per-label preset's labels together (the JAX flag's name; the port trains
them in lockstep, one model after another each epoch, not as one mapped
program). Both save protocol checkpoints under ``--out/ckpt/step_<E>`` with
``--checkpoint-every`` and continue one with ``--resume-from``:

    python -m pointcloud_orientation_tpu_torch.train.run --preset 8dir_kl \
        --seeds 1,2,3 --epochs 10 --checkpoint-every 2 --out results/seeds
    python -m pointcloud_orientation_tpu_torch.train.run --preset 8dir_kl \
        --seeds 1,2,3 --epochs 10 --checkpoint-every 2 --out results/seeds \
        --resume-from results/seeds/ckpt/step_4

``--lr-schedule cosine --warmup-epochs E``, ``--async-checkpoint``,
``--host-resident``, ``--debug-checks`` set the config's fields;
``--profile-dir DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json``.

``--mesh data:N`` trains data-parallel over N ranks (the ``Trainer``'s
``mesh``: global-batch BatchNorm, the gradients summed; the protocols put
their members over the ranks). Under ``torchrun`` the world size must be N;
launched alone the command starts N local ranks itself, one card a rank on
``cuda`` (NCCL; N above the card count raises), gloo ranks with ``--device
cpu``, after building the kernel library once::

    python -m pointcloud_orientation_tpu_torch.train.run --preset 8dir_kl \
        --mesh data:2 --device cpu --epochs 1 --num-points 256 --batch-size 4
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..data import OrientationDataset
from ..data.ply import write_ply_with_axes
from ..ops.dirs8 import DIRS_8
from ..viz.axes_export import axes_from_two_heads
from .config import PRESETS, preset
from .metrics import have_matplotlib, write_mvm_results_txt, write_summary_txt
from .reliability import PreemptionGuard
from .trainer import _EVAL, Trainer


def load_dataset(spec: str, num_points: int, classes=None) -> OrientationDataset:
    """``synthetic`` (64 clouds a class of ``max(num_points, 512)`` points),
    ``hdf5:DIR``, ``ply:DIR`` or ``plygt:DIR`` (with the sidecars)."""
    if spec == "synthetic":
        return OrientationDataset.synthetic(
            samples_per_class=64, num_points=max(num_points, 512),
            class_names=list(classes) if classes else None)
    if spec.startswith("hdf5:"):
        return OrientationDataset.from_hdf5(spec[len("hdf5:"):])
    if spec.startswith("ply:"):
        return OrientationDataset.from_ply_tree(spec[len("ply:"):], num_points)
    if spec.startswith("plygt:"):
        return OrientationDataset.from_ply_tree(spec[len("plygt:"):], num_points,
                                                load_sidecars=True)
    raise ValueError(f"unknown data spec: {spec} (use synthetic | hdf5:DIR | ply:DIR | plygt:DIR)")


# the tasks whose outputs _decode_axes turns into axes
DECODED_TASKS = ("axes", "8dir_mse", "8dir_kl", "forward_mse", "multi_8dir", "vm_kl", "mvm")


def _decode_axes(task: str, outputs, i: int):
    """Sample ``i``'s [side, up, forward] overlay from the model's outputs:
    the two heads' cross product (``axes``); a forward vector with the
    vertical up axis and ``side = up x forward`` from the 8-direction
    softmax times ``DIRS_8``, the forward heads' output, the vM mu or the
    heaviest MvM component's mu. None for a task without a direction (the
    classifier; :func:`export_test_predictions` asks only for
    ``DECODED_TASKS``)."""
    up = np.array([0.0, 1.0, 0.0])

    def from_forward(fwd):
        fwd = np.asarray(fwd, np.float64)
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        side = np.cross(up, fwd)
        side /= np.linalg.norm(side) + 1e-12
        return [side, up, fwd]

    if task == "axes":
        return axes_from_two_heads(np.asarray(outputs[0][i]), np.asarray(outputs[1][i]))
    if task in ("8dir_mse", "8dir_kl"):
        probs = torch.softmax(torch.as_tensor(outputs[i]), dim=-1).numpy()
        return from_forward(probs @ DIRS_8.numpy())
    if task in ("forward_mse", "multi_8dir"):
        return from_forward(outputs[i])
    if task == "vm_kl":
        mu = float(outputs[0][i])
        return from_forward([np.sin(mu), 0.0, -np.cos(mu)])
    if task == "mvm":
        mu_all, _, w = outputs
        mu = float(np.asarray(mu_all[i])[np.argmax(np.asarray(w[i]))])
        return from_forward([np.sin(mu), 0.0, -np.cos(mu)])
    return None


def _eval_batch(trainer: Trainer, n: int) -> Dict[str, torch.Tensor]:
    """The first ``n`` test clouds as an eval batch: subsampled and rotated
    by the trainer's eval generator of batch 0 (the JAX package draws them
    with its eval key of batch 0), the stored targets in place where the
    trainer takes them."""
    idx = np.arange(n)
    batch, _, _ = trainer.device_batch(trainer.test_ds, idx, np.ones(n, np.float32),
                                       trainer.generator(_EVAL, 0))
    return batch


def export_test_predictions(trainer: Trainer, out_dir: str, max_count: int = 10) -> int:
    """Write up to ``max_count`` test clouds, rotated as an eval batch, with
    the axes the current weights predict for them, to
    ``out_dir/sample_<i>_pred_<i+1>.ply``. Returns the count (0 for a task
    :func:`_decode_axes` does not cover)."""
    n = min(max_count, len(trainer.test_ds))
    if n == 0 or trainer.cfg.task not in DECODED_TASKS:
        return 0
    clouds = _eval_batch(trainer, n)["points"]
    outputs = trainer.predict(clouds)
    clouds = clouds.cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        write_ply_with_axes(clouds[i], _decode_axes(trainer.cfg.task, outputs, i),
                            os.path.join(out_dir, f"sample_{i}_pred_{i + 1}.ply"))
    return n


def _write_8dir_distribution_summary(trainer: Trainer, out_dir: str, max_count: int = 128):
    """Append the mean ground-truth and the mean predicted 8-direction
    distributions over up to ``max_count`` test clouds to
    ``out_dir/summary.txt``. The ground truth is the batch's, stored targets
    where the trainer takes them (the JAX function reads the synthesized
    targets there)."""
    n = min(max_count, len(trainer.test_ds))
    if n == 0:
        return
    batch = _eval_batch(trainer, n)
    logits = torch.as_tensor(trainer.predict(batch["points"]))
    pred = torch.softmax(logits, dim=-1).mean(0).numpy()
    gt = batch["probs_8dir"].mean(0).cpu().numpy()
    with open(os.path.join(out_dir, "summary.txt"), "a") as f:
        f.write("mean_gt_8dir\t" + " ".join(f"{v:.4f}" for v in gt) + "\n")
        f.write("mean_pred_8dir\t" + " ".join(f"{v:.4f}" for v in pred) + "\n")


def run_single(cfg, dataset: OrientationDataset, out_dir: str, device: str,
               fused_mlp_train: bool = False, label: Optional[str] = None, mesh=None):
    """Train under a :class:`.reliability.PreemptionGuard`, test the
    best-val weights and write the artifacts to ``out_dir``:
    ``metrics.json``, ``summary.txt``, ``loss_curve.png``, ``pred_ply/``,
    the 8-direction summary lines and, for ``mvm``, ``results.txt`` and
    ``figs/pred_density_<i>.png``. With ``mesh`` the trainer is
    data-parallel and rank 0 alone writes and prints."""
    trainer = Trainer(cfg, dataset, device=device, fused_mlp_train=fused_mlp_train, mesh=mesh)
    with PreemptionGuard() as guard:
        trainer.fit(checkpoint_dir=os.path.join(out_dir, "ckpt") if cfg.checkpoint_every
                    else None, preemption_guard=guard, log_every=1 if trainer.writes else 0)
    test_acc = trainer.test()
    if not trainer.writes:
        return trainer, test_acc
    trainer.write_artifacts(out_dir, test_acc)
    export_test_predictions(trainer, os.path.join(out_dir, "pred_ply"))
    if cfg.task in ("8dir_mse", "8dir_kl"):
        _write_8dir_distribution_summary(trainer, out_dir)
    print(f"[{label or cfg.task}] test loss {test_acc.mean_loss:.6f}  "
          f"angular {test_acc.mean_angular_error:.2f} deg  "
          f"best val {trainer.best_val:.6f} @ epoch {trainer.best_val_epoch}", flush=True)
    if cfg.task == "mvm":
        hist = {"total": {"train": trainer.history["train"], "val": trainer.history["val"]},
                **trainer.class_history}
        write_mvm_results_txt(os.path.join(out_dir, "results.txt"), trainer.class_names, hist,
                              test_kl=test_acc.mean_loss, best_val_epoch=trainer.best_val_epoch)
        n = min(4, len(trainer.test_ds))  # polar plots of a few test predictions
        if n and not have_matplotlib():
            print("figs/pred_density_*.png not written: no matplotlib", flush=True)
        elif n:
            from ..viz.polar import plot_predicted_density

            mu, kappa, w = trainer.predict(trainer.test_ds.points[:n, :trainer.num_points])
            for i in range(n):
                plot_predicted_density(mu[i], kappa[i], w[i],
                                       os.path.join(out_dir, "figs", f"pred_density_{i}.png"))
    return trainer, test_acc


def _completed_best_val(label_dir: str, epochs: int) -> Optional[float]:
    """best_val of a finished per-label run (``metrics.json`` with a full
    history at this epoch budget and a test block), else None."""
    try:
        with open(os.path.join(label_dir, "metrics.json")) as f:
            m = json.load(f)
        if len(m["history"]["val"]) == epochs and "test" in m:
            return float(m["best_val"])
    except (OSError, KeyError, ValueError, TypeError):
        pass
    return None


def run_per_label(cfg, dataset: OrientationDataset, out_dir: str, device: str,
                  fused_mlp_train: bool = False, resume: bool = False,
                  mesh=None) -> Dict[str, float]:
    """One model per category, in the dataset's label order: a fresh
    :class:`Trainer` (seeded from ``cfg.seed``) on
    ``dataset.select_classes([label])`` into ``out_dir/<label>``, and
    ``out_dir/summary.txt`` (label and best val loss) rewritten after each
    label. With ``resume``, a label whose ``metrics.json`` records a
    finished run at this epoch budget is skipped and its best val read
    back. Returns the best val loss by label (the JAX package's
    ``run_per_label``). With ``mesh`` each label trains data-parallel."""
    os.makedirs(out_dir, exist_ok=True)
    summary: Dict[str, float] = {}
    for label in dataset.class_names:
        sub_cfg = cfg.replace(classes=(label,), per_label=False)
        label_dir = os.path.join(out_dir, label)
        prior = _completed_best_val(label_dir, sub_cfg.epochs) if resume else None
        if prior is not None:
            summary[label] = prior
        else:
            trainer, _ = run_single(sub_cfg, dataset.select_classes([label]), label_dir, device,
                                    fused_mlp_train, label=label, mesh=mesh)
            summary[label] = trainer.best_val
        if mesh is None or torch.distributed.get_rank() == 0:
            write_summary_txt(os.path.join(out_dir, "summary.txt"), summary)
    return summary


def parse_mesh(spec: str):
    """``data:N`` (``N`` may be left out: every rank) as ``(axis, N)``."""
    axis, _, size = spec.partition(":")
    if axis != "data":
        raise SystemExit(f"--mesh {spec!r}: the CLI's mesh is data-parallel ('data:N')")
    return axis, int(size) if size else None


def launch_local_ranks(n: int, device: str, argv) -> int:
    """Start ``n`` ranks of this command on this machine (torchrun's
    variables on a free ``localhost`` port), one card a rank on ``cuda``,
    and wait for them; returns the first nonzero exit code, else 0. On
    ``cuda`` the kernel library is built once here first, so that the
    ranks load it instead of each running nvcc. ``SystemExit`` when ``n``
    exceeds the cards: NCCL puts one rank on a card."""
    import subprocess
    import sys

    from ..parallel.mesh import free_port

    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise SystemExit(f"--mesh data:{n} on cuda needs {n} cards, this machine has "
                             f"{count}: NCCL runs one rank a card (run the ranks on the CPU "
                             "with --device cpu, gloo)")
        from ..ops._build import load_library

        load_library()
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(n)}
    if torch.device(device).type == "cpu":  # the ranks share the cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    procs = [subprocess.Popen([sys.executable, "-m", "pointcloud_orientation_tpu_torch.train.run",
                               *argv], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(n)]
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), required=True)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--out", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None, dest="batch_size")
    ap.add_argument("--num-points", type=int, default=None, dest="num_points")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--classes", default=None, help="comma-separated override")
    ap.add_argument("--checkpoint-every", type=int, default=None, dest="checkpoint_every")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute-dtype", default=None, dest="compute_dtype",
                    help="trunk compute dtype: float32 (default) or bfloat16")
    ap.add_argument("--attention", default=None, dest="transformer_attention",
                    choices=("xla", "flash"),
                    help="transformer attention backend (flash = the flash kernels, O(N) "
                         "attention memory; the long-context path)")
    ap.add_argument("--fused-mlp-train", action="store_true", dest="fused_mlp_train",
                    help="train the shared MLPs through the fused MLP+max kernel and its "
                         "backward kernel with ghost-row BatchNorm statistics (the JAX "
                         "package's PCOT_FUSED_MLP=1)")
    ap.add_argument("--profile-dir", default=None, dest="profile_dir",
                    help="write a torch.profiler trace of the run to DIR/trace.json")
    ap.add_argument("--async-checkpoint", action="store_true", dest="async_checkpoint",
                    help="write periodic checkpoints on a background thread; fit waits for "
                         "the last write")
    ap.add_argument("--debug-checks", action="store_true", dest="debug_checks")
    ap.add_argument("--host-resident", action="store_true", dest="host_resident",
                    help="stream one batch a step from the host (splits larger than the "
                         "card) instead of keeping the splits on the device")
    ap.add_argument("--lr-schedule", default=None, dest="lr_schedule", choices=("cosine",),
                    help="learning-rate schedule (default: the reference's constant lr)")
    ap.add_argument("--warmup-epochs", type=int, default=None, dest="warmup_epochs")
    ap.add_argument("--vmap-labels", action="store_true", dest="vmap_labels",
                    help="a per-label preset's labels trained together (the JAX flag's name: "
                         "the port trains them in lockstep, one model after another each "
                         "epoch; see train/ensemble.py)")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds, e.g. 42,43,44: train every seed in lockstep "
                         "(single-model presets; writes seed_<s>/metrics.json and "
                         "seeds_summary.json; see train/multiseed.py)")
    ap.add_argument("--resume-from", default=None, dest="resume_from",
                    help="--seeds / --vmap-labels: continue from a protocol checkpoint's "
                         "step_<E> directory (written with --checkpoint-every)")
    ap.add_argument("--moe-dispatch", default=None, choices=("masked", "capacity"),
                    dest="moe_dispatch",
                    help="MoE FFN dispatch (moe_point_transformer): masked dense (the "
                         "default, every expert over every token) or the switch-style "
                         "capacity-factor gather (parallel/ep.py)")
    ap.add_argument("--mesh", default=None,
                    help="data:N - data-parallel over N ranks (global-batch BatchNorm, the "
                         "gradients summed): under torchrun the world must be N; launched "
                         "alone the command starts N local ranks itself, one card a rank on "
                         "cuda (NCCL), or gloo ranks with --device cpu")
    ap.add_argument("--knn", default=None, choices=("exact", "approx"),
                    help="neighbour selection: exact (the default) or approx (matmul-form "
                         "distances selected by the topk_min kernel; exact on the card)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        import sys

        from ..parallel import make_mesh

        axis, n = parse_mesh(args.mesh)
        launched = os.environ.get("WORLD_SIZE")
        if launched is None and n is not None and n > 1:
            raise SystemExit(launch_local_ranks(n, args.device,
                                                sys.argv[1:] if argv is None else list(argv)))
        if launched is not None and n is not None and int(launched) != n:
            raise SystemExit(f"--mesh data:{n} under a launch of {launched} ranks")
        kind = torch.device(args.device).type
        mesh = make_mesh((axis,), None if n is None else (n,), device=kind)
        if kind == "cuda":
            args.device = f"cuda:{torch.cuda.current_device()}"

    if args.knn:
        from ..ops import set_knn_impl

        set_knn_impl(args.knn)
    overrides = {k: getattr(args, k) for k in
                 ("epochs", "batch_size", "num_points", "lr", "seed", "checkpoint_every",
                  "compute_dtype", "transformer_attention", "lr_schedule", "warmup_epochs",
                  "moe_dispatch")
                 if getattr(args, k) is not None}
    for flag in ("debug_checks", "host_resident", "async_checkpoint"):
        if getattr(args, flag):
            overrides[flag] = True
    if args.classes:
        overrides["classes"] = tuple(args.classes.split(","))
    if args.data.startswith("plygt:"):
        overrides["rotation_mode"] = "none"  # train on the stored targets
    cfg = preset(args.preset, **overrides)
    dataset = load_dataset(args.data, cfg.num_points, classes=cfg.classes)
    out_dir = args.out or os.path.join(cfg.out_dir, "torch_" + args.preset)
    cfg = cfg.replace(out_dir=out_dir)  # debug_checks log beside the run's artifacts
    protocol = bool(args.seeds or (cfg.per_label and args.vmap_labels))
    if protocol:
        unsupported = []
        if cfg.async_checkpoint:
            unsupported.append("--async-checkpoint (the protocols' saves are synchronous)")
        if unsupported:
            warnings.warn("ignored by the protocols (--seeds / --vmap-labels): "
                          + "; ".join(unsupported), stacklevel=1)
    if args.resume_from and not protocol:
        raise SystemExit("--resume-from applies to the protocols only (--seeds / --vmap-labels); "
                         "sequential runs resume from the trainer's own checkpoints "
                         "(Trainer.restore_checkpoint, --checkpoint-every)")
    ckpt_dir = os.path.join(out_dir, "ckpt") if cfg.checkpoint_every else None
    kw = dict(device=args.device, fused_mlp_train=args.fused_mlp_train, mesh=mesh)
    profile = contextlib.nullcontext()
    if args.profile_dir:
        from ..utils.profiling import capture_trace

        profile = capture_trace(args.profile_dir)
    t0 = time.time()
    with profile:
        if args.seeds:
            from .multiseed import run_multi_seed

            with PreemptionGuard() as guard:
                run_multi_seed(cfg, dataset, [int(s) for s in args.seeds.split(",")], out_dir,
                               checkpoint_dir=ckpt_dir, resume_from=args.resume_from,
                               preemption_guard=guard, **kw)
        elif protocol:
            from .ensemble import run_per_label_vmapped

            with PreemptionGuard() as guard:
                run_per_label_vmapped(cfg, dataset, out_dir, checkpoint_dir=ckpt_dir,
                                      resume_from=args.resume_from, preemption_guard=guard,
                                      **kw)
        elif cfg.per_label:
            run_per_label(cfg, dataset, out_dir, **kw)
        else:
            run_single(cfg, dataset, out_dir, **kw)
    if mesh is None or torch.distributed.get_rank() == 0:
        print(f"done in {(time.time() - t0) / 60:.1f} min; artifacts in {out_dir}", flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
