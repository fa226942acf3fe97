"""CLI: ``python -m pointcloud_orientation_tpu_torch.train.run``.

Counterpart of ``pointcloud_orientation_tpu/train/run.py`` for the flags
the port supports. Trains a preset (``pointnet_pp_forward``,
``point_transformer`` (``--attention xla|flash``), ``axes_all_labels``,
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

Data: ``synthetic`` only (the HDF5 and PLY sources are not ported yet).
The grid-pruned kNN is reached through ``PCOT_KNN=grid``, as in the JAX
package (whose ``--knn`` flag offers only ``exact`` and the unported
``approx``). The vmapped protocols (``--seeds``, ``--vmap-labels``,
``--resume-from``) are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

from ..data import OrientationDataset
from .config import PRESETS, preset
from .metrics import write_summary_txt
from .trainer import Trainer


def load_dataset(spec: str, num_points: int, classes=None) -> OrientationDataset:
    if spec == "synthetic":
        return OrientationDataset.synthetic(
            samples_per_class=64, num_points=max(num_points, 512),
            class_names=list(classes) if classes else None)
    raise NotImplementedError(f"data {spec!r} is not ported; the port takes 'synthetic'")


def run_single(cfg, dataset: OrientationDataset, out_dir: str, device: str,
               fused_mlp_train: bool = False, label: Optional[str] = None):
    """Train, test the best-val weights and write the artifacts to ``out_dir``."""
    trainer = Trainer(cfg, dataset, device=device, fused_mlp_train=fused_mlp_train)
    trainer.fit(checkpoint_dir=os.path.join(out_dir, "ckpt") if cfg.checkpoint_every else None)
    test_acc = trainer.test()
    trainer.write_artifacts(out_dir, test_acc)
    print(f"[{label or cfg.task}] test loss {test_acc.mean_loss:.6f}  "
          f"angular {test_acc.mean_angular_error:.2f} deg  "
          f"best val {trainer.best_val:.6f} @ epoch {trainer.best_val_epoch}", flush=True)
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
                  fused_mlp_train: bool = False, resume: bool = False) -> Dict[str, float]:
    """One model per category, in the dataset's label order: a fresh
    :class:`Trainer` (seeded from ``cfg.seed``) on
    ``dataset.select_classes([label])`` into ``out_dir/<label>``, and
    ``out_dir/summary.txt`` (label and best val loss) rewritten after each
    label. With ``resume``, a label whose ``metrics.json`` records a
    finished run at this epoch budget is skipped and its best val read
    back. Returns the best val loss by label (the JAX package's
    ``run_per_label``)."""
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
                                    fused_mlp_train, label=label)
            summary[label] = trainer.best_val
        write_summary_txt(os.path.join(out_dir, "summary.txt"), summary)
    return summary


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
    args = ap.parse_args(argv)

    overrides = {k: getattr(args, k) for k in
                 ("epochs", "batch_size", "num_points", "lr", "seed", "checkpoint_every",
                  "compute_dtype", "transformer_attention")
                 if getattr(args, k) is not None}
    if args.classes:
        overrides["classes"] = tuple(args.classes.split(","))
    cfg = preset(args.preset, **overrides)
    dataset = load_dataset(args.data, cfg.num_points, classes=cfg.classes)
    out_dir = args.out or os.path.join(cfg.out_dir, "torch_" + args.preset)
    cfg = cfg.replace(out_dir=out_dir)  # debug_checks log beside the run's artifacts
    t0 = time.time()
    run = run_per_label if cfg.per_label else run_single
    run(cfg, dataset, out_dir, args.device, args.fused_mlp_train)
    print(f"done in {(time.time() - t0) / 60:.1f} min; artifacts in {out_dir}", flush=True)


if __name__ == "__main__":
    main()
