"""Evaluation of trained weights (a reference-layout ``.pth``, the port's
own checkpoint or the JAX package's) on a dataset's test split: loss and
mean angular error.

Counterpart of ``pointcloud_orientation_tpu/train/evaluate.py``, the
cross-stack check: the same reference weights evaluated by both stacks on
the same clouds. ``--ckpt`` takes a checkpoint of the port's
``Trainer.save_checkpoint`` (a ``.pt`` file) or, as the JAX package's does,
an Orbax ``step_<N>`` directory of its ``Trainer.save_checkpoint``, read
without orbax (``Trainer.restore_checkpoint``).

    # reference weights on a pre-rotated tree with its sidecars
    python -m pointcloud_orientation_tpu_torch.train.evaluate --preset 8dir_kl \\
        --torch-ckpt results/8dir_KLdiv_0926.pth --data plygt:/path/to/tree

    # the port's own checkpoint, or a JAX one
    python -m pointcloud_orientation_tpu_torch.train.evaluate --preset 8dir_kl \\
        --ckpt results/torch_8dir_kl/ckpt/epoch_5.pt --data synthetic
    python -m pointcloud_orientation_tpu_torch.train.evaluate --preset 8dir_kl \\
        --ckpt results/8dir_kl/ckpt/step_100 --data synthetic
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from ..utils.torch_import import load_reference_state_dict
from .config import PRESETS, preset
from .run import load_dataset
from .trainer import Trainer


def evaluate(cfg, dataset, torch_ckpt: Optional[str] = None, ckpt: Optional[str] = None,
             device: str = "cuda") -> dict:
    """The test split's ``loss``, ``mean_angular_error_deg``, ``per_class``
    loss and ``count`` under ``cfg`` with the weights of ``torch_ckpt`` (a
    reference ``.pth`` of ``cfg.model``) or ``ckpt`` (the port's checkpoint
    or the JAX package's Orbax directory);
    with neither, the config's initial weights."""
    trainer = Trainer(cfg, dataset, device=device)
    if torch_ckpt:
        sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
        load_reference_state_dict(trainer.model, sd, cfg.model)
    elif ckpt:
        trainer.restore_checkpoint(ckpt)
    acc = trainer.run_phase(trainer.test_ds, train=False, epoch=0)
    return {"loss": acc.mean_loss, "mean_angular_error_deg": acc.mean_angular_error,
            "per_class": acc.per_class_mean(), "count": acc.count}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), required=True)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--torch-ckpt", default=None, dest="torch_ckpt")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--num-points", type=int, default=None, dest="num_points")
    ap.add_argument("--batch-size", type=int, default=None, dest="batch_size")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    overrides = {k: getattr(args, k) for k in ("num_points", "batch_size")
                 if getattr(args, k)}
    if args.data.startswith("plygt:"):
        overrides["rotation_mode"] = "none"  # the stored targets
    cfg = preset(args.preset, **overrides)
    dataset = load_dataset(args.data, cfg.num_points)
    result = evaluate(cfg, dataset, args.torch_ckpt, args.ckpt, device=args.device)
    print(json.dumps(result, indent=2, default=float), flush=True)
    return result


if __name__ == "__main__":
    main()
