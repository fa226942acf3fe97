"""Ahead-of-time serving artifacts through ``torch.export`` (``.pt2``).

Counterpart of ``pointcloud_orientation_tpu/utils/stablehlo_export.py``
(the port's ``utils/torch_export.py`` is already the reference ``.pth``
writer, hence another name). :func:`export_orientation_model` traces a
model's eval forward into a ``torch.export.ExportedProgram`` with the
weights and batch statistics baked in: one argument, the clouds ``(B, N,
C)`` float32, and the model's native eval output (8-dir logits, ...).
``batch_size=None`` makes the batch dimension a ``torch.export.Dim``, so
one artifact serves any batch.

Properties of the artifact:

* **self-contained**: loading and running the default artifact needs only
  ``torch``, not this package or the model's class;
* **deterministic**: traced without a generator, so centroid sampling takes
  the first ``npoint`` points (the JAX artifact, exported without a
  ``"sampling"`` rng, does the same);
* **portable by default, on stock operations**: the trace runs on CPU
  tensors, where the kernels' wrappers run their plain PyTorch versions
  (the JAX artifact's portable default, which forces Pallas off), so the
  graph holds no ``pcot.*`` node; :func:`load_artifact` with
  ``device="cuda"`` moves it to the card, where it runs those stock
  operations;
* **or carrying the hand-written kernels**: ``use_kernels=True`` (the
  counterpart of ``use_pallas=True``, CLI ``--kernels``) traces with the
  forward kernels kept opaque (``kernel_mode("ops")``), so the graph holds
  one ``pcot.*`` node for each kernel launch an eager request makes. On
  the card each node launches its kernel; on the CPU it runs its plain
  version. Unlike the JAX package's Pallas artifact, which needs only
  ``jax``, such an artifact needs this package on the serving host:
  :func:`load_artifact` imports the op registrations before it loads.
  Under the grid kNN (``set_knn_impl("grid")``) either artifact holds the
  exactness certificate as a ``torch.cond`` (``ops/geometry.py``
  ``grid_pruned_knn``), as the JAX artifact holds a ``lax.cond``: the
  pruned neighbours, or the full exact kNN (``pcot.knn`` with kernels);
  the approximate kNN composes too.

Example
-------
    from pointcloud_orientation_tpu_torch.utils.aot_export import (
        export_orientation_model, save_artifact, load_artifact)

    ep = export_orientation_model("pointnet_pp_8dir", params, batch_stats,
                                  batch_size=None, num_points=1024)
    save_artifact("model.pt2", ep)

    # on the serving host (only torch required):
    import torch
    program = torch.export.load("model.pt2").module()
    logits = program(clouds)          # (B, 1024, 3) -> (B, 8)

CLI: ``python -m pointcloud_orientation_tpu_torch.utils.aot_export CKPT
OUT.pt2 --model pointnet_pp_8dir --batch-size 0 [--kernels]``, ``CKPT`` the port's
checkpoint (``Trainer.save_checkpoint``'s ``.pt``), a reference ``.pth`` or
the int8 ``.npz`` (dequantized to f32 before the trace).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..models import MODEL_REGISTRY
from ..ops import cuda_kernels as K  # registers the pcot ops that kernel artifacts call
from .jax_weights import load_flax_variables, model_kwargs as tree_kwargs, to_flax_variables


def build_model(model_name: str, params: Dict, batch_stats: Optional[Dict] = None,
                model_kwargs: Optional[Dict[str, Any]] = None) -> torch.nn.Module:
    """The port's ``model_name`` in eval mode on the CPU with the flax tree's
    weights, its constructor arguments those the tree fixes
    (:func:`.jax_weights.model_kwargs`) and then ``model_kwargs``."""
    kwargs = {**tree_kwargs(model_name, params), **(model_kwargs or {})}
    model = MODEL_REGISTRY[model_name](**kwargs)
    load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()


def export_orientation_model(
    model_name: str,
    params: Dict,
    batch_stats: Optional[Dict] = None,
    *,
    batch_size: Optional[int],
    num_points: int = 1024,
    model_kwargs: Optional[Dict[str, Any]] = None,
    use_kernels: bool = False,
) -> torch.export.ExportedProgram:
    """Export the eval forward of ``model_name`` with these weights as an
    ``ExportedProgram`` of one argument, the clouds ``(batch_size,
    num_points, C)`` float32 (``C`` the model's input width), traced on the
    CPU. ``batch_size=None`` exports a symbolic batch (any B >= 1).
    ``use_kernels``: the forward kernels as ``pcot.*`` nodes (module
    docstring), else their plain versions."""
    model = build_model(model_name, params, batch_stats, model_kwargs)
    channels = getattr(model, "in_channels", 3)
    example = torch.zeros((batch_size or 2, num_points, channels), dtype=torch.float32)
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad(), K.kernel_mode("ops" if use_kernels else "auto"):
        return torch.export.export(model, (example,), dynamic_shapes=dynamic)


def kernel_nodes(exported: torch.export.ExportedProgram) -> List[str]:
    """The ``pcot.*`` ops an artifact's graph calls, one entry a node: the
    top graph's, then each ``torch.cond`` branch's (the grid kNN's)."""
    return [n.target.name() for m in exported.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "pcot"]


def save_artifact(path: str, exported: torch.export.ExportedProgram) -> None:
    """Write ``exported`` to ``path`` (``.pt2``)."""
    torch.export.save(exported, path)


def load_artifact(path: str, device: Optional[str | torch.device] = None
                  ) -> torch.export.ExportedProgram:
    """Read an artifact; run it with ``.module()(clouds)``. ``device`` moves
    its weights, constants and the devices written into its graph there
    (``torch.export.passes.move_to_device_pass``); its clouds must then be
    on that device. The ``pcot`` ops are registered first (this module
    imports ``ops.cuda_kernels``), so a kernel artifact loads too."""
    exported = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, str(torch.device(device)))
    return exported


def read_checkpoint(path: str, model_name: str):
    """``(params, batch_stats)`` of a checkpoint, by its name: an int8
    ``.npz`` (dequantized), the port's own ``Trainer.save_checkpoint`` file
    ``.pt`` (its best-val weights where it has them; a pickle, read as
    ``Trainer.restore_checkpoint`` reads it, so only files this program
    wrote), a reference ``.pth`` (weights only) or a directory: an Orbax
    checkpoint of the JAX package's ``Trainer.save_checkpoint`` (or the
    port's ``Trainer.save_orbax_checkpoint``), its ``params`` and
    ``batch_stats`` as the JAX export CLI's ``--checkpoint DIR`` reads
    them (:func:`.orbax_format.read_pytree`)."""
    if os.path.isdir(path):
        from .orbax_format import read_pytree

        ckpt = read_pytree(path)
        return ckpt["params"], ckpt.get("batch_stats") or None
    if path.endswith(".npz"):
        import numpy as np

        from .quantize import load_quantized_checkpoint, map_leaves

        quantized, scales, stats = load_quantized_checkpoint(path)
        params = map_leaves(quantized, lambda k, v: (
            np.asarray(v, np.float32) * np.asarray(scales[k], np.float32) if k in scales
            else np.asarray(v)))
        return params, stats
    if path.endswith(".pt"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        module = MODEL_REGISTRY[model_name]()
        module.load_state_dict(ckpt["best_state"] if ckpt["best_state"] is not None
                               else ckpt["model"])
        tree = to_flax_variables(module)
        return tree["params"], tree["batch_stats"] or None
    from .torch_import import load_torch_checkpoint

    return load_torch_checkpoint(path, model_name)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: a checkpoint -> a ``.pt2`` serving artifact."""
    import argparse

    p = argparse.ArgumentParser(
        description="Export a trained checkpoint as a self-contained torch.export serving "
                    "artifact (.pt2).")
    p.add_argument("checkpoint", help="the port's checkpoint (.pt), a reference .pth, an "
                                      "int8 .npz or a JAX Orbax step_<N> directory")
    p.add_argument("output", help="output artifact path (.pt2)")
    p.add_argument("--model", default="pointnet_pp_8dir")
    p.add_argument("--batch-size", type=int, default=64,
                   help="fixed batch dimension; 0 = symbolic (any batch)")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--kernels", action="store_true",
                   help="keep the hand-written CUDA kernels as pcot ops (the artifact then "
                        "needs this package where it is served)")
    args = p.parse_args(argv)

    params, stats = read_checkpoint(args.checkpoint, args.model)
    exported = export_orientation_model(args.model, params, stats,
                                        batch_size=args.batch_size or None,
                                        num_points=args.num_points, use_kernels=args.kernels)
    save_artifact(args.output, exported)
    batch = str(args.batch_size) if args.batch_size else "b"
    print(f"wrote {args.output}: model={args.model} shape=({batch},{args.num_points},"
          f"{exported.example_inputs[0][0].shape[-1]}) kernels={len(kernel_nodes(exported))} "
          f"bytes={os.path.getsize(args.output)}")


if __name__ == "__main__":
    main()
