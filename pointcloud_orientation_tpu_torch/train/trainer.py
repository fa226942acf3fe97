"""Single-GPU trainer of the port: the yaw tasks on the PointNet++ heads
(8-dir, unit forward, von Mises, mixture of von Mises), the SO(3) tasks
(``forward_mse`` on ``PointNetPP`` and on the point transformer,
``forward_mse_aux`` on the MoE transformer's ``(out, aux)``, ``axes`` on
the two-axis heads) and the ModelNet40 classifier (task
``classification``, whose angular error is NaN). A model may hold
BatchNorm running statistics or, as the transformer, none: the step, the
checkpoint and the best-val snapshot go through ``state_dict``, which
holds whatever the model has.

Counterpart of ``pointcloud_orientation_tpu/train/trainer.py``: seed ->
split 70/15/15 -> per epoch a train pass and a val pass -> best-val
snapshot -> reload best -> test pass -> artifacts (``loss_curve.png`` where
matplotlib imports), with checkpoint and resume, checkpoints written on a
background thread (``async_checkpoint``) and a preemption guard
(:meth:`Trainer.fit`); the JAX package's Orbax checkpoints are read and
written too (:meth:`Trainer.restore_checkpoint` of a ``step_<N>``
directory, :meth:`Trainer.save_orbax_checkpoint`). The optimizer is the
JAX package's optax chain: the
optional global-norm clip (``clip_by_global_norm``), then Adam at optax's
defaults (b1 0.9, b2 0.999, eps 1e-8) or plain SGD (no momentum, no weight
decay), at a constant rate or on optax's ``warmup_cosine_decay_schedule``
(:func:`lr_schedule_for`), read at the update count before the update as
optax reads it. The loss of a step is the masked mean
``sum(per * valid) / max(sum(valid), 1)`` over a batch whose tail is padded
by wrapping. Every random draw comes from a ``torch.Generator`` keyed by the
run's seed and the absolute epoch and step, so that a resumed run
reproduces an uninterrupted one. A dataset's stored sidecar ``targets``
replace the synthesized ones under ``rotation_mode="none"``
(:meth:`Trainer.build_batch`). ``debug_checks`` runs the JAX package's
per-step finite checks and ``debug_log.txt`` (:meth:`Trainer.debug_check`).

The paths are the JAX trainer's, by its rules. By default each split is
kept on the device (:meth:`Trainer._resident`) and every step takes its
rows there by ``index_select``; :meth:`Trainer.fit` runs blocks of
``PCOT_EPOCH_BLOCK`` epochs (default 25; :meth:`Trainer._fit_blocks`) with
the best-val snapshot chosen on the device in float32 and the results read
once a block, and :meth:`Trainer.run_phase` (the per-epoch loop's, and
``test``'s) reads them once a pass. ``debug_checks`` and ``host_resident``
take the step path instead, which gathers one batch a step on the host and
copies it to the device (``host_resident``: splits larger than the card);
``checkpoint_dir`` with ``checkpoint_every`` takes the per-epoch loop,
whose best val is compared on the host in float64. A gather is exact, so
every path runs the same steps on the same batches, bit for bit.

Data parallelism (``mesh=``, a :func:`..parallel.make_mesh` mesh with a
``data`` axis) is the JAX trainer's global-batch arithmetic, written out:
every rank gathers and augments the whole batch from the same generator
and keeps its rows; inside the model the batch-shaped draws (centroids,
FPS starts, dropout masks) are made at the global shape and BatchNorm's
moments are all-reduced, differentiably (:mod:`..ops.batch_shard`), and
the MoE capacity dispatch gives each token its slot of the global batch's
layout (:mod:`..parallel.ep`); the
loss's valid count is the global one and the gradients are summed over
the ranks; per-sample results are gathered, so metrics and history are
the global batch's on every rank; rank 0 alone writes checkpoints and
artifacts. A DP epoch so equals the one-device epoch up to the order of
float sums (bit for bit at world size 1).

Example
-------
    from pointcloud_orientation_tpu_torch.data import OrientationDataset
    from pointcloud_orientation_tpu_torch.train import Trainer, preset

    trainer = Trainer(preset("8dir_kl", epochs=5),
                      OrientationDataset.synthetic(num_points=10_000))
    trainer.fit()
    print(trainer.test().mean_loss)
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import inspect
import io
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import OrientationDataset, augment_batch
from ..models import MODEL_REGISTRY
from ..models.layers import lecun_normal_
from ..ops.batch_shard import batch_shard
from ..ops.cuda_kernels import bf16_matmuls, f32_matmuls
from ..parallel.comm import all_gather_cat, all_reduce_grads
from ..parallel.ep import MoEFeedForward
from ..parallel.mesh import batch_sharding, replicate
from ..utils.jax_weights import _get as _leaf
from ..utils.jax_weights import _set as _set_leaf
from ..utils.jax_weights import (
    flax_parameter_paths,
    from_flax_layout,
    load_flax_variables,
    to_flax_layout,
    to_flax_variables,
)
from ..utils.orbax_format import read_pytree, write_pytree
from .config import TrainConfig
from .metrics import MetricsAccumulator, plot_loss_curves, write_summary_txt
from .tasks import TASKS

_TRAIN, _EVAL = 0, 1  # generator key streams


def flax_dense_init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Initialise every ``nn.Linear`` as flax's ``Dense`` does: LeCun-normal
    kernels (a normal truncated at two standard deviations, rescaled to
    variance 1/fan_in) and zero biases (the MoE router has none), and the
    MoE experts' stacked kernels as flax's ``lecun_normal`` does
    (:meth:`.MoEFeedForward.reset_parameters`). BatchNorm keeps scale 1,
    bias 0."""
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, MoEFeedForward):
            m.reset_parameters(generator)


def clip_by_global_norm_(params, max_norm: float) -> None:
    """Scale the gradients in place as ``optax.clip_by_global_norm``: kept
    when their global norm is below ``max_norm``, else ``g / norm * max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                  decay_steps: int, end_value: float = 0.0
                                  ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` as a function of the update
    count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` over the
    ``decay_steps - warmup_steps`` that follow (optax's ``decay_steps``
    counts the warmup), flat after. Raises optax's ``ValueError`` when no
    decay step is left."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax's linear_schedule (none when warmup_steps <= 0)
            return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value
        c = min(float(count - warmup_steps), cos_steps)
        return peak_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
                             + alpha)

    return schedule


def lr_schedule_for(config: TrainConfig, steps_per_epoch: int) -> Optional[Callable[[int], float]]:
    """The learning rate by update count that the JAX ``Trainer`` builds:
    None for ``lr_schedule=None`` (the constant ``config.lr``); for
    ``"cosine"``, :func:`warmup_cosine_decay_schedule` from 0 (``lr`` when
    there is no warmup) to ``lr`` over ``warmup_epochs`` epochs, then down
    to 0 at ``epochs``. Raises the JAX package's ``ValueError`` for another
    schedule."""
    if config.lr_schedule is None:
        return None
    if config.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule: {config.lr_schedule}")
    warmup = steps_per_epoch * config.warmup_epochs
    return warmup_cosine_decay_schedule(0.0 if warmup else config.lr, config.lr, warmup,
                                        steps_per_epoch * config.epochs)


def make_optimizer(config: TrainConfig, params, lr: float) -> torch.optim.Optimizer:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8) or ``sgd`` (no
    momentum, no weight decay) at ``lr``; the JAX package's ``ValueError``
    for another optimizer."""
    if config.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"unknown optimizer: {config.optimizer}")


def to_host(obj):
    """A copy of ``obj`` whose tensors are detached copies in host memory
    (dicts, lists and tuples copied through, other leaves deep-copied):
    what a checkpoint holds when the device and the lists keep changing."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return copy.deepcopy(obj)


def write_torch_file(payload: Dict[str, Any], path: str) -> None:
    """``torch.save`` of ``payload`` into memory, then its bytes to a
    temporary file renamed over ``path``: the bytes do not depend on the
    file's name or on which thread writes them, and a reader never sees
    half a file."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


def config_model_kwargs(config: TrainConfig) -> Dict[str, Any]:
    """The model's constructor arguments that the config sets, as the JAX
    package's ``Trainer._build_model`` sets them: ``compute_dtype`` only to
    a model that takes a ``dtype`` (not the classifier, which stays f32),
    the axes task's ``axes_gram_schmidt`` and ``axes_normalize_heads`` to a
    model that takes ``gram_schmidt`` or ``normalize_heads``,
    ``transformer_attention`` to a model that takes ``attention_impl``, and
    the MoE fields to a model that takes ``n_experts`` and ``dispatch``."""
    kwargs: Dict[str, Any] = {}
    takes = inspect.signature(MODEL_REGISTRY[config.model]).parameters
    if "dtype" in takes:
        kwargs["dtype"] = config.compute_dtype
    if "attention_impl" in takes:
        kwargs["attention_impl"] = config.transformer_attention
    if "gram_schmidt" in takes:
        kwargs["gram_schmidt"] = config.axes_gram_schmidt
    if "normalize_heads" in takes:
        kwargs["normalize_heads"] = config.axes_normalize_heads
    if "n_experts" in takes:
        kwargs["n_experts"] = config.moe_experts
    if "dispatch" in takes:
        kwargs.update(dispatch=config.moe_dispatch, capacity_factor=config.moe_capacity_factor)
    if config.model == "pointnet_pp_mvm":
        kwargs.update(max_K=config.max_k, weight_floor=config.mvm_weight_floor,
                      mu_init=config.mvm_mu_init)
    if config.model == "pointnet_pp_von_mises":
        kwargs["mu_parameterization"] = config.vm_mu_parameterization
    return kwargs


def _adam_step_dtype() -> torch.dtype:
    """The dtype of ``torch.optim.Adam``'s per-parameter ``step``."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def _outputs_tuple(outputs) -> tuple:
    return outputs if isinstance(outputs, tuple) else (outputs,)


class Trainer:
    """Builds the model and optimizer for a config on ``device`` ("cuda"
    unless the caller asks for the CPU) and runs the train/val/test
    protocol. ``fused_mlp_train`` selects the shared MLPs' train
    configuration (``models/layers.py``; the point transformer has none and
    ignores it, as the JAX package's ``PCOT_FUSED_MLP`` does) and
    ``config.compute_dtype`` the trunk's compute type (parameters and Adam
    state stay f32);
    ``model_kwargs`` go to the model after the config's own
    (:func:`config_model_kwargs`; tests pass ``sampling="first",
    p_drop=0.0``). ``mesh``: data parallelism over its ``data`` axis
    (module docstring); the batch size must divide over it. Raises
    ``ValueError`` for a ``bn_sync_axis`` (the JAX ``Trainer`` fails on
    it: a ``NameError`` for the unbound axis, with a mesh or without),
    ``TypeError`` for ``ring_point_transformer`` (its forward takes no
    train mode, as the JAX model's ``__call__`` takes no ``train``). The
    MoE capacity dispatch under a mesh lays its slots out on the global
    batch, as the JAX ``Trainer``'s one program does (``parallel/ep.py``)."""

    def __init__(self, config: TrainConfig, dataset: OrientationDataset,
                 device: str | torch.device = "cuda", fused_mlp_train: bool = False,
                 mesh=None, **model_kwargs: Any):
        if config.bn_sync_axis is not None:
            raise ValueError(
                f"bn_sync_axis={config.bn_sync_axis!r}: a data-parallel Trainer already takes "
                "BatchNorm's statistics over the global batch (the JAX Trainer's default under "
                "a mesh); leave it None")
        if config.model == "ring_point_transformer":
            raise TypeError("ring_point_transformer has no train mode for the Trainer; "
                            "train it with parallel.make_sp_train_step")
        self.cfg = config
        self.device = torch.device(device)
        self.sharding = None if mesh is None else batch_sharding(mesh, "data")
        self.writes = mesh is None or torch.distributed.get_rank() == 0
        if self.sharding is not None:
            if config.batch_size % self.sharding.world:
                raise ValueError(f"batch_size={config.batch_size} does not shard evenly over "
                                 f"the data axis of size {self.sharding.world}")
        self.dataset = dataset
        if config.classes is not None:
            wanted = [c for c in config.classes if c in dataset.class_names]
            if wanted and set(wanted) != set(dataset.class_names):
                self.dataset = dataset.select_classes(wanted)
        self.class_names = self.dataset.class_names
        self.train_ds, self.val_ds, self.test_ds = self.dataset.split(config.seed)
        self.adapter = TASKS[config.task]
        self.num_points = min(config.num_points, self.dataset.points.shape[1])

        f32_matmuls()  # the JAX side computes at HIGHEST f32: no TF32 in cuBLAS/cuDNN
        if config.compute_dtype == "bfloat16":
            bf16_matmuls()  # cuBLAS's bf16 products accumulate in f32, as XLA's
        kwargs = {**config_model_kwargs(config), **model_kwargs}
        model_cls = MODEL_REGISTRY[config.model]
        if "fused_mlp_train" in inspect.signature(model_cls).parameters:
            kwargs["fused_mlp_train"] = fused_mlp_train  # no shared MLP, no such option
        self.model = model_cls(**kwargs)
        flax_dense_init_(self.model, torch.Generator().manual_seed(config.seed))
        if hasattr(self.model, "reset_head_parameters"):  # the MvM heads' zero inits
            self.model.reset_head_parameters()
        self.model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        steps_per_epoch = max(1, -(-len(self.train_ds) // config.batch_size))
        self.lr_schedule = lr_schedule_for(config, steps_per_epoch)
        lr = config.lr if self.lr_schedule is None else self.lr_schedule(0)
        self.optimizer = make_optimizer(config, self.model.parameters(), lr)
        self._ckpt_writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._ckpt_pending: List[concurrent.futures.Future] = []
        self._resident_cache: List[tuple] = []  # (dataset, its split on the device)
        self.step = 0
        self.epoch = 0  # last completed epoch
        self.history: Dict[str, List[float]] = {"train": [], "val": [], "train_ang": [],
                                                "val_ang": []}
        self.class_history: Dict[str, Dict[str, List[float]]] = {
            c: {"train": [], "val": []} for c in self.class_names}
        self.best_val = float("inf")
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.best_val_epoch: Optional[int] = None
        self.step_losses: List[float] = []  # the last train pass, one per step
        self.timings: Dict[str, float] = {}

    # ---------- randomness and data ----------

    def generator(self, stream: int, *key: int) -> torch.Generator:
        """A generator on the device keyed by (seed, stream, *key): train
        steps take (epoch, step), eval batches (step) alone, so the val and
        test rotations are the same every epoch."""
        state = np.random.SeedSequence([self.cfg.seed, stream, *key]).generate_state(2)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
        return g

    def _split_rows(self, ds: OrientationDataset, idx: Optional[np.ndarray] = None
                    ) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` of ``ds`` (all of them when None) on the device, the
        arrays a batch is built from: ``points`` float32, ``labels`` int64,
        the class behaviour masks ``uniform``, ``symm``, ``k_spec``, and
        under ``rotation_mode="none"`` a dataset's stored ``targets`` (a
        pre-rotated PLY tree's sidecars) as ``tgt_<key>`` in their own
        dtypes; under a rotation those are ignored, as in the JAX trainer."""
        if idx is None:
            arrays = (ds.points, ds.labels, ds.uniform_mask, ds.symm_mask, ds.k_spec)
        else:
            arrays = ds.gather_host(idx)
        rows = dict(zip(("points", "labels", "uniform", "symm", "k_spec"), arrays))
        rows["points"] = np.asarray(rows["points"], np.float32)
        rows["labels"] = np.asarray(rows["labels"], np.int64)
        if ds.targets is not None and self.cfg.rotation_mode == "none":
            for k, v in ds.targets.items():
                rows[f"tgt_{k}"] = v if idx is None else v[idx]
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in rows.items()}

    def build_batch(self, rows: Dict[str, torch.Tensor], generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        """A batch from its rows on the device (:meth:`_split_rows`, or
        gathered from :meth:`_resident`): augmented (subsample, rotation,
        targets) from ``generator``, with the labels, and the stored
        targets over the synthesized ones. Both paths build every batch
        here, so the same rows and generator give the same batch."""
        batch = augment_batch(generator, rows["points"], rows["uniform"], rows["symm"],
                              rows["k_spec"], self.num_points, self.cfg.rotation_mode,
                              self.cfg.kappa_default, self.cfg.max_k)
        batch["labels"] = rows["labels"]
        for k, v in rows.items():
            if k.startswith("tgt_"):
                batch[k[len("tgt_"):]] = v
        return batch

    def device_batch(self, ds: OrientationDataset, idx: np.ndarray, valid: np.ndarray,
                     generator: torch.Generator):
        """Gather a batch on the host, move it to the device and build it
        there (:meth:`build_batch`). Returns the batch, the valid mask on
        the device and the labels on the host."""
        batch = self.build_batch(self._split_rows(ds, idx), generator)
        return (batch, torch.from_numpy(np.asarray(valid, np.float32)).to(self.device),
                np.asarray(ds.labels[idx], np.int64))

    def _resident(self, ds: OrientationDataset) -> Dict[str, torch.Tensor]:
        """The split on the device (:meth:`_split_rows` of all its rows),
        copied once and indexed there at every step. Cached by identity,
        the cache entry holding the dataset, so that a reused ``id`` cannot
        alias two datasets. Under a mesh every rank holds the whole split,
        and the step takes its rows of each global batch (:meth:`_rows`)."""
        for cached_ds, cached in self._resident_cache:
            if cached_ds is ds:
                return cached
        resident = self._split_rows(ds)
        self._resident_cache.append((ds, resident))
        return resident

    def _epoch_batches(self, ds: OrientationDataset, train: bool, epoch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pass's ``(nb, B)`` index matrix and float32 valid matrix on
        the device: the batches of ``ds.batches`` that the step path draws,
        shuffled by ``seed + epoch`` for training."""
        idx, valid = [], []
        for i, v, _ in ds.batches(self.cfg.batch_size, shuffle=train, seed=self.cfg.seed + epoch):
            idx.append(i)
            valid.append(v)
        empty = (0, self.cfg.batch_size)  # a split with no clouds
        return (torch.from_numpy(np.stack(idx) if idx else np.zeros(empty, np.int64)
                                 ).to(self.device),
                torch.from_numpy(np.stack(valid).astype(np.float32) if valid
                                 else np.zeros(empty, np.float32)).to(self.device))

    # ---------- steps ----------

    def _rows(self, batch: Dict[str, torch.Tensor], valid: torch.Tensor):
        """The rank's rows of a global batch (all of them on one device)."""
        if self.sharding is None:
            return batch, valid
        rows = self.sharding.rows(valid.shape[0])
        return {k: v[rows] for k, v in batch.items()}, valid[rows]

    def _forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        with batch_shard(self.sharding):
            return self.model(batch["points"], generator)

    def _metrics(self, outputs, batch, per, valid) -> Dict[str, Any]:
        """The step's results on the global batch. ``loss`` is the masked
        mean, which on a rank is its rows' share: their sum over the global
        valid count (summed over the ranks, the global loss, whose value is
        returned); per-sample losses and angular errors gathered."""
        count = valid.sum()
        if self.sharding is not None:
            torch.distributed.all_reduce(count, group=self.sharding.group)
        scalar = (per * valid).sum() / count.clamp_min(1.0)
        if self.adapter.angular_error is None:  # classification: no angular error
            ang = torch.full_like(per, math.nan)
        else:
            ang = self.adapter.angular_error(outputs, batch, self.cfg)
        metrics = {"loss": scalar, "per_sample": per, "angular": ang}
        if self.sharding is not None:
            group = self.sharding.group
            metrics["local_loss"] = scalar
            metrics["loss"] = scalar.detach().clone()
            torch.distributed.all_reduce(metrics["loss"], group=group)
            metrics["per_sample"] = all_gather_cat(per.detach(), group)
            metrics["angular"] = all_gather_cat(ang.detach(), group)
        if self.cfg.debug_checks:  # the raw outputs, for debug_check's dump
            metrics["outputs"] = tuple(o.detach() for o in _outputs_tuple(outputs))
        return metrics

    def train_step(self, batch: Dict[str, torch.Tensor], valid: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """One optimizer step on a (global) batch, of which a data-parallel
        rank runs its rows; ``generator`` feeds the centroid sampling and
        dropout. Returns detached loss, per-sample losses and
        angular errors; with ``debug_checks`` also the outputs and, per
        parameter, whether its gradient is finite (before clipping)."""
        self.model.train()
        batch, valid = self._rows(batch, valid)
        outputs = self._forward(batch, generator)
        per = self.adapter.loss(outputs, batch, self.cfg)
        metrics = self._metrics(outputs, batch, per, valid)
        self.optimizer.zero_grad(set_to_none=True)
        metrics.pop("local_loss", metrics["loss"]).backward()
        if self.sharding is not None:
            all_reduce_grads(self.model.parameters(), self.sharding.group)
        if self.cfg.debug_checks:
            named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
            finite = torch.stack([torch.isfinite(g).all() for _, g in named])
            metrics["grad_finite"] = dict(zip((n for n, _ in named), finite))
        self.optimizer_step()
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    def optimizer_step(self) -> None:
        """The optax chain's update from the parameters' ``.grad``: the
        global-norm clip (``grad_clip``), the schedule's rate at the update
        count (optax reads it before it increments), the optimizer's step,
        then the count."""
        if self.cfg.grad_clip is not None:
            clip_by_global_norm_(self.model.parameters(), self.cfg.grad_clip)
        if self.lr_schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.step)
        self.optimizer.step()
        self.step += 1

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], valid: torch.Tensor,
                  generator: Optional[torch.Generator]) -> Dict[str, Any]:
        self.model.eval()
        batch, valid = self._rows(batch, valid)
        outputs = self._forward(batch, generator)
        metrics = self._metrics(outputs, batch, self.adapter.loss(outputs, batch, self.cfg), valid)
        metrics.pop("local_loss", None)
        return metrics

    def debug_check(self, metrics: Dict[str, Any], epoch: int, batch_idx: int) -> None:
        """The JAX package's per-step finite checks (``Trainer._debug_check``),
        in its order: each model output must be finite; then one
        ``debug_log.txt`` entry in ``cfg.out_dir`` (loss, per-sample losses,
        the outputs of width <= 32, the gradients' finiteness); then the
        loss must be finite, then every parameter's gradient. Raises
        ``FloatingPointError`` naming the first non-finite value. Reads the
        step's results on the host: one device sync per step. (The JAX
        check also tests ``i0e``/``i1e`` of an output whose pytree path
        names "kappa"; the heads' tuple paths are "[0]", "[1]", ..., so it
        never runs there, and both are finite for a finite kappa.)"""
        loss = float(metrics["loss"])
        per = metrics["per_sample"].cpu().numpy()
        where = f"at epoch {epoch} batch {batch_idx}"
        outs = metrics.get("outputs")
        out_lines = []
        if outs is not None:
            # the JAX pytree paths: "out" for one array, "[i]" for a tuple's entries
            names = ["out"] if len(outs) == 1 else [f"[{i}]" for i in range(len(outs))]
            for name, leaf in zip(names, outs):
                arr = leaf.cpu().numpy()
                if not np.isfinite(arr).all():
                    raise FloatingPointError(f"non-finite model output {name} {where}: {arr}")
                if arr.ndim == 2 and arr.shape[1] <= 32:
                    out_lines.append(
                        f"  {name}={np.array2string(arr, precision=4, max_line_width=200)}")
        grad_finite = {n: bool(v) for n, v in metrics.get("grad_finite", {}).items()}
        if self.writes:  # the log is rank 0's; every rank checks
            try:
                os.makedirs(self.cfg.out_dir, exist_ok=True)
                with open(os.path.join(self.cfg.out_dir, "debug_log.txt"), "a") as f:
                    f.write(f"epoch={epoch} batch={batch_idx} loss={loss:.6f} "
                            f"per_sample={np.array2string(per, precision=4, max_line_width=200)}\n")
                    for line in out_lines:
                        f.write(line + "\n")
                    if "grad_finite" in metrics:
                        bad = [n for n, ok in grad_finite.items() if not ok]
                        f.write(f"  grads: {len(grad_finite)} params, "
                                f"non-finite: {bad if bad else 'none'}\n")
            except OSError:
                pass
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {where}: loss={loss}, per-sample={per}")
        for name, ok in grad_finite.items():
            if not ok:
                raise FloatingPointError(
                    f"non-finite grad in param {name} {where} (loss itself finite: {loss})")

    def run_phase(self, ds: OrientationDataset, train: bool, epoch: int) -> MetricsAccumulator:
        """One pass over ``ds`` (the JAX ``_run_phase``): from its resident
        copy (:meth:`_resident_pass`) unless ``debug_checks`` or
        ``host_resident`` asks for the step path, which gathers each batch
        on the host (:meth:`_run_phase_stepwise`). Either way the per-step
        results stay on the device until the pass ends."""
        if self.cfg.debug_checks or self.cfg.host_resident:
            return self._run_phase_stepwise(ds, train, epoch)
        resident = self._resident(ds)
        idx_mat, valid_mat = self._epoch_batches(ds, train, epoch)
        t0 = time.perf_counter()
        res = self._fetch([self._resident_pass(resident, idx_mat, valid_mat, train, epoch)],
                          [valid_mat])[0]
        return self._phase_result(res, train, time.perf_counter() - t0)

    def _resident_pass(self, resident: Dict[str, torch.Tensor], idx_mat: torch.Tensor,
                       valid_mat: torch.Tensor, train: bool, epoch: int
                       ) -> Dict[str, torch.Tensor]:
        """The steps of one pass, each batch's rows taken from the resident
        split on the device (``index_select``) and built from the step
        path's generator. Returns the stacked results on the device:
        ``loss (nb,)``, ``per_sample``, ``angular`` and ``labels`` ``(nb,
        B)``."""
        step = self.train_step if train else self.eval_step
        out: Dict[str, list] = {"loss": [], "per_sample": [], "angular": [], "labels": []}
        for bi in range(idx_mat.shape[0]):
            gen = self.generator(_TRAIN, epoch, bi) if train else self.generator(_EVAL, bi)
            batch = self.build_batch({k: v.index_select(0, idx_mat[bi])
                                      for k, v in resident.items()}, gen)
            m = step(batch, valid_mat[bi], gen)
            for k in ("loss", "per_sample", "angular"):
                out[k].append(m[k])
            out["labels"].append(batch["labels"])
        return self._stack(out)

    def _run_phase_stepwise(self, ds: OrientationDataset, train: bool, epoch: int
                            ) -> MetricsAccumulator:
        """One pass gathering one batch a step on the host (the JAX
        ``_run_phase_stepwise``): the debug path (``debug_checks`` reads
        each step's results) and the streaming path (``host_resident``:
        splits larger than the card)."""
        out: Dict[str, list] = {"loss": [], "per_sample": [], "angular": [], "labels": []}
        valids = []
        t0 = time.perf_counter()
        for bi, (idx, valid, _) in enumerate(
                ds.batches(self.cfg.batch_size, shuffle=train, seed=self.cfg.seed + epoch)):
            gen = self.generator(_TRAIN, epoch, bi) if train else self.generator(_EVAL, bi)
            batch, valid_dev, labels = self.device_batch(ds, idx, valid, gen)
            step = self.train_step if train else self.eval_step
            m = step(batch, valid_dev, gen)
            if self.cfg.debug_checks:
                self.debug_check(m, epoch, bi)
            for k in ("loss", "per_sample", "angular"):
                out[k].append(m[k])
            out["labels"].append(labels)
            valids.append(valid)
        out["labels"] = [torch.from_numpy(labels) for labels in out["labels"]]
        valid = np.stack(valids) if valids else np.zeros((0, self.cfg.batch_size), np.float32)
        res = self._fetch([self._stack(out)], [valid])[0]
        return self._phase_result(res, train, time.perf_counter() - t0)

    def _stack(self, out: Dict[str, list]) -> Dict[str, torch.Tensor]:
        """A pass's per-step results stacked, step first (empty ``(0, B)``
        for a split with no clouds)."""
        if out["loss"]:
            return {k: torch.stack(v) for k, v in out.items()}
        empty, dev = (0, self.cfg.batch_size), self.device
        return {"loss": torch.zeros(0, device=dev), "per_sample": torch.zeros(empty, device=dev),
                "angular": torch.zeros(empty, device=dev),
                "labels": torch.zeros(empty, dtype=torch.int64, device=dev)}

    @staticmethod
    def _fetch(passes: Sequence[Dict[str, Any]], valids: Sequence[Any]
               ) -> List[Dict[str, np.ndarray]]:
        """The passes' stacked results, each with its valid matrix, read to
        the host: the first read waits for the device, once."""
        return [{k: v.cpu().numpy() if torch.is_tensor(v) else v
                 for k, v in {**p, "valid": valid}.items()}
                for p, valid in zip(passes, valids)]

    def _accumulate(self, res: Dict[str, np.ndarray]) -> MetricsAccumulator:
        """A fetched pass as metrics, one update a step, as the step path
        has always summed them."""
        acc = MetricsAccumulator(self.class_names)
        for per, labels, valid, ang in zip(res["per_sample"], res["labels"], res["valid"],
                                           res["angular"]):
            acc.update(per, labels, valid, ang)
        return acc

    def _phase_result(self, res: Dict[str, np.ndarray], train: bool,
                      dt: float) -> MetricsAccumulator:
        if train:
            self.step_losses = res["loss"].tolist()
        phase = "train" if train else "eval"
        self.timings[f"{phase}_seconds"] = dt
        self.timings[f"{phase}_clouds_per_sec"] = float(res["valid"].sum()) / max(dt, 1e-9)
        return self._accumulate(res)

    # ---------- the protocol ----------

    def _record_epoch(self, epoch: int, tr: MetricsAccumulator, va: MetricsAccumulator) -> None:
        self.epoch = epoch
        self.history["train"].append(tr.mean_loss)
        self.history["val"].append(va.mean_loss)
        self.history["train_ang"].append(tr.mean_angular_error)
        self.history["val_ang"].append(va.mean_angular_error)
        for c, v in tr.per_class_mean().items():
            self.class_history[c]["train"].append(v)
        for c, v in va.per_class_mean().items():
            self.class_history[c]["val"].append(v)

    def run_epoch(self, epoch: int):
        """One epoch of the per-epoch loop: the train pass, the val pass,
        the histories and the best-val snapshot, chosen on the host in
        float64 as the JAX per-epoch loop does. Returns the two passes'
        accumulators."""
        tr = self.run_phase(self.train_ds, train=True, epoch=epoch)
        va = self.run_phase(self.val_ds, train=False, epoch=epoch)
        self._record_epoch(epoch, tr, va)
        if va.mean_loss < self.best_val:
            self.best_val = va.mean_loss
            self.best_state = {k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()}
            self.best_val_epoch = epoch
        return tr, va

    def _fit_blocks(self, epochs: int, log_every: int, start_epoch: int,
                    preemption_guard=None, checkpoint_dir: Optional[str] = None
                    ) -> Dict[str, List[float]]:
        """The JAX ``_fit_blocks``: blocks of ``PCOT_EPOCH_BLOCK`` epochs
        (default 25) on the resident splits, each epoch a train pass and a
        val pass keyed by its absolute number (so a resumed run reproduces
        an uninterrupted one), the best-val snapshot chosen on the device
        in float32 with no host read: ``vloss = sum(vper * valid) /
        max(sum(valid), 1)``, and where ``vloss < bv`` the weights and
        buffers, ``bv`` and the epoch taken by ``torch.where``. The host
        reads a block's results once, after it; the preemption guard is
        polled there, and a fired one saves the run's only checkpoint on
        this path (with ``checkpoint_dir``). ``timings`` as JAX's:
        ``train_seconds`` the block's time over its epochs, ``eval_seconds``
        0. The snapshot starts from ``best_state`` where a resumed run has
        one (JAX's starts from the current weights, which a resumed run
        that never improves would report as its best), copied to the
        device once a fit."""
        block = max(1, int(os.environ.get("PCOT_EPOCH_BLOCK", "25")))
        tr_res, va_res = self._resident(self.train_ds), self._resident(self.val_ds)
        va_idx, va_valid = self._epoch_batches(self.val_ds, False, 0)
        va_count = va_valid.sum().clamp_min(1.0)
        snapshot = self.model.state_dict() if self.best_state is None else self.best_state
        bp = {k: v.detach().to(self.device, copy=True) for k, v in snapshot.items()}
        bv = torch.full((), self.best_val, dtype=torch.float32, device=self.device)
        be = torch.full((), self.best_val_epoch or 0, dtype=torch.int64, device=self.device)
        t_start = time.time()
        epoch, preempted = start_epoch, False
        while epoch <= epochs:
            nums = list(range(epoch, min(epoch + block - 1, epochs) + 1))
            tr_batches = [self._epoch_batches(self.train_ds, True, e) for e in nums]
            t0 = time.perf_counter()
            passes = []
            for e, (idx_mat, valid_mat) in zip(nums, tr_batches):
                passes.append(self._resident_pass(tr_res, idx_mat, valid_mat, True, e))
                va = self._resident_pass(va_res, va_idx, va_valid, False, e)
                passes.append(va)
                vloss = ((va["per_sample"] * va_valid).sum() / va_count).float()
                better = vloss < bv
                bp = {k: torch.where(better, v.detach(), bp[k])
                      for k, v in self.model.state_dict().items()}
                bv, be = torch.where(better, vloss, bv), torch.where(better, e, be)
            res = self._fetch(passes, [v for _, tv in tr_batches for v in (tv, va_valid)])
            dt = time.perf_counter() - t0
            n_clouds = sum(float(r["valid"].sum()) for r in res[::2])
            self.timings["train_clouds_per_sec"] = n_clouds / max(dt, 1e-9)
            self.timings["train_seconds"] = dt / len(nums)
            self.timings["eval_seconds"] = 0.0
            self.step_losses = res[-2]["loss"].tolist()
            for j, e in enumerate(nums):
                tr, va = self._accumulate(res[2 * j]), self._accumulate(res[2 * j + 1])
                self._record_epoch(e, tr, va)
                if log_every and e % log_every == 0:
                    eta = (time.time() - t_start) / max(e - start_epoch + 1, 1) * (epochs - e)
                    print(f"Ep {e:03}/{epochs}  Train {tr.mean_loss:.4f}  Val {va.mean_loss:.4f}  "
                          f"ang(val) {va.mean_angular_error:.2f}deg  {dt / len(nums):.2f}s/ep  "
                          f"ETA {eta / 60:.1f}m  "
                          f"({self.timings['train_clouds_per_sec']:.0f} clouds/s)", flush=True)
            epoch = nums[-1] + 1
            if preemption_guard is not None and preemption_guard.requested:
                preempted = True
                print(f"[preempt] graceful stop after epoch {nums[-1]}"
                      + (f"; checkpoint in {checkpoint_dir}" if checkpoint_dir else ""),
                      flush=True)
                break
        if math.isfinite(float(bv)):
            self.best_val, self.best_val_epoch = float(bv), int(be)
            self.best_state = {k: v.cpu().clone() for k, v in bp.items()}
        if preempted and checkpoint_dir:
            self.save_checkpoint(checkpoint_dir)
        self.wait_for_checkpoints()
        return self.history

    def fit(self, epochs: Optional[int] = None, log_every: int = 1,
            checkpoint_dir: Optional[str] = None, start_epoch: int = 1,
            preemption_guard=None) -> Dict[str, List[float]]:
        """Train and validate from ``start_epoch`` to ``epochs`` inclusive.
        After :meth:`restore_checkpoint`, ``start_epoch = epoch + 1`` carries
        on exactly where an uninterrupted run would be. By the JAX rule the
        run takes the blocks (:meth:`_fit_blocks`) unless ``debug_checks``
        or ``host_resident`` is set or periodic checkpoints are written
        (``checkpoint_dir`` with ``checkpoint_every``): those take the
        per-epoch loop (:meth:`run_epoch`), whose checkpoints are written
        on a background thread under ``async_checkpoint``.
        ``preemption_guard`` (a :class:`.reliability.PreemptionGuard`) is
        polled at each epoch's or block's end: when it fires, the run
        drains the writes in flight, saves a final checkpoint (with
        ``checkpoint_dir``) and returns early with a consistent history.
        Every write has finished when ``fit`` returns."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        if not (cfg.debug_checks or cfg.host_resident or (checkpoint_dir and cfg.checkpoint_every)):
            return self._fit_blocks(epochs, log_every, start_epoch, preemption_guard,
                                    checkpoint_dir=checkpoint_dir)
        t_start = time.time()
        for epoch in range(start_epoch, epochs + 1):
            t_ep = time.time()
            tr, va = self.run_epoch(epoch)
            if checkpoint_dir and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir, asynchronous=cfg.async_checkpoint)
            if preemption_guard is not None and preemption_guard.requested:
                if checkpoint_dir:
                    # a write of this very epoch may be in flight to the same file
                    self.wait_for_checkpoints()
                    self.save_checkpoint(checkpoint_dir)
                print(f"[preempt] graceful stop after epoch {epoch}"
                      + (f"; checkpoint in {checkpoint_dir}" if checkpoint_dir else ""),
                      flush=True)
                break
            if log_every and epoch % log_every == 0:
                eta = (time.time() - t_start) / (epoch - start_epoch + 1) * (epochs - epoch)
                print(f"Ep {epoch:03}/{epochs}  Train {tr.mean_loss:.4f}  Val {va.mean_loss:.4f}  "
                      f"ang(val) {va.mean_angular_error:.2f}deg  {time.time() - t_ep:.1f}s  "
                      f"ETA {eta / 60:.1f}m  ({self.timings['train_clouds_per_sec']:.0f} clouds/s)",
                      flush=True)
        self.wait_for_checkpoints()
        return self.history

    def load_best(self) -> None:
        """Reload the best-val snapshot (weights and running statistics)."""
        if self.best_state is not None:
            self.model.load_state_dict(self.best_state)

    def test(self) -> MetricsAccumulator:
        self.load_best()
        return self.run_phase(self.test_ds, train=False, epoch=0)

    @torch.no_grad()
    def predict(self, points, generator: Optional[torch.Generator] = None):
        """One eval-mode forward pass of the current weights on raw ``(B, N,
        3)`` clouds (numpy or a tensor); returns the model's output as numpy
        (a tuple for the tuple heads). Random centroids come from
        ``generator``, by default one on the device seeded with 0."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.model.eval()
        out = self.model(torch.as_tensor(points, dtype=torch.float32, device=self.device),
                         generator)
        return tuple(o.cpu().numpy() for o in out) if isinstance(out, tuple) else out.cpu().numpy()

    # ---------- artifacts and checkpoints ----------

    def write_artifacts(self, out_dir: str, test_acc: Optional[MetricsAccumulator] = None):
        """``metrics.json`` (config, history, best val, timings, test),
        ``loss_curve.png`` (where matplotlib imports; else one printed line
        says it was not written) and ``summary.txt`` (per-class loss, then
        Overall). Only rank 0 of a data-parallel run writes."""
        if not self.writes:
            return
        os.makedirs(out_dir, exist_ok=True)
        payload = {
            "config": dataclasses.asdict(self.cfg),
            "history": self.history,
            "class_history": self.class_history,
            "best_val": self.best_val,
            "best_val_epoch": self.best_val_epoch,
            "timings": self.timings,
            "device": str(self.device),
        }
        if test_acc is not None:
            payload["test"] = {"loss": test_acc.mean_loss,
                               "mean_angular_error_deg": test_acc.mean_angular_error,
                               "per_class": test_acc.per_class_mean()}
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(payload, f, indent=2, default=float)
        try:
            plot_loss_curves(self.history["train"], self.history["val"],
                             os.path.join(out_dir, "loss_curve.png"), title=f"{self.cfg.task} loss")
        except ImportError as e:
            print(f"loss_curve.png not written: {e}", flush=True)
        if test_acc is not None:
            per_class, overall = test_acc.per_class_mean(), test_acc.mean_loss
        else:
            per_class = {c: h["val"][-1] if h["val"] else float("nan")
                         for c, h in self.class_history.items()}
            overall = self.history["val"][-1] if self.history["val"] else float("nan")
        write_summary_txt(os.path.join(out_dir, "summary.txt"), per_class, overall)

    def state_payload(self) -> Dict[str, Any]:
        """The whole training state in host memory: the model, the optimizer
        (moments and step count), the epoch and step, the histories and the
        best-val snapshot. Reads the device, so it waits for the work queued
        there."""
        return to_host({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "step": self.step,
            "history": self.history,
            "class_history": self.class_history,
            "best_val": self.best_val,
            "best_val_epoch": self.best_val_epoch,
            "best_state": self.best_state,
        })

    def load_payload(self, ckpt: Dict[str, Any]) -> int:
        """Restore a :meth:`state_payload`; returns its epoch."""
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.epoch, self.step = ckpt["epoch"], ckpt["step"]
        self.history = copy.deepcopy(ckpt["history"])
        self.class_history = copy.deepcopy(ckpt["class_history"])
        self.best_val, self.best_val_epoch = ckpt["best_val"], ckpt["best_val_epoch"]
        self.best_state = ckpt["best_state"]
        return self.epoch

    def _write(self, write: Callable, payload, path: str, asynchronous: bool) -> str:
        """``write(payload, path)`` now, or with ``asynchronous`` on the
        background writer thread (one write at a time, in order)."""
        if not asynchronous:
            write(payload, path)
            return path
        if self._ckpt_writer is None:
            self._ckpt_writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._ckpt_pending.append(self._ckpt_writer.submit(write, payload, path))
        return path

    def save_checkpoint(self, directory: str, asynchronous: bool = False) -> str:
        """:meth:`state_payload` to ``directory/epoch_<E>.pt`` (see
        :func:`write_torch_file`). The copy to host memory is made here, in
        the caller's thread; ``asynchronous=True`` leaves the serialisation
        and the file write to a background thread, one write at a time in
        order, and returns at once. The file holds the same bytes either
        way. :meth:`wait_for_checkpoints` (``fit`` calls it) waits for the
        writes and raises a failed one's error. Only rank 0 of a
        data-parallel run writes (the others return the path)."""
        path = os.path.join(directory, f"epoch_{self.epoch}.pt")
        if not self.writes:
            return path
        os.makedirs(directory, exist_ok=True)
        return self._write(write_torch_file, self.state_payload(), path, asynchronous)

    def wait_for_checkpoints(self) -> None:
        """Block until every asynchronous checkpoint write has finished,
        raise the first failed one's error, and stop the writer thread."""
        pending, self._ckpt_pending = self._ckpt_pending, []
        writer, self._ckpt_writer = self._ckpt_writer, None
        try:
            for future in pending:
                future.result()
        finally:
            if writer is not None:
                writer.shutdown(wait=True)

    def restore_checkpoint(self, path: str) -> int:
        """Load a checkpoint and return its epoch (resume with
        ``fit(start_epoch=epoch + 1)``): a file written by
        :meth:`save_checkpoint`, or a directory in the JAX package's Orbax
        layout (``step_<N>``, :meth:`load_flax_state`). A file is read into
        host memory: the loads copy the weights and moments to the device,
        and the optimizer's step counts and the best-val snapshot stay on
        the host, as in a run that was never interrupted."""
        if os.path.isdir(path):
            return self.load_flax_state(read_pytree(path))
        return self.load_payload(torch.load(path, map_location="cpu", weights_only=False))

    # ---------- the JAX package's Orbax checkpoints ----------

    def _check_chain(self, opt_state) -> Tuple[Any, Any]:
        """The optax chain's state of a JAX checkpoint, checked against this
        trainer's config: ``(first, lr)`` of the optimizer's own chain,
        ``first`` adam's ``{count, mu, nu}`` (or sgd's empty ``None``),
        ``lr`` the schedule's ``{count}`` (``None`` at a constant rate)."""
        parts = 2 if self.cfg.grad_clip is not None else 1
        if not isinstance(opt_state, list) or len(opt_state) != parts or (
                parts == 2 and opt_state[0] is not None):
            raise ValueError(f"the checkpoint's optax chain is not this config's "
                             f"({'clip_by_global_norm, ' if parts == 2 else ''}"
                             f"{self.cfg.optimizer}): {opt_state!r:.200}")
        inner = opt_state[-1]
        if not isinstance(inner, list) or len(inner) != 2:
            raise ValueError(f"the checkpoint's {self.cfg.optimizer} state is not a "
                             "(transform, learning rate) chain")
        first, lr = inner
        if (lr is None) != (self.lr_schedule is None) or (lr is not None and set(lr) != {"count"}):
            raise ValueError(f"the checkpoint's learning-rate state {lr!r:.100} does not match "
                             f"lr_schedule={self.cfg.lr_schedule!r}")
        adam = isinstance(first, dict) and set(first) == {"count", "mu", "nu"}
        if adam != (self.cfg.optimizer == "adam") or (not adam and first is not None):
            raise ValueError(f"the checkpoint's optimizer state does not match "
                             f"optimizer={self.cfg.optimizer!r}")
        return first, lr

    def flax_state(self) -> Dict[str, Any]:
        """The trainer's state as the JAX ``Trainer.save_checkpoint`` tree
        of numpy arrays, copied to the host: ``params`` and
        ``batch_stats`` in the flax layout (:func:`.to_flax_variables`),
        ``opt_state`` in the JAX optax chain's structure as orbax's bare
        restore gives it (a list a chain: ``[None]`` for the global-norm
        clip's empty state when ``grad_clip`` is set, then ``[adam, lr]``
        with adam's ``{"count", "mu", "nu"}`` (sgd: ``None``) and the
        schedule's ``{"count"}`` (``None`` at a constant rate)), ``step``.
        Every count is the update count, int32. Adam's moments are the
        torch optimizer's ``exp_avg`` and ``exp_avg_sq`` in each
        parameter's flax layout (zeros before its first update)."""
        variables = to_flax_variables(self.model)
        count = np.asarray(self.step, np.int32)
        if self.cfg.optimizer == "adam":
            mu: Dict = {}
            nu: Dict = {}
            for name, (path, shape, kind) in flax_parameter_paths(self.model).items():
                p = self.model.get_parameter(name)
                state = self.optimizer.state.get(p, {})
                for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                    t = state.get(key, torch.zeros_like(p)).detach()
                    _set_leaf(tree, path, to_flax_layout(t, shape, kind).cpu().numpy().copy())
            first = {"count": count.copy(), "mu": mu, "nu": nu}
        else:
            first = None
        lr = None if self.lr_schedule is None else {"count": count.copy()}
        opt_state = ([None] if self.cfg.grad_clip is not None else []) + [[first, lr]]
        return {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "opt_state": opt_state, "step": count}

    def load_flax_state(self, tree: Dict[str, Any]) -> int:
        """Load a JAX ``Trainer.save_checkpoint`` tree (as
        :func:`.orbax_format.read_pytree` reads it; :meth:`flax_state`'s
        layout) and return the epoch it implies.

        The weights and running statistics go through
        :func:`.load_flax_variables`; the optax chain, checked against the
        config (``ValueError`` where its clip, optimizer or schedule
        differs), becomes torch Adam's per-parameter ``step`` (adam's
        count, as a float tensor), ``exp_avg`` and ``exp_avg_sq`` (``mu``
        and ``nu`` by :func:`.from_flax_layout`), and ``step`` the
        trainer's update count, which places the learning-rate schedule.
        The next step so starts from the state the JAX package's resumed
        step starts from. A JAX protocol member (a tree with ``best_val``,
        ``best_params``, ``best_batch_stats`` and ``best_epoch``) also
        sets the best-val snapshot from its best weights, ``best_val``
        and ``best_val_epoch`` (None where ``best_val`` is not finite).

        The JAX checkpoint stores no epoch, no history and no best-val
        snapshot of the sequential trainer: the epoch returned and set is
        the number of whole epochs that its step count makes,
        ``step // steps_per_epoch``, which is the saved epoch for a
        checkpoint written at an epoch's end (as the JAX ``fit`` writes
        them); the histories stay as they are."""
        first, _ = self._check_chain(tree["opt_state"])
        load_flax_variables(self.model, {"params": tree["params"],
                                         "batch_stats": tree.get("batch_stats")})
        step = int(np.asarray(tree["step"]))
        if first is not None:
            count = float(np.asarray(first["count"]))
            for name, (path, shape, kind) in flax_parameter_paths(self.model).items():
                p = self.model.get_parameter(name)
                state = {"step": torch.tensor(count, dtype=_adam_step_dtype())}
                for key, src in (("exp_avg", first["mu"]), ("exp_avg_sq", first["nu"])):
                    arr = np.asarray(_leaf(src, path, "the checkpoint's adam state"), np.float32)
                    if arr.shape != shape:
                        raise ValueError(f"{'/'.join(path)}: adam moment of shape {arr.shape}, "
                                         f"the model expects {shape}")
                    t = from_flax_layout(torch.from_numpy(arr.copy()), tuple(p.shape), kind)
                    state[key] = t.to(device=p.device, dtype=p.dtype).contiguous()
                self.optimizer.state[p] = state
        else:
            self.optimizer.state.clear()
        if "best_params" in tree:
            best = copy.deepcopy(self.model)
            load_flax_variables(best, {"params": tree["best_params"],
                                       "batch_stats": tree.get("best_batch_stats")})
            self.best_state = {k: v.detach().cpu().clone() for k, v in best.state_dict().items()}
            self.best_val = float(np.asarray(tree["best_val"]))
            self.best_val_epoch = (int(np.asarray(tree["best_epoch"]))
                                   if math.isfinite(self.best_val) else None)
        steps_per_epoch = max(1, -(-len(self.train_ds) // self.cfg.batch_size))
        self.step, self.epoch = step, step // steps_per_epoch
        return self.epoch

    def save_orbax_checkpoint(self, directory: str, step: Optional[int] = None,
                              asynchronous: bool = False) -> str:
        """The JAX ``Trainer.save_checkpoint``: :meth:`flax_state` as an
        Orbax PyTree checkpoint at ``directory/step_<N>`` (``N`` the update
        count unless ``step`` is given), written by
        :func:`.orbax_format.write_pytree` with the chunks uncompressed;
        the JAX package's ``Trainer.restore_checkpoint`` and
        ``OrientationPredictor.from_orbax_checkpoint``, and orbax's bare
        restore, read it. Returns the path. The host copy is made here;
        ``asynchronous=True`` leaves the write to the background writer
        thread (:meth:`wait_for_checkpoints`). Only rank 0 of a
        data-parallel run writes."""
        step = int(self.step if step is None else step)
        path = os.path.join(os.path.abspath(directory), f"step_{step}")
        if not self.writes:
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return self._write(lambda tree, to: write_pytree(to, tree), self.flax_state(), path,
                           asynchronous)
