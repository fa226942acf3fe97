"""Single-GPU trainer of the port: the yaw tasks on the PointNet++ heads
(8-dir, unit forward, von Mises, mixture of von Mises), the SO(3) tasks
(``forward_mse`` on ``PointNetPP`` and on the point transformer, ``axes``
on the two-axis heads) and the ModelNet40 classifier (task
``classification``, whose angular error is NaN). A model may hold
BatchNorm running statistics or, as the transformer, none: the step, the
checkpoint and the best-val snapshot go through ``state_dict``, which
holds whatever the model has.

Counterpart of ``pointcloud_orientation_tpu/train/trainer.py`` on its
step-by-step path (``_run_phase_stepwise``): seed -> split 70/15/15 -> per
epoch a train pass and a val pass -> best-val snapshot -> reload best ->
test pass -> artifacts (``loss_curve.png`` where matplotlib imports), with
checkpoint and resume, checkpoints written on a background thread
(``async_checkpoint``) and a preemption guard polled at each epoch's end
(:meth:`Trainer.fit`). The optimizer is the JAX package's optax chain: the
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
(:meth:`Trainer.device_batch`). ``debug_checks`` runs the JAX package's
per-step finite checks and ``debug_log.txt`` (:meth:`Trainer.debug_check`).
``host_resident`` changes nothing: this step path already gathers one batch
a step on the host, which is what the flag selects in the JAX package.
Not ported (ROADMAP.md): the whole-epoch scan and block paths (the JAX
package's answer to dispatch cost) and meshes.

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
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import OrientationDataset, augment_batch
from ..models import MODEL_REGISTRY
from ..ops.cuda_kernels import bf16_matmuls, f32_matmuls
from .config import TrainConfig
from .metrics import MetricsAccumulator, plot_loss_curves, write_summary_txt
from .tasks import TASKS

_TRAIN, _EVAL = 0, 1  # generator key streams


def flax_dense_init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Initialise every ``nn.Linear`` as flax's ``Dense`` does: LeCun-normal
    kernels (a normal truncated at two standard deviations, rescaled to
    variance 1/fan_in) and zero biases. BatchNorm keeps scale 1, bias 0."""
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            # the standard deviation of a unit normal truncated at +-2 is 0.8796...
            s = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
            with torch.no_grad():
                torch.nn.init.trunc_normal_(m.weight, 0.0, s, -2.0 * s, 2.0 * s,
                                            generator=generator)
                m.bias.zero_()


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
    model that takes ``gram_schmidt`` or ``normalize_heads``, and
    ``transformer_attention`` to a model that takes ``attention_impl``."""
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
    if config.model == "pointnet_pp_mvm":
        kwargs.update(max_K=config.max_k, weight_floor=config.mvm_weight_floor,
                      mu_init=config.mvm_mu_init)
    if config.model == "pointnet_pp_von_mises":
        kwargs["mu_parameterization"] = config.vm_mu_parameterization
    return kwargs


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
    p_drop=0.0``)."""

    def __init__(self, config: TrainConfig, dataset: OrientationDataset,
                 device: str | torch.device = "cuda", fused_mlp_train: bool = False,
                 **model_kwargs: Any):
        self.cfg = config
        self.device = torch.device(device)
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
        steps_per_epoch = max(1, -(-len(self.train_ds) // config.batch_size))
        self.lr_schedule = lr_schedule_for(config, steps_per_epoch)
        lr = config.lr if self.lr_schedule is None else self.lr_schedule(0)
        self.optimizer = make_optimizer(config, self.model.parameters(), lr)
        self._ckpt_writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._ckpt_pending: List[concurrent.futures.Future] = []
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

    def device_batch(self, ds: OrientationDataset, idx: np.ndarray, valid: np.ndarray,
                     generator: torch.Generator):
        """Gather a batch on the host, move it to the device and augment it
        there (subsample, rotation, targets, labels). A dataset's stored
        ``targets`` (a pre-rotated PLY tree's sidecars) replace the
        synthesized ones under ``rotation_mode="none"``, and are ignored
        under a rotation, as in the JAX trainer."""
        pts, labels, uniform, symm, k_spec = ds.gather_host(idx)
        pts = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(self.device)
        uniform, symm, k_spec = (torch.from_numpy(np.asarray(a)).to(self.device)
                                 for a in (uniform, symm, k_spec))
        batch = augment_batch(generator, pts, uniform, symm, k_spec, self.num_points,
                              self.cfg.rotation_mode, self.cfg.kappa_default, self.cfg.max_k)
        batch["labels"] = torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
        if ds.targets is not None and self.cfg.rotation_mode == "none":
            for k, v in ds.targets.items():
                batch[k] = torch.from_numpy(np.ascontiguousarray(v[idx])).to(self.device)
        return batch, torch.from_numpy(np.asarray(valid, np.float32)).to(self.device), labels

    # ---------- steps ----------

    def _metrics(self, outputs, batch, per, valid) -> Dict[str, Any]:
        scalar = (per * valid).sum() / valid.sum().clamp_min(1.0)
        if self.adapter.angular_error is None:  # classification: no angular error
            ang = torch.full_like(per, math.nan)
        else:
            ang = self.adapter.angular_error(outputs, batch, self.cfg)
        metrics = {"loss": scalar, "per_sample": per, "angular": ang}
        if self.cfg.debug_checks:  # the raw outputs, for debug_check's dump
            metrics["outputs"] = tuple(o.detach() for o in _outputs_tuple(outputs))
        return metrics

    def train_step(self, batch: Dict[str, torch.Tensor], valid: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """One optimizer step on a batch; ``generator`` feeds the centroid
        sampling and dropout. Returns detached loss, per-sample losses and
        angular errors; with ``debug_checks`` also the outputs and, per
        parameter, whether its gradient is finite (before clipping)."""
        self.model.train()
        outputs = self.model(batch["points"], generator)
        per = self.adapter.loss(outputs, batch, self.cfg)
        metrics = self._metrics(outputs, batch, per, valid)
        self.optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        if self.cfg.debug_checks:
            named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
            finite = torch.stack([torch.isfinite(g).all() for _, g in named])
            metrics["grad_finite"] = dict(zip((n for n, _ in named), finite))
        if self.cfg.grad_clip is not None:
            clip_by_global_norm_(self.model.parameters(), self.cfg.grad_clip)
        if self.lr_schedule is not None:  # optax reads the count before it increments
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], valid: torch.Tensor,
                  generator: Optional[torch.Generator]) -> Dict[str, Any]:
        self.model.eval()
        outputs = self.model(batch["points"], generator)
        return self._metrics(outputs, batch, self.adapter.loss(outputs, batch, self.cfg), valid)

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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_phase(self, ds: OrientationDataset, train: bool, epoch: int) -> MetricsAccumulator:
        """One pass over ``ds``. Per-step results stay on the device until
        the pass ends, so the host does not wait on the device every step
        (unless ``debug_checks`` reads them after each step)."""
        acc = MetricsAccumulator(self.class_names)
        pending = []
        n_clouds = 0.0
        t0 = time.perf_counter()
        for bi, (idx, valid, _) in enumerate(
                ds.batches(self.cfg.batch_size, shuffle=train, seed=self.cfg.seed + epoch)):
            gen = self.generator(_TRAIN, epoch, bi) if train else self.generator(_EVAL, bi)
            batch, valid_dev, labels = self.device_batch(ds, idx, valid, gen)
            step = self.train_step if train else self.eval_step
            m = step(batch, valid_dev, gen)
            if self.cfg.debug_checks:
                self.debug_check(m, epoch, bi)
            pending.append((m["loss"], m["per_sample"], m["angular"], labels, valid))
            n_clouds += float(valid.sum())
        self._sync()
        dt = time.perf_counter() - t0
        for loss, per, ang, labels, valid in pending:
            acc.update(per.cpu().numpy(), labels, valid, ang.cpu().numpy())
        if train:
            self.step_losses = [float(p[0]) for p in pending]
        phase = "train" if train else "eval"
        self.timings[f"{phase}_seconds"] = dt
        self.timings[f"{phase}_clouds_per_sec"] = n_clouds / max(dt, 1e-9)
        return acc

    # ---------- the protocol ----------

    def run_epoch(self, epoch: int):
        """One epoch: the train pass, the val pass, the histories and the
        best-val snapshot. Returns the two passes' accumulators."""
        tr = self.run_phase(self.train_ds, train=True, epoch=epoch)
        va = self.run_phase(self.val_ds, train=False, epoch=epoch)
        self.epoch = epoch
        self.history["train"].append(tr.mean_loss)
        self.history["val"].append(va.mean_loss)
        self.history["train_ang"].append(tr.mean_angular_error)
        self.history["val_ang"].append(va.mean_angular_error)
        for c, v in tr.per_class_mean().items():
            self.class_history[c]["train"].append(v)
        for c, v in va.per_class_mean().items():
            self.class_history[c]["val"].append(v)
        if va.mean_loss < self.best_val:
            self.best_val = va.mean_loss
            self.best_state = {k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()}
            self.best_val_epoch = epoch
        return tr, va

    def fit(self, epochs: Optional[int] = None, log_every: int = 1,
            checkpoint_dir: Optional[str] = None, start_epoch: int = 1,
            preemption_guard=None) -> Dict[str, List[float]]:
        """Train and validate from ``start_epoch`` to ``epochs`` inclusive.
        After :meth:`restore_checkpoint`, ``start_epoch = epoch + 1`` carries
        on exactly where an uninterrupted run would be. Periodic checkpoints
        (``checkpoint_every``) are written on a background thread under
        ``async_checkpoint``. ``preemption_guard`` (a
        :class:`.reliability.PreemptionGuard`) is polled at each epoch's
        end: when it fires, the run drains the writes in flight, saves a
        final checkpoint (with ``checkpoint_dir``) and returns early with a
        consistent history. Every write has finished when ``fit`` returns."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
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
        Overall)."""
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

    def save_checkpoint(self, directory: str, asynchronous: bool = False) -> str:
        """:meth:`state_payload` to ``directory/epoch_<E>.pt`` (see
        :func:`write_torch_file`). The copy to host memory is made here, in
        the caller's thread; ``asynchronous=True`` leaves the serialisation
        and the file write to a background thread, one write at a time in
        order, and returns at once. The file holds the same bytes either
        way. :meth:`wait_for_checkpoints` (``fit`` calls it) waits for the
        writes and raises a failed one's error."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"epoch_{self.epoch}.pt")
        payload = self.state_payload()
        if not asynchronous:
            write_torch_file(payload, path)
            return path
        if self._ckpt_writer is None:
            self._ckpt_writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._ckpt_pending.append(self._ckpt_writer.submit(write_torch_file, payload, path))
        return path

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
        """Load a checkpoint written by :meth:`save_checkpoint`; returns its
        epoch (resume with ``fit(start_epoch=epoch + 1)``). Read into host
        memory: the loads copy the weights and moments to the device, and
        the optimizer's step counts and the best-val snapshot stay on the
        host, as in a run that was never interrupted."""
        return self.load_payload(torch.load(path, map_location="cpu", weights_only=False))
