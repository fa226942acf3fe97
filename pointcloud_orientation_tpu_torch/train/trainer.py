"""Single-GPU trainer of the port: the yaw tasks on the PointNet++ heads
(8-dir, unit forward, von Mises, mixture of von Mises), the SO(3) tasks
(``forward_mse`` on ``PointNetPP``, ``axes`` on the two-axis heads) and the
ModelNet40 classifier (task ``classification``, whose angular error is NaN).

Counterpart of ``pointcloud_orientation_tpu/train/trainer.py`` on its
step-by-step path (``_run_phase_stepwise``): seed -> split 70/15/15 -> per
epoch a train pass and a val pass -> best-val snapshot -> reload best ->
test pass -> artifacts, with checkpoint and resume. Adam follows optax's
defaults (b1 0.9, b2 0.999, eps 1e-8), and the optional global-norm clip
optax's ``clip_by_global_norm``. The loss of a step is the masked mean
``sum(per * valid) / max(sum(valid), 1)`` over a batch whose tail is padded
by wrapping. Every random draw comes from a ``torch.Generator`` keyed by the
run's seed and the absolute epoch and step, so that a resumed run
reproduces an uninterrupted one. ``debug_checks`` runs the JAX package's
per-step finite checks and ``debug_log.txt`` (:meth:`Trainer.debug_check`).
Not ported yet (ROADMAP.md): the whole-epoch scan and block paths, meshes,
asynchronous checkpoints, preemption, host-resident streaming.

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

import copy
import dataclasses
import inspect
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data import OrientationDataset, augment_batch
from ..models import MODEL_REGISTRY
from ..ops.cuda_kernels import bf16_matmuls, f32_matmuls
from .config import TrainConfig
from .metrics import MetricsAccumulator, write_summary_txt
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


def config_model_kwargs(config: TrainConfig) -> Dict[str, Any]:
    """The model's constructor arguments that the config sets, as the JAX
    package's ``Trainer._build_model`` sets them: ``compute_dtype`` only to
    a model that takes a ``dtype`` (not the classifier, which stays f32),
    and the axes task's ``axes_gram_schmidt`` and ``axes_normalize_heads``
    to a model that takes ``gram_schmidt`` or ``normalize_heads``."""
    kwargs: Dict[str, Any] = {}
    takes = inspect.signature(MODEL_REGISTRY[config.model]).parameters
    if "dtype" in takes:
        kwargs["dtype"] = config.compute_dtype
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
    configuration (``models/layers.py``) and ``config.compute_dtype`` the
    trunk's compute type (parameters and Adam state stay f32);
    ``model_kwargs`` go to the model after the config's own
    (:func:`config_model_kwargs`; tests pass ``sampling="first",
    p_drop=0.0``)."""

    def __init__(self, config: TrainConfig, dataset: OrientationDataset,
                 device: str | torch.device = "cuda", fused_mlp_train: bool = False,
                 **model_kwargs: Any):
        if getattr(dataset, "targets", None) is not None:
            raise NotImplementedError(
                "stored sidecar targets (the JAX trainer's rotation_mode='none' on a "
                "pre-rotated PLY tree) are not ported; see ROADMAP.md queue 1 item 3")
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
        self.model = MODEL_REGISTRY[config.model](fused_mlp_train=fused_mlp_train, **kwargs)
        flax_dense_init_(self.model, torch.Generator().manual_seed(config.seed))
        if hasattr(self.model, "reset_head_parameters"):  # the MvM heads' zero inits
            self.model.reset_head_parameters()
        self.model.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
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
        there (subsample, rotation, targets, labels)."""
        pts, labels, uniform, symm, k_spec = ds.gather_host(idx)
        pts = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(self.device)
        uniform, symm, k_spec = (torch.from_numpy(np.asarray(a)).to(self.device)
                                 for a in (uniform, symm, k_spec))
        batch = augment_batch(generator, pts, uniform, symm, k_spec, self.num_points,
                              self.cfg.rotation_mode, self.cfg.kappa_default, self.cfg.max_k)
        batch["labels"] = torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
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

    def fit(self, epochs: Optional[int] = None, log_every: int = 1,
            checkpoint_dir: Optional[str] = None, start_epoch: int = 1) -> Dict[str, List[float]]:
        """Train and validate from ``start_epoch`` to ``epochs`` inclusive.
        After :meth:`restore_checkpoint`, ``start_epoch = epoch + 1`` carries
        on exactly where an uninterrupted run would be."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        t_start = time.time()
        for epoch in range(start_epoch, epochs + 1):
            t_ep = time.time()
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
            if checkpoint_dir and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir)
            if log_every and epoch % log_every == 0:
                eta = (time.time() - t_start) / (epoch - start_epoch + 1) * (epochs - epoch)
                print(f"Ep {epoch:03}/{epochs}  Train {tr.mean_loss:.4f}  Val {va.mean_loss:.4f}  "
                      f"ang(val) {va.mean_angular_error:.2f}deg  {time.time() - t_ep:.1f}s  "
                      f"ETA {eta / 60:.1f}m  ({self.timings['train_clouds_per_sec']:.0f} clouds/s)",
                      flush=True)
        return self.history

    def load_best(self) -> None:
        """Reload the best-val snapshot (weights and running statistics)."""
        if self.best_state is not None:
            self.model.load_state_dict(self.best_state)

    def test(self) -> MetricsAccumulator:
        self.load_best()
        return self.run_phase(self.test_ds, train=False, epoch=0)

    # ---------- artifacts and checkpoints ----------

    def write_artifacts(self, out_dir: str, test_acc: Optional[MetricsAccumulator] = None):
        """``metrics.json`` (config, history, best val, timings, test) and
        ``summary.txt`` (per-class loss, then Overall)."""
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
        if test_acc is not None:
            per_class, overall = test_acc.per_class_mean(), test_acc.mean_loss
        else:
            per_class = {c: h["val"][-1] if h["val"] else float("nan")
                         for c, h in self.class_history.items()}
            overall = self.history["val"][-1] if self.history["val"] else float("nan")
        write_summary_txt(os.path.join(out_dir, "summary.txt"), per_class, overall)

    def save_checkpoint(self, directory: str) -> str:
        """``torch.save`` of the model, the optimizer, the epoch and step,
        the history and the best-val snapshot to ``directory/epoch_<E>.pt``."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"epoch_{self.epoch}.pt")
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "step": self.step,
            "history": self.history,
            "class_history": self.class_history,
            "best_val": self.best_val,
            "best_val_epoch": self.best_val_epoch,
            "best_state": self.best_state,
        }, path)
        return path

    def restore_checkpoint(self, path: str) -> int:
        """Load a checkpoint written by :meth:`save_checkpoint`; returns its
        epoch (resume with ``fit(start_epoch=epoch + 1)``)."""
        ckpt = torch.load(path, map_location=self.device, weights_only=False)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.epoch, self.step = ckpt["epoch"], ckpt["step"]
        self.history = copy.deepcopy(ckpt["history"])
        self.class_history = copy.deepcopy(ckpt["class_history"])
        self.best_val, self.best_val_epoch = ckpt["best_val"], ckpt["best_val_epoch"]
        self.best_state = ckpt["best_state"]
        return self.epoch
