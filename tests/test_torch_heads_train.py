"""One train step of each yaw-distribution task in the port (``multi_8dir``,
``vm_kl``, ``mvm`` with ``unmatched_penalty``) against the JAX package's
step on the same variables and batch, every preset of the slice on the
port's Trainer, and the ``mvm_debug`` finite checks."""

import math
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.data import gt as jax_gt
from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.config import preset as jax_preset
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)

SEED = 42
B, N = 8, 256
# task -> (preset, model, the JAX model's options, random_flax_variables options)
_TASKS = {
    "multi_8dir": ("multi_8dir", "pointnet_pp_fwd", {}, {}),
    "vm_kl": ("vm_kl_atan2", "pointnet_pp_von_mises", {"mu_parameterization": "atan2"},
              {"mu_parameterization": "atan2"}),
    "mvm": ("mvm_guarded", "pointnet_pp_mvm", {}, {}),
}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _norm_excess(got, want) -> float:
    """As in tests/test_torch_train_step.py: how far ``got`` lies from
    ``want`` in norm beyond 1e-5 per entry, relative to ``want``'s norm."""
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


def _inputs(task, seed=SEED):
    """Variables (the MvM heads at their flax init: zero kernels, so the
    first step passes through the guarded angle's zero point) and a batch
    of B=8 clouds of N=256 points, the last sample padded, with every
    target the JAX pipeline makes from a yaw rotation."""
    _, model, _, vkw = _TASKS[task]
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed, model, **vkw)
    if model == "pointnet_pp_mvm":
        for head in ("head_pi", "head_mu"):
            v["params"][head]["kernel"][:] = 0.0
            v["params"][head]["bias"][:] = 0.0
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, B)
    side = np.stack([-np.cos(theta), 0 * theta, np.sin(theta)], -1).astype(np.float32)
    fwd = np.stack([-np.sin(theta), 0 * theta, -np.cos(theta)], -1).astype(np.float32)
    uniform = np.arange(B) % 4 == 1
    symm = np.arange(B) % 3 == 0
    k_spec = np.asarray([0, 1, 2, 4, 1, 2, 4, 0], np.int32)
    f, s = jnp.asarray(fwd), jnp.asarray(side)
    batch = {"forward": fwd, "probs_8dir": jax_gt.eight_dir_gt(f, jnp.asarray(uniform))}
    batch["vm_mu"], batch["vm_kappa"] = jax_gt.single_peak_gt(f, jnp.asarray(symm))
    (batch["mvm_mu"], batch["mvm_kappa"], batch["mvm_weight"],
     batch["mvm_k"]) = jax_gt.mvm_gt(s, f, jnp.asarray(k_spec))
    batch = {k: np.array(a) for k, a in batch.items()}
    valid = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    return v, pts, batch, valid


_JAX_STEPS = {}


def _jax_loss_fn(task, dtype, seed=SEED):
    """The JAX model's train-mode loss of ``task``'s inputs as a function of
    the parameters, computed in ``dtype`` (dropout off: ``nn.Dropout`` made
    the identity, the two frameworks' dropout streams differ; centroids
    ``"first"``), and the parameters. Call it inside ``jax.enable_x64``."""
    name, model_name, kw, _ = _TASKS[task]
    cfg = jax_preset(name)
    adapter = jax_tasks.TASKS[cfg.task]
    v, pts, batch, valid = _inputs(task, seed)
    model = JAX_MODELS[model_name](sampling="first", **kw)
    cast = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype if a.dtype == np.float32 else a.dtype),
        {"v": v, "pts": pts, "batch": batch, "valid": valid})

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": cast["v"]["batch_stats"]},
                               cast["pts"], train=True, mutable=["batch_stats"])
        per = adapter.loss(out, cast["batch"], cfg)
        valid_ = cast["valid"]
        return jnp.sum(per * valid_) / jnp.maximum(jnp.sum(valid_), 1.0), mut["batch_stats"]

    return loss_fn, cast["v"]["params"]


def _jax_step(task):
    """Loss, batch statistics and gradients of the JAX model's train step in
    float64 (the XLA path), and the loss of the same step in float32."""
    if task in _JAX_STEPS:
        return _JAX_STEPS[task]
    with jax.enable_x64(True), mock.patch.object(fnn.Dropout, "__call__",
                                                 lambda self, x, *a, **k: x):
        loss_fn, params = _jax_loss_fn(task, jnp.float64)
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        loss_fn, params = _jax_loss_fn(task, jnp.float32)
        loss32 = jax.jit(loss_fn)(params)[0]
        _JAX_STEPS[task] = jax.tree_util.tree_map(np.asarray, (loss, stats, grads, loss32))
    return _JAX_STEPS[task]


def _loss_rtol(want_loss, jax_f32_loss) -> float:
    """The bound on the port's float32 loss, relative to the float64 one:
    1e-5, or the JAX float32 step's own distance from float64 on the same
    inputs where that is larger. At seed 42 the multi_8dir step's loss is
    ill-conditioned in float32 (a KL of near-equal distributions): the JAX
    float32 step's loss lies 7.5e-5 from float64 and the port's 1.4e-5 on an
    x86 CPU with AVX-512 (under 1e-5 on others), while at every stage of the
    forward the port lies 10-20x nearer to float64 than JAX's float32
    (ROADMAP.md, queue 3, "A limit of float32 comparisons")."""
    want = float(want_loss)
    return max(1e-5, abs(float(jax_f32_loss) - want) / abs(want))


def _tiny_trainer(name, **cfg):
    c = preset(name, batch_size=4, num_points=N, epochs=1, **cfg)
    ds = OrientationDataset.synthetic(samples_per_class=2, num_points=N,
                                      class_names=list(c.classes))
    return Trainer(c, ds, device="cpu", sampling="first", p_drop=0.0)


@pytest.mark.parametrize("task", list(_TASKS))
def test_train_step_matches_jax_f64_step(task):
    """The port's float32 Trainer step against the JAX float64 step, the
    bounds of tests/test_torch_train_step.py's float32-vs-float64 modes:
    loss within 1e-5 relative (or the JAX float32 loss's own distance from
    float64, ``_loss_rtol``), running statistics within 2e-6, each
    gradient leaf within 3e-2 relative in norm beyond 1e-5 per entry (read
    over seeds 0-4: at most 4.8e-6, 1.4e-6 and 1.6e-2, the last the MvM
    step's). The
    ``mvm`` step takes ``mvm_guarded``'s ``unmatched_penalty=1`` and starts
    at the MvM heads' zero-init point, where every gradient must be finite
    (the guarded angle's gradient there is 0 on both sides)."""
    want_loss, want_stats, want_grads, jax_f32_loss = _jax_step(task)
    v, pts, batch, valid = _inputs(task)
    trainer = _tiny_trainer(_TASKS[task][0], grad_clip=None)  # .grad before any clipping
    load_flax_variables(trainer.model, v)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    tb["points"] = torch.from_numpy(pts)
    m = trainer.train_step(tb, torch.from_numpy(valid), None)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                               rtol=_loss_rtol(want_loss, jax_f32_loss))
    got_grads = to_flax_variables(trainer.model, grads=True)["params"]
    for (path, g), (_, w) in zip(_leaves(got_grads), _leaves(want_grads)):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(g).all(), name
        assert _norm_excess(g, w) <= 3e-2, (name, _norm_excess(g, w))
    got_stats = to_flax_variables(trainer.model)["batch_stats"]
    for (path, g), (_, w) in zip(_leaves(got_stats), _leaves(want_stats)):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=jax.tree_util.keystr(path))
    assert len(_leaves(got_stats)) == len(_leaves(want_stats)) == 3 * 3 * 2 + (
        0 if task == "mvm" else 2 * 2)


@pytest.mark.parametrize("name", ["multi_8dir", "vm_kl", "vm_kl_atan2", "mvm", "mvm_guarded",
                                  "mvm_spread", "mvm_robust", "mvm_debug"])
def test_preset_builds_and_trains_a_step(tmp_path, name):
    """Every preset of the slice builds its model from the config as the
    JAX ``_build_model`` does, with the JAX preset's fields, and takes a
    finite train step; parameters and Adam state stay float32."""
    theirs = jax_preset(name)
    ours = preset(name, out_dir=str(tmp_path))
    for field in ("task", "model", "classes", "epochs", "grad_clip", "num_points",
                  "mvm_unmatched_penalty", "mvm_weight_floor", "mvm_mu_init",
                  "vm_mu_parameterization", "debug_checks", "kappa_default", "max_k"):
        assert getattr(ours, field) == getattr(theirs, field), field
    trainer = _tiny_trainer(name, out_dir=str(tmp_path))
    model = trainer.model
    if ours.model == "pointnet_pp_mvm":
        assert model.weight_floor == ours.mvm_weight_floor and model.mu_init == ours.mvm_mu_init
        assert not model.head_pi.weight.any() and not model.head_mu.weight.any()
    if ours.model == "pointnet_pp_von_mises":
        assert model.mu_parameterization == ours.vm_mu_parameterization
    ds = trainer.train_ds
    idx, valid, _ = next(ds.batches(4))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    m = trainer.train_step(batch, valid, trainer.generator(0, 1, 0))
    assert math.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in model.parameters())
    assert all(t.dtype == torch.float32 for st in trainer.optimizer.state.values()
               for t in st.values() if t.dim())


def test_mvm_debug_logs_each_step_and_raises_on_planted_nans(tmp_path):
    """``mvm_debug``: each step appends its loss, per-sample losses, the
    (B, K) outputs and the gradients' finiteness to ``debug_log.txt``; a
    NaN planted in the kappa head raises ``FloatingPointError`` at the
    output check, a NaN planted in one gradient at the gradient check."""
    trainer = _tiny_trainer("mvm_debug", out_dir=str(tmp_path))
    ds = trainer.train_ds
    idx, valid, _ = next(ds.batches(4))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    trainer.debug_check(trainer.train_step(batch, valid, None), 1, 0)
    log = (tmp_path / "debug_log.txt").read_text().splitlines()
    assert log[0].startswith("epoch=1 batch=0 loss=")
    assert any(line.startswith("  [0]=[[") for line in log)  # mu (B, K)
    n_params = len(list(trainer.model.parameters()))
    assert log[-1] == f"  grads: {n_params} params, non-finite: none"

    hook = trainer.model.head_kappa.bias.register_hook(lambda g: torch.full_like(g, math.nan))
    m = trainer.train_step(batch, valid, None)
    hook.remove()
    with pytest.raises(FloatingPointError, match="non-finite grad in param head_kappa.bias"):
        trainer.debug_check(m, 1, 1)
    assert "non-finite: ['head_kappa.bias']" in (tmp_path / "debug_log.txt").read_text()

    trainer = _tiny_trainer("mvm_debug", out_dir=str(tmp_path))
    with torch.no_grad():
        trainer.model.head_kappa.bias.fill_(math.nan)
    with pytest.raises(FloatingPointError, match=r"non-finite model output \[1\] at epoch 1"):
        trainer.fit(epochs=1, log_every=0)


@pytest.mark.parametrize("name,calls,p", [("pointnet_pp_mvm", 2, 0.4),
                                          ("pointnet_pp_von_mises", 1, 0.5)])
def test_trunk_dropout_placement_and_rate(name, calls, p):
    """The dropout streams of the two frameworks differ, so the train
    steps above run with p_drop = 0 and the masks are held here: the MvM
    trunk drops after each FC (``drop_each_fc``) at its p_drop of 0.4, the
    BatchNorm trunk once, after fc2, at 0.5; each mask keeps a share within
    0.05 of 1 - p (B=8 x 256-512 features: over 4 standard deviations) and
    scales the kept entries by 1 / (1 - p)."""
    from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY, layers

    model = MODEL_REGISTRY[name](sampling="first").train()
    seen = []
    real = layers.dropout

    def recording(x, rate, generator):
        y = real(x, rate, generator)
        seen.append((x.detach(), y.detach(), rate))
        return y

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 256, 3)).astype(np.float32))
    with mock.patch.object(layers, "dropout", recording):
        model(x, torch.Generator().manual_seed(0))
    assert [rate for _, _, rate in seen] == [p] * calls
    assert [tuple(a.shape) for a, _, _ in seen] == [(8, 512), (8, 256)][2 - calls:]
    for a, y, _ in seen:
        live = a != 0
        kept = (y != 0) & live
        assert abs(float(kept.sum() / live.sum()) - (1 - p)) < 0.05
        torch.testing.assert_close(y[kept], a[kept] / (1 - p))


_STAGES = ("sa1", "sa2", "sa3", "fc1", "fc2", "trunk", "outputs")


def _stage_readings(task, seed=SEED):
    """Where the port's float32 step leaves the JAX float64 step: each
    stage's train-mode output (the three set abstractions, the two FC
    layers, the trunk, the model's outputs) and the loss, the port's
    float32 and the JAX float32 each relative in norm from the JAX float64
    ones on the same inputs."""
    v, pts, batch, valid = _inputs(task, seed)
    model = JAX_MODELS[_TASKS[task][1]](sampling="first", **_TASKS[task][2])
    flat = lambda xs: np.concatenate([np.asarray(x, np.float64).ravel() for x in xs])

    def jax_run(dtype):
        with jax.enable_x64(True), mock.patch.object(fnn.Dropout, "__call__",
                                                     lambda self, x, *a, **k: x):
            cast = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype if a.dtype == np.float32 else a.dtype), v)
            out, mut = model.apply(cast, jnp.asarray(pts, dtype), train=True,
                                   mutable=["batch_stats", "intermediates"],
                                   capture_intermediates=True)
            trunk = mut["intermediates"]["PointNetPPTrunk_0"]
            stages = [trunk[f"SetAbstraction_{i}"]["__call__"][0][1] for i in range(3)]
            stages += [trunk["Dense_0"]["__call__"][0], trunk["Dense_1"]["__call__"][0],
                       trunk["__call__"][0], out if isinstance(out, tuple) else (out,)]
            loss_fn, params = _jax_loss_fn(task, dtype, seed)
            return [flat(x if isinstance(x, tuple) else (x,)) for x in stages] + [
                flat((jax.jit(loss_fn)(params)[0],))]

    trainer = _tiny_trainer(_TASKS[task][0], grad_clip=None)
    load_flax_variables(trainer.model, v)
    got = {}
    net = trainer.model
    for key, mod in zip(_STAGES, (net.trunk.sa1, net.trunk.sa2, net.trunk.sa3, net.trunk.fc1,
                                  net.trunk.fc2, net.trunk, net)):
        def hook(mod, inp, out, key=key):
            outs = out[1:2] if key.startswith("sa") else out if isinstance(out, tuple) else (out,)
            got[key] = flat([o.detach().numpy() for o in outs])
        mod.register_forward_hook(hook)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    tb["points"] = torch.from_numpy(pts)
    loss = float(trainer.train_step(tb, torch.from_numpy(valid), None)["loss"])
    port = [got[key] for key in _STAGES] + [flat((loss,))]  # the hooks fired in the step
    want, jax32 = jax_run(jnp.float64), jax_run(jnp.float32)
    dist = lambda a, w: float(np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30))
    return {name: (dist(p, w), dist(j, w))
            for name, p, j, w in zip(_STAGES + ("loss",), port, jax32, want)}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_heads_train.py [seed ...]
    import sys

    for seed in [int(a) for a in sys.argv[1:]] or [SEED]:
        for task in _TASKS:
            readings = _stage_readings(task, seed)
            print(f"{task} seed {seed} (port f32 / JAX f32, each from JAX f64): " + ", ".join(
                f"{name} {p:.1e} / {j:.1e}" for name, (p, j) in readings.items()), flush=True)
