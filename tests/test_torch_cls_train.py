"""Training the port's PointNetPPCls (task ``classification``) against the JAX
package's classifier: the train-mode forward, one train step in each train
configuration, the loss and its task adapter, and the Trainer on the CPU.

Dropout: flax draws its masks from ``jax.random`` and the port from a
``torch.Generator``, so the two never agree on their own. The JAX side runs
flax's own ``Dropout`` on the key ``rngs={"dropout": key}``; the same masks
are read from an unjitted forward on that key whose ``Dropout`` calls are
intercepted and recomputed as flax computes them (``make_rng`` on the
module's collection, then ``jax.random.bernoulli``), checked bit for bit
against flax's own output, and handed to the port through a test-only
patch of ``models.layers.dropout``. Without a ``sampling`` rng the JAX
model starts both FPS stages at index 0; the port does so without a
generator.

The clouds lie on a grid of 1/64: every squared distance of the FPS and the
ball query is then exact in float32 and float64 alike, so both precisions
pick the same centroids and neighbours, and the float32 steps can be held
to the float64 one (the float32 and float64 sides would otherwise part at
the first distance that rounds across a FPS maximum or the radius).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.losses import nll_loss as jax_nll_loss
from pointcloud_orientation_tpu.models import PointNetPPCls as JaxPointNetPPCls
from pointcloud_orientation_tpu.ops.geometry import set_pallas_mode
from pointcloud_orientation_tpu.train import config as jax_config
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.metrics import MetricsAccumulator as JaxMetrics
from pointcloud_orientation_tpu_torch import losses as TL
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import PointNetPPCls, layers
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig
from pointcloud_orientation_tpu_torch.train import tasks as T
from pointcloud_orientation_tpu_torch.train.metrics import MetricsAccumulator
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)

B, N, CLASSES = 4, 512, 5
SEEDS = (0, 1, 2)


def _inputs(seed, channels=3):
    """Variables of a ``num_classes=5`` classifier, a batch of B=6 clouds
    of N=128 points on a grid of 1/64 (xyz in the unit ball; unit normals
    on the same grid's scale when 6 channels), labels, the last sample
    padded, and the dropout key."""
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed, "pointnet_pp_cls", in_channels=channels,
                              num_classes=CLASSES)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    xyz = rng.normal(size=(B, N, 3))
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    parts = [xyz]
    if channels == 6:
        nrm = rng.normal(size=(B, N, 3))
        parts.append(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    x = (np.round(np.concatenate(parts, axis=-1) * 64) / 64).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=B).astype(np.int32)
    valid = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    return v, x, labels, valid, jax.random.PRNGKey(seed + 100)


def _flax_masks(v, x, key, dtype=np.float32):
    """The keep masks of the classifier's two Dropouts in train mode on
    ``rngs={"dropout": key}``, in call order, as flax draws them in
    ``dtype`` (``jax.random.bernoulli`` draws other masks under
    ``enable_x64``); the output of that forward must be flax's own bit for
    bit."""
    masks = []

    def recompute(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        (inputs,) = args
        keep_prob = 1.0 - module.rate
        keep = jax.random.bernoulli(module.make_rng(module.rng_collection), p=keep_prob,
                                    shape=inputs.shape)
        masks.append(np.array(keep))
        return jax.lax.select(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    model = JaxPointNetPPCls(num_classes=CLASSES)
    apply = dict(train=True, rngs={"dropout": key}, mutable=["batch_stats"])
    v, x = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (v, x))
    with jax.enable_x64(dtype == np.float64):
        with nn.intercept_methods(recompute):
            got, _ = model.apply(v, jnp.asarray(x), **apply)
        want, _ = model.apply(v, jnp.asarray(x), **apply)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(masks) == 2 and [m.shape for m in masks] == [(B, 512), (B, 256)]
    return masks


@contextlib.contextmanager
def _fed_dropout(masks):
    """``models.layers.dropout`` replaced by the given keep masks, in call
    order, computed as flax applies them."""
    queue = [torch.from_numpy(m) for m in masks]

    def fed(x, p, generator):
        keep = queue.pop(0)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    with mock.patch.object(layers, "dropout", fed):
        yield
    assert not queue, "the model applied fewer dropouts than flax"


_JAX = {}  # (what, fused, dtype, seed) -> results, jitted steps cached across tests


def _jax_step(fused, dtype, seed):
    """Loss, log-probabilities, batch statistics and gradients of the JAX
    classifier's train step (masked mean NLL), jitted. ``fused`` runs the
    Pallas kernels in interpret mode with ``PCOT_FUSED_MLP=1`` (the caller
    sets it); otherwise the XLA path."""
    key = ("step", fused, dtype, seed)
    if key in _JAX:
        return _JAX[key]
    v, x, labels, valid, rng = _inputs(seed)
    v, x, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (v, x, valid))
    model = JaxPointNetPPCls(num_classes=CLASSES)

    def loss_fn(params):
        log_probs, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                     jnp.asarray(x), train=True, rngs={"dropout": rng},
                                     mutable=["batch_stats"])
        _, per = jax_nll_loss(log_probs, jnp.asarray(labels))
        loss = jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)
        return loss, (mut["batch_stats"], log_probs)

    @jax.jit
    def step(params):
        (loss, (stats, log_probs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, stats, grads, log_probs

    set_pallas_mode("always" if fused else "auto")
    try:
        with jax.enable_x64(dtype == np.float64):
            _JAX[key] = jax.tree_util.tree_map(np.asarray, step(v["params"]))
    finally:
        set_pallas_mode("auto")
    return _JAX[key]


def _tiny_dataset():
    return OrientationDataset.synthetic(samples_per_class=3, num_points=N)


def _trainer(fused=False, num_classes=40):
    """The classification config (no preset names it) on 18 synthetic
    clouds of the six-class mix, B=4."""
    c = TrainConfig(task="classification", model="pointnet_pp_cls", batch_size=4,
                    num_points=N, epochs=1)
    return Trainer(c, _tiny_dataset(), device="cpu", fused_mlp_train=fused,
                   num_classes=num_classes)


def _port_step(fused, dtype, seed, jax_dtype):
    """One step of the port's Trainer on the same inputs and the dropout
    masks of the JAX step in ``jax_dtype``: loss, statistics, gradients
    (flax trees) and the step's log-probabilities."""
    v, x, labels, valid, rng = _inputs(seed)
    masks = _flax_masks(v, x, rng, jax_dtype)
    trainer = _trainer(fused, CLASSES)
    trainer.model.to(torch.float64 if dtype == np.float64 else torch.float32)
    load_flax_variables(trainer.model, v)
    batch = {"points": torch.from_numpy(x.astype(dtype)),
             "labels": torch.from_numpy(labels.astype(np.int64))}
    seen = []
    hook = trainer.model.register_forward_hook(lambda m, a, out: seen.append(out.detach()))
    with contextlib.ExitStack() as stack:
        stack.callback(hook.remove)
        if dtype == np.float64:  # the index wrappers take float32, their plain versions any
            stack.enter_context(mock.patch.object(K, "fps", K.fps_plain))
            stack.enter_context(mock.patch.object(K, "ball_query", K.ball_query_plain))
        stack.enter_context(_fed_dropout(masks))
        m = trainer.train_step(batch, torch.from_numpy(valid.astype(dtype)), None)
    got = to_flax_variables(trainer.model)
    return (float(m["loss"]), got["batch_stats"],
            to_flax_variables(trainer.model, grads=True)["params"], seen[0].numpy())


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _norm_excess(got, want) -> float:
    """How far ``got`` lies from ``want`` in norm beyond 1e-5 per entry,
    relative to the norm of ``want``."""
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


def _zero_in_exact_arithmetic(path) -> bool:
    """A Dense bias that feeds a train-mode BatchNorm (every set
    abstraction's, and the FC funnel's ``Dense_0`` and ``Dense_1``): the
    batch mean removes it, so its gradient is zero in exact arithmetic and
    rounding noise on either side."""
    keys = [k.key for k in path]
    return keys[-1] == "bias" and keys[-2].startswith("Dense") and keys[:-1] != ["Dense_2"]


def _bias_noise(grads) -> float:
    """The largest gradient entry of a bias that is zero in exact
    arithmetic, over the largest entry of its Dense kernel's gradient."""
    flat = {tuple(k.key for k in path): g for path, g in _leaves(grads)}
    return max(float(np.abs(g).max() / np.abs(flat[key[:-1] + ("kernel",)]).max())
               for key, g in flat.items()
               if key[-1] == "bias" and key[-2].startswith("Dense") and key[:-1] != ("Dense_2",))


def _readings(got, want):
    """Loss (relative), log-probabilities (largest absolute), statistics
    (largest |a - b| / (1 + |b|)), gradients (largest ``_norm_excess``
    over the leaves but those zero in exact arithmetic) of a port step from
    a JAX step, and the port's noise on those (``_bias_noise``)."""
    loss = abs(got[0] - float(want[0])) / abs(float(want[0]))
    logp = float(np.abs(got[3] - want[3]).max())
    stats = max(float(np.max(np.abs(a - b) / (1 + np.abs(b))))
                for (_, a), (_, b) in zip(_leaves(got[1]), _leaves(want[1])))
    grads = max(_norm_excess(a, b) for (path, a), (_, b) in zip(_leaves(got[2]), _leaves(want[2]))
                if not _zero_in_exact_arithmetic(path))
    return loss, logp, stats, grads, _bias_noise(got[2])


# Bounds, about twice the largest reading of ``_sweep`` over seeds 0-11
# (B=4, N=512): the port's f32 step against the JAX f64 step read at most
# loss 2.2e-5, log-probabilities 1.5e-4, statistics 1.8e-5, a gradient leaf
# 1.7e-2, bias noise 1.6e-5; the fused step against the JAX fused f32 step
# 1.7e-4, 3.2e-3, 2.0e-4, 7.8e-2 and 4.2e-6 (the JAX f32 step's own error
# included: the JAX default-path f32 step lies 0.77, 3.4, 0.15 and 2.5 from
# its f64 step there, its f32 BatchNorm statistics over 65,536 sa1 rows
# cancelling, so it is no reference for the default path)
F32_VS_F64 = {"loss": 5e-5, "logp": 3e-4, "stats": 4e-5, "grads": 4e-2, "bias_noise": 4e-5}
FUSED_VS_JAX_FUSED = {"loss": 4e-4, "logp": 7e-3, "stats": 4e-4, "grads": 2e-1,
                      "bias_noise": 1e-5}


def _check(r, bounds):
    names = ("loss", "logp", "stats", "grads", "bias_noise")
    over = {n: v for n, v in zip(names, r) if v > bounds[n]}
    assert not over, (over, bounds)


@pytest.mark.parametrize("channels", [3, 6], ids=["xyz", "xyz+normals"])
def test_train_forward_matches_jax_with_fed_dropout(channels):
    """The train-mode forward (f32) against the JAX model's in float64 on
    the XLA path, the dropout masks fed: log-probabilities and the updated
    running statistics (flax momentum 0.9, biased variance) within the
    step's bounds (``F32_VS_F64``)."""
    v, x, _, _, rng = _inputs(3, channels)
    masks = _flax_masks(v, x, rng, np.float64)
    with jax.enable_x64(True):
        v64, x64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (v, x))
        want, mut = JaxPointNetPPCls(num_classes=CLASSES).apply(
            v64, jnp.asarray(x64), train=True, rngs={"dropout": rng}, mutable=["batch_stats"])
        want, want_stats = np.asarray(want), jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    model = load_flax_variables(PointNetPPCls(num_classes=CLASSES, in_channels=channels), v)
    model.train()
    with _fed_dropout(masks), torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_VS_F64["logp"])
    got_stats = to_flax_variables(model)["batch_stats"]
    for (path, a), (_, b) in zip(_leaves(got_stats), _leaves(want_stats)):
        assert np.max(np.abs(a - b) / (1 + np.abs(b))) <= F32_VS_F64["stats"], \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_jax_f64_step(seed):
    """One f32 step of the port's Trainer (default configuration: Linear +
    flax BatchNorm over all rows, the max in PyTorch, the grouping's
    gradient through autograd's gather) against the JAX float64 step on
    the XLA path (``F32_VS_F64``): loss relative, the step's
    log-probabilities absolute, statistics relative to 1 + |value|, each
    gradient leaf relative in norm beyond 1e-5 an entry but the Dense
    biases before a BatchNorm, whose gradient is zero in exact arithmetic:
    their largest entry is held against their kernel gradient's."""
    r = _readings(_port_step(False, np.float32, seed, np.float64),
                  _jax_step(False, np.float64, seed))
    _check(r, F32_VS_F64)


def test_train_step_in_f64_matches_jax_f64_step_leaf_by_leaf():
    """Both sides in float64 (the port's plain versions take any float
    type on the CPU): loss within 1e-10 relative, every gradient leaf
    within rtol 1e-6 and atol 1e-9 of the leaf's scale, statistics within
    1e-10, so that no formula departs from JAX's."""
    seed = SEEDS[0]
    got, want = _port_step(False, np.float64, seed, np.float64), _jax_step(False, np.float64, seed)
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-10)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-10)
    for (path, a), (_, b) in zip(_leaves(got[2]), _leaves(want[2])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9 * max(1.0, np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))
    for (path, a), (_, b) in zip(_leaves(got[1]), _leaves(want[1])):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10,
                                   err_msg=jax.tree_util.keystr(path))
    n_leaves = len(_leaves(got[2]))
    assert n_leaves == 3 * 3 * 4 + 2 * 4 + 2  # SA Dense/BN params, FC ditto, the output Dense


def test_fused_ghost_step_matches_jax_fused_f32_step(monkeypatch):
    """``fused_mlp_train``: ghost-row BatchNorm statistics, the MLP kernel
    and its recompute backward (their plain versions on the CPU), sa2 at
    K=64 and the group-all stage at K=128 rows, against the JAX step with
    ``PCOT_FUSED_MLP=1`` and every Pallas kernel in interpret mode, both in
    float32 (``FUSED_VS_JAX_FUSED``, which carry the JAX step's own
    float32 error)."""
    monkeypatch.setenv("PCOT_FUSED_MLP", "1")
    seed = SEEDS[0]
    r = _readings(_port_step(True, np.float32, seed, np.float32),
                  _jax_step(True, np.float32, seed))
    _check(r, FUSED_VS_JAX_FUSED)


def test_nll_loss_and_classification_adapter_match_jax(rng):
    log_probs = np.log(rng.dirichlet(np.ones(CLASSES), size=B)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=B).astype(np.int32)
    got = TL.nll_loss(torch.from_numpy(log_probs), torch.from_numpy(labels))
    want = jax_nll_loss(jnp.asarray(log_probs), jnp.asarray(labels))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=0)
    batch = {"labels": torch.from_numpy(labels)}
    per = T.TASKS["classification"].loss(torch.from_numpy(log_probs), batch, None)
    want = jax_tasks.TASKS["classification"].loss(jnp.asarray(log_probs),
                                                  {"labels": jnp.asarray(labels)}, None)
    np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=1e-7, atol=0)
    # a tuple's first entry, as the JAX adapter reads it
    per_t = T.TASKS["classification"].loss((torch.from_numpy(log_probs),), batch, None)
    assert torch.equal(per_t, per)
    assert T.TASKS["classification"].angular_error is None
    assert jax_tasks.TASKS["classification"].angular_error is None


def test_metrics_take_an_all_nan_angular_column_without_a_warning(recwarn):
    """The epoch metrics with no angular error (classification): the loss
    means as the JAX accumulator's, ``mean_angular_error`` NaN on both,
    and no warning."""
    per = np.asarray([0.5, 1.5, 2.0, 4.0])
    labels = np.asarray([0, 1, 1, 2])
    valid = np.asarray([1.0, 1.0, 1.0, 0.0])
    ours, theirs = MetricsAccumulator(["a", "b", "c"]), JaxMetrics(["a", "b", "c"])
    for acc in (ours, theirs):
        acc.update(per, labels, valid, np.full(4, np.nan))
    assert ours.mean_loss == pytest.approx(theirs.mean_loss)
    assert np.isnan(ours.mean_angular_error) and np.isnan(theirs.mean_angular_error)
    assert ours.per_class_mean()["b"] == pytest.approx(1.75)
    assert not [w for w in recwarn if "pointcloud_orientation_tpu_torch" in str(w.filename)]


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused-ghost"])
def test_trainer_trains_the_classifier_for_an_epoch_and_serves_it(fused):
    """``Trainer.fit`` on the classification config for one epoch on the
    CPU: finite losses, NaN angular errors, the labels on the device in
    each batch; the trained weights and statistics then serve through
    ``OrientationPredictor`` unchanged: its log-probabilities are the
    trained model's in eval on the same generator state."""
    trainer = _trainer(fused)
    trainer.fit(log_every=0)
    assert np.isfinite(trainer.history["train"]).all() and np.isfinite(trainer.history["val"])
    assert np.isnan(trainer.history["train_ang"]).all() and np.isnan(trainer.history["val_ang"])
    assert len(trainer.step_losses) == -(-len(trainer.train_ds) // 4)
    test = trainer.test()
    assert np.isfinite(test.mean_loss) and np.isnan(test.mean_angular_error)

    v = to_flax_variables(trainer.model)
    pred = OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                num_points=N, max_batch=4, seed=5, device="cpu")
    x = trainer.test_ds.points[:, :N].astype(np.float32)
    out = pred(x)
    assert out.shape == (len(x), 40)
    g = torch.Generator().manual_seed(5)  # the predictor's state: the same FPS starts
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.model(torch.from_numpy(pred._pad(x)), g)[:len(x)].numpy()
    np.testing.assert_array_equal(out, want)


def test_classifier_config_builds_an_f32_model_whatever_the_compute_dtype():
    """No preset names the classifier (nor in the JAX package): a config
    does. Its model has no ``dtype``, as the JAX model, so the trainer
    leaves it in f32 under ``compute_dtype="bfloat16"`` too, with flax's
    Dense initialisation; the 40 ModelNet classes by default. A model the
    port has is accepted as the JAX config accepts it; one it has not (the
    sequence-parallel transformer) raises."""
    cfg = TrainConfig(task="classification", model="pointnet_pp_cls", compute_dtype="bfloat16",
                      batch_size=4, num_points=N, epochs=1)
    trainer = Trainer(cfg, _tiny_dataset(), device="cpu")
    assert isinstance(trainer.model, PointNetPPCls)
    assert trainer.model.fc3.out_features == 40
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert not any(torch.count_nonzero(lin.bias) for lin in (trainer.model.fc1, trainer.model.fc3))
    # the JAX config takes any model name; the MoE transformer is the port's too
    assert (TrainConfig(task="classification", model="moe_point_transformer").model
            == jax_config.TrainConfig(task="classification", model="moe_point_transformer").model)
    # the ring transformer is a model name of both configs; no Trainer trains it
    ring = TrainConfig(task="classification", model="ring_point_transformer")
    assert ring.model == jax_config.TrainConfig(task="classification",
                                                model="ring_point_transformer").model
    with pytest.raises(TypeError, match="make_sp_train_step"):
        Trainer(ring, _tiny_dataset(), device="cpu")


def _sweep(seeds=range(12)):
    """The readings behind the bounds above: over seeds, the port's f32
    step against the JAX f64 step, the JAX f32 step against it too, and
    the port's fused f32 step against the JAX fused f32 step. Prints one
    line a seed and the largest of each."""
    import os

    worst = {}

    def note(name, seed, r):
        print(f"seed {seed} {name}: loss {r[0]:.2e} logp {r[1]:.2e} stats {r[2]:.2e} "
              f"grads {r[3]:.2e} bias noise {r[4]:.2e}", flush=True)
        worst[name] = tuple(max(a, b) for a, b in zip(worst.get(name, r), r))

    for seed in seeds:
        exact = _jax_step(False, np.float64, seed)
        note("port f32 vs JAX f64", seed,
             _readings(_port_step(False, np.float32, seed, np.float64), exact))
        j32 = _jax_step(False, np.float32, seed)
        note("JAX f32 vs JAX f64", seed, _readings((float(j32[0]),) + tuple(j32[1:]), exact))
    os.environ["PCOT_FUSED_MLP"] = "1"
    for seed in seeds:
        note("port fused f32 vs JAX fused f32", seed,
             _readings(_port_step(True, np.float32, seed, np.float32),
                       _jax_step(True, np.float32, seed)))
    for name, r in worst.items():
        print(f"largest, {name}: loss {r[0]:.2e} logp {r[1]:.2e} stats {r[2]:.2e} "
              f"grads {r[3]:.2e} bias noise {r[4]:.2e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cls_train.py
    _sweep()
