"""The port's PointNet backbones (``SimplePointNet``, ``PointNet``,
``PointNetCls``) against the JAX package's: eval outputs and predictors,
the train-mode forward with flax's own dropout masks fed in and the updated
BatchNorm statistics, ``feature_transform_regularizer`` and
``pointnet_cls_loss``, one ``simple_pointnet`` preset step and one
``pointnet_cls`` classification step, and the reference ``.pth`` layouts
both ways.

Dropout masks are read from flax's own ``Dropout`` calls and handed to the
port through a test-only patch of ``models.layers.dropout``, as in
``tests/test_torch_cls_train.py``. The port's float32 forward and step are
held to the JAX float64 ones, whose float32 step lies further from them
(``_sweep`` prints both); both in float64 are held leaf by leaf.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.losses import pointnet_cls_loss as jax_cls_loss
from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.models.pointnet import (
    feature_transform_regularizer as jax_regularizer,
)
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.config import preset as jax_preset
from pointcloud_orientation_tpu.utils import torch_export as jax_export
from pointcloud_orientation_tpu.utils import torch_import as jax_import
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.losses import pointnet_cls_loss
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY, layers
from pointcloud_orientation_tpu_torch.models.pointnet import feature_transform_regularizer
from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig, preset
from pointcloud_orientation_tpu_torch.utils import (
    export_state_dict,
    import_state_dict,
    load_flax_variables,
    load_reference_state_dict,
    model_kwargs,
    random_flax_variables,
    save_torch_checkpoint,
    to_flax_variables,
)
from pointcloud_orientation_tpu_torch.utils import grad_check as GC
from pointcloud_orientation_tpu_torch.utils.jax_weights import _pairs

B, N, CLASSES = 4, 128, 5
MODELS = ("simple_pointnet", "pointnet", "pointnet_cls")
DROPOUT_WIDTH = {"simple_pointnet": 128, "pointnet": 256, "pointnet_cls": 256}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(name, channels=3):
    kw = {"in_channels": channels}
    if name == "pointnet_cls":
        kw["num_classes"] = CLASSES
    return kw


def _jax_model(name):
    return JAX_MODELS[name](**({"num_classes": CLASSES} if name == "pointnet_cls" else {}))


def _inputs(name, seed, channels=3):
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed, name, **_kw(name, channels))
    x = rng.normal(size=(B, N, channels)).astype(np.float32)
    return v, x, rng


_MASKS = {}


def _flax_masks(name, v, x, key, dtype):
    """The keep masks of the model's one Dropout in train mode on
    ``rngs={"dropout": key}``, as flax draws them in ``dtype``; the
    intercepted forward must be flax's own bit for bit. Jitted, and cached
    by the model, key and dtype (the inputs follow from the seed)."""
    cache = (name, tuple(np.asarray(key).tolist()), np.dtype(dtype).name)
    if cache in _MASKS:
        return _MASKS[cache]
    model = _jax_model(name)
    apply = dict(train=True, rngs={"dropout": key}, mutable=["batch_stats"])

    def intercepted(v, x):
        masks = []

        def recompute(next_fun, args, kwargs, context):
            module = context.module
            if not isinstance(module, nn.Dropout) or context.method_name != "__call__":
                return next_fun(*args, **kwargs)
            (inputs,) = args
            keep_prob = 1.0 - module.rate
            keep = jax.random.bernoulli(module.make_rng(module.rng_collection), p=keep_prob,
                                        shape=inputs.shape)
            masks.append(keep)
            return jax.lax.select(keep, inputs / keep_prob, jnp.zeros_like(inputs))

        with nn.intercept_methods(recompute):
            got, _ = model.apply(v, x, **apply)
        return got, masks

    v, x = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (v, x))
    with jax.enable_x64(dtype == np.float64):
        got, masks = jax.jit(intercepted)(v, jnp.asarray(x))
        want, _ = jax.jit(lambda v, x: model.apply(v, x, **apply))(v, jnp.asarray(x))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    masks = [np.array(m) for m in masks]
    assert [m.shape for m in masks] == [(B, DROPOUT_WIDTH[name])]
    _MASKS[cache] = masks
    return masks


@contextlib.contextmanager
def _fed_dropout(masks):
    queue = [torch.from_numpy(m) for m in masks]

    def fed(x, p, generator):
        keep = queue.pop(0)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    with mock.patch.object(layers, "dropout", fed):
        yield
    assert not queue, "the model applied fewer dropouts than flax"


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name, channels", [(m, 3) for m in MODELS] + [("pointnet_cls", 6)],
                         ids=[*MODELS, "pointnet_cls-6ch"])
def test_eval_matches_jax_and_the_predictors_agree(name, channels):
    """Eval outputs against ``model.apply`` on the same flax tree within
    1e-5 of their scale, and the port's predictor against JAX's (the
    classifier's ``(log_probs, trans_feat)`` tuple through both)."""
    v, x, _ = _inputs(name, 0, channels)
    want = _as_tuple(_jax_model(name).apply(v, jnp.asarray(x), train=False))
    model = load_flax_variables(MODEL_REGISTRY[name](**model_kwargs(name, v["params"])), v)
    assert model.in_channels == channels
    with torch.no_grad():
        got = _as_tuple(model.eval()(torch.from_numpy(x)))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))
    kw = dict(num_points=N, max_batch=2)
    if name == "pointnet_cls":  # the tuple through both predictors
        jax_out = _as_tuple(JaxPredictor(name, v["params"], v["batch_stats"], **kw,
                                         num_classes=CLASSES)(x[:3]))
    else:  # eval BatchNorm is per cloud: the padded request's first 3 are apply's
        jax_out = tuple(np.asarray(w)[:3] for w in want)
    port = OrientationPredictor(name, v["params"], v["batch_stats"], device="cpu", **kw)
    port_out = _as_tuple(port(x[:3]))
    assert len(port_out) == len(jax_out) == (2 if name == "pointnet_cls" else 1)
    for g, w in zip(port_out, jax_out):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[0] == 3
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))
    if name == "pointnet_cls":
        with pytest.raises(ValueError):
            port.forward_vectors(x[:3])
    else:
        fwd = port.forward_vectors(x[:3])
        np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, rtol=1e-6)


def test_encoder_per_point_features_match_jax():
    """``PointNetEncoder(global_feat=False)``: the pooled feature beside the
    transformed 64-wide point features, ``(B, N, 1088)``, with both
    transforms, against the JAX encoder on the same subtree."""
    from pointcloud_orientation_tpu.models import PointNetEncoder as JaxEncoder

    v, x, _ = _inputs("pointnet", 2)
    sub = {k: v[k]["PointNetEncoder_0"] for k in ("params", "batch_stats")}
    want = JaxEncoder(global_feat=False, feature_transform=True).apply(
        sub, jnp.asarray(x), train=False)
    enc = load_flax_variables(MODEL_REGISTRY["pointnet"](), v).eval().encoder
    enc.global_feat = False
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got[0].shape == (B, N, 1088)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


def test_model_kwargs_read_the_tree():
    assert model_kwargs("simple_pointnet", random_flax_variables(0, "simple_pointnet")["params"]) \
        == {"in_channels": 3}
    assert model_kwargs("pointnet_cls", random_flax_variables(
        0, "pointnet_cls", in_channels=6, num_classes=7)["params"]) == {"in_channels": 6,
                                                                       "num_classes": 7}
    params = random_flax_variables(0, "pointnet")["params"]
    assert model_kwargs("pointnet", params) == {"in_channels": 3, "feature_transform": True}
    del params["PointNetEncoder_0"]["STNkd_0"]
    assert model_kwargs("pointnet", params)["feature_transform"] is False


_FORWARD = {}


def _jax_train_forward(name, seed):
    """The JAX float64 train-mode forward (outputs, updated statistics) on
    the seed's variables, clouds and float64 dropout masks, jitted and
    cached, with those masks."""
    if (name, seed) not in _FORWARD:
        v, x, _ = _inputs(name, seed)
        key = jax.random.PRNGKey(seed + 100)
        masks = _flax_masks(name, v, x, key, np.float64)
        with jax.enable_x64(True):
            v64, x64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (v, x))
            want, mut = jax.jit(lambda v, x: _jax_model(name).apply(
                v, x, train=True, rngs={"dropout": key}, mutable=["batch_stats"]))(
                    v64, jnp.asarray(x64))
            _FORWARD[(name, seed)] = ([np.asarray(w) for w in _as_tuple(want)],
                                      jax.tree_util.tree_map(np.asarray, mut["batch_stats"]),
                                      masks)
    return _FORWARD[(name, seed)]


def _train_forward(name, seed, dtype):
    """Port (``dtype``) and JAX (float64) train-mode forwards on the same
    variables, clouds and dropout masks: outputs and updated statistics."""
    v, x, _ = _inputs(name, seed)
    want, want_stats, masks = _jax_train_forward(name, seed)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    model = load_flax_variables(MODEL_REGISTRY[name](**_kw(name)), v).to(tdt).train()
    with _fed_dropout(masks), torch.no_grad():
        got = [g.numpy() for g in _as_tuple(model(torch.from_numpy(x.astype(dtype))))]
    return got, want, to_flax_variables(model)["batch_stats"], want_stats


# about twice the largest reading of ``_sweep`` over seeds 0-11 (B=4, N=128):
# the port's f32 train forward read at most out 4.1e-5 and statistics 8.6e-7
# (simple_pointnet), 1.8e-3 and 2.2e-4 (pointnet), 8.2e-4 and 2.2e-4
# (pointnet_cls): a train BatchNorm's fast variance over 512 rows cancels
# in float32 through the transform nets
FORWARD_F32_VS_F64 = {"simple_pointnet": {"out": 1e-4, "stats": 2e-6},
                      "pointnet": {"out": 4e-3, "stats": 5e-4},
                      "pointnet_cls": {"out": 2e-3, "stats": 5e-4}}


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_with_fed_dropout_matches_jax(name):
    """The train-mode forward with flax's dropout masks: in float64 within
    1e-10 of the JAX float64 forward (outputs and the updated running
    statistics, momentum 0.9 and the biased variance); in float32 within
    ``FORWARD_F32_VS_F64`` of it (outputs relative to their scale,
    statistics to ``1 + |value|``)."""
    got, want, stats, want_stats = _train_forward(name, 1, np.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
    a, b = _leaves(stats), _leaves(want_stats)
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-12, err_msg=k)
    out, st = _forward_readings(*_train_forward(name, 1, np.float32))
    bound = FORWARD_F32_VS_F64[name]
    assert out <= bound["out"] and st <= bound["stats"], (out, st, bound)


def _forward_readings(got, want, stats, want_stats):
    out = max(float(np.abs(g - w).max() / max(1.0, np.abs(w).max())) for g, w in zip(got, want))
    a, b = _leaves(stats), _leaves(want_stats)
    st = max(float(np.max(np.abs(a[k] - b[k]) / (1 + np.abs(b[k])))) for k in a)
    return out, st


def test_regularizer_and_cls_loss_match_jax(rng):
    trans = rng.normal(size=(B, 64, 64)).astype(np.float32) * 0.1 + np.eye(64, dtype=np.float32)
    got = feature_transform_regularizer(torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_regularizer(jnp.asarray(trans))), rtol=1e-6)
    eye = np.broadcast_to(np.eye(64, dtype=np.float32), (B, 64, 64)).copy()
    assert float(feature_transform_regularizer(torch.from_numpy(eye))) == 0.0
    log_probs = np.log(rng.dirichlet(np.ones(CLASSES), size=B)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=B).astype(np.int64)
    got = pointnet_cls_loss(*map(torch.from_numpy, (log_probs, labels, trans)))
    want = jax_cls_loss(*map(jnp.asarray, (log_probs, labels, trans)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    got = pointnet_cls_loss(*map(torch.from_numpy, (log_probs, labels, trans)), 0.5)
    want = jax_cls_loss(*map(jnp.asarray, (log_probs, labels, trans)), 0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)


# ---------- one train step against the JAX step ----------

STEPS = {"simple_pointnet": "forward_mse", "pointnet_cls": "classification"}


def _batch(name, rng):
    if name == "pointnet_cls":
        return {"labels": rng.integers(0, CLASSES, size=B).astype(np.int64)}
    axes = rng.normal(size=(B, 3, 3))
    return {"axes": (axes / np.linalg.norm(axes, axis=-1, keepdims=True)).astype(np.float32)}


_JAX = {}


def _jax_step(name, dtype, seed):
    """Loss, outputs, batch statistics and gradients of the JAX step (the
    task's per-sample loss, masked mean), jitted and cached. Its Dropout
    applies the float64 draw's masks in either precision (``jax.random``
    draws other masks under ``enable_x64``), so that the float32 and
    float64 steps differ by rounding alone."""
    key = (name, dtype, seed)
    if key in _JAX:
        return _JAX[key]
    v, x, rng = _inputs(name, seed)
    batch = _batch(name, rng)
    valid = np.asarray([1.0] * (B - 1) + [0.0])
    cfg = jax_preset("simple_pointnet")
    model = _jax_model(name)
    (mask,) = _flax_masks(name, v, x, jax.random.PRNGKey(seed + 100), np.float64)
    v, x, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (v, x, valid))
    batch = {k: (a.astype(dtype) if a.dtype.kind == "f" else a) for k, a in batch.items()}

    def fed(next_fun, args, kwargs, context):
        if not isinstance(context.module, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        (inputs,) = args
        keep_prob = 1.0 - context.module.rate
        return jnp.where(jnp.asarray(mask), inputs / keep_prob, jnp.zeros_like(inputs))

    def loss_fn(params):
        with nn.intercept_methods(fed):
            out, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
        per = jax_tasks.TASKS[STEPS[name]].loss(out, batch, cfg)
        loss = jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)
        return loss, (mut["batch_stats"], _as_tuple(out)[0])

    @jax.jit
    def step(params):
        (loss, (stats, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, stats, grads, out

    with jax.enable_x64(dtype == np.float64):
        _JAX[key] = jax.tree_util.tree_map(np.asarray, step(v["params"]))
    return _JAX[key]


def _trainer(name, num_classes=CLASSES):
    if name == "simple_pointnet":
        cfg = preset("simple_pointnet", batch_size=B, num_points=N, epochs=1)
        ds = OrientationDataset.synthetic(samples_per_class=2, num_points=N,
                                          class_names=["chair"])
        return Trainer(cfg, ds, device="cpu")
    cfg = TrainConfig(task="classification", model="pointnet_cls", batch_size=B,
                      num_points=N, epochs=1)
    return Trainer(cfg, OrientationDataset.synthetic(samples_per_class=1, num_points=N),
                   device="cpu", num_classes=num_classes)


def _port_step(name, dtype, seed, mask_dtype):
    """One step of the port's Trainer on the same variables, batch and
    dropout masks: loss, statistics, gradients (flax trees), outputs, and
    the flax paths of the leaves whose gradient is zero in exact
    arithmetic."""
    v, x, rng = _inputs(name, seed)
    batch = _batch(name, rng)
    valid = np.asarray([1.0] * (B - 1) + [0.0], dtype)
    masks = _flax_masks(name, v, x, jax.random.PRNGKey(seed + 100), mask_dtype)
    trainer = _trainer(name)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    load_flax_variables(trainer.model, v)
    trainer.model.to(tdt)
    tb = {"points": torch.from_numpy(x.astype(dtype))}
    tb.update({k: torch.from_numpy(a.astype(dtype) if a.dtype.kind == "f" else a)
               for k, a in batch.items()})
    seen = []
    hook = trainer.model.register_forward_hook(
        lambda m, a, out: seen.append(_as_tuple(out)[0].detach()))
    try:
        with _fed_dropout(masks):
            m = trainer.train_step(tb, torch.from_numpy(valid), None)
    finally:
        hook.remove()
    model = trainer.model
    names = {id(p): n for n, p in model.named_parameters()}
    flax_path = {}
    for lin_path, lin, norm_path, norm, _ in _pairs(model):
        flax_path[names[id(lin.weight)]] = lin_path + ("kernel",)
        flax_path[names[id(lin.bias)]] = lin_path + ("bias",)
        if norm is not None:
            flax_path[names[id(norm.weight)]] = norm_path + ("scale",)
            flax_path[names[id(norm.bias)]] = norm_path + ("bias",)
    zero = GC.zero_gradient_leaves(model) | set(GC.group_all_shift_leaves(model))
    zero = {jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in flax_path[n]))
            for n in zero}
    return (float(m["loss"]), to_flax_variables(model)["batch_stats"],
            to_flax_variables(model, grads=True)["params"], seen[0].numpy(), zero)


def _norm_excess(got, want) -> float:
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


def _step_readings(got, want):
    """Loss (relative), outputs (largest absolute over the output scale),
    statistics (largest |a - b| / (1 + |b|)), gradients (largest
    ``_norm_excess`` but the leaves zero in exact arithmetic: the Dense
    biases a train BatchNorm normalises, the shift before each max that
    feeds one)."""
    loss = abs(got[0] - float(want[0])) / abs(float(want[0]))
    out = float(np.abs(got[3] - want[3]).max() / max(1.0, np.abs(want[3]).max()))
    a, b = _leaves(got[1]), _leaves(want[1])
    stats = max(float(np.max(np.abs(a[k] - b[k]) / (1 + np.abs(b[k])))) for k in a)
    ga, gb = _leaves(got[2]), _leaves(want[2])
    assert ga.keys() == gb.keys() and got[4] <= ga.keys()
    grads = max(_norm_excess(ga[k], gb[k]) for k in ga if k not in got[4])
    return loss, out, stats, grads


# about twice the largest of the port's and the JAX float32 step's readings
# of ``_sweep`` over seeds 0-11 (B=4, N=128), both against JAX float64 with
# the same dropout masks. simple_pointnet: the port read at most loss
# 1.3e-5, outputs 4.1e-5, statistics 8.6e-7 and a gradient leaf 5.1e-4,
# JAX float32 1.8e-5, 5.8e-5, 5.5e-7 and 4.5e-4. pointnet_cls: the port
# 2.2e-4, 8.2e-4, 2.2e-4 and 4.2e-1, JAX float32 5.2e-4, 2.6e-3, 5.2e-4 and
# 4.2e-1; its worst leaves are near zero in exact arithmetic (Dense_1's
# bias, whose BatchNorm follows the dropout: zero in every channel whose
# column the mask keeps or drops whole; the transform nets' output biases)
# and are rounding noise on both sides. The float64 test below holds every
# leaf.
STEP_F32_VS_F64 = {"simple_pointnet": {"loss": 4e-5, "out": 1.2e-4, "stats": 2e-6,
                                       "grads": 1.2e-3},
                   "pointnet_cls": {"loss": 1e-3, "out": 5e-3, "stats": 1e-3, "grads": 0.85}}


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_jax_f64_step(name):
    """One f32 step of the port's Trainer (``simple_pointnet`` preset's
    ``forward_mse`` on axes row 0; ``pointnet_cls`` under
    ``classification``, the loss on its first output) against the JAX
    float64 step, with the same dropout masks: ``STEP_F32_VS_F64``."""
    r = _step_readings(_port_step(name, np.float32, 0, np.float64),
                       _jax_step(name, np.float64, 0))
    bound = STEP_F32_VS_F64[name]
    over = {k: x for k, x in zip(bound, r) if x > bound[k]}
    assert not over, (over, bound)


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_in_f64_matches_jax_f64_step_leaf_by_leaf(name):
    """Both sides in float64: the loss within 1e-10, every gradient leaf
    (those zero in exact arithmetic included) within rtol 1e-6 and atol
    1e-9 of the leaf's scale, the statistics within 1e-10."""
    got, want = _port_step(name, np.float64, 0, np.float64), _jax_step(name, np.float64, 0)
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-10)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-10)
    ga, gb = _leaves(got[2]), _leaves(want[2])
    assert ga.keys() == gb.keys()
    for k in gb:
        np.testing.assert_allclose(ga[k], gb[k], rtol=1e-6, atol=1e-9 * max(1.0, np.abs(gb[k]).max()),
                                   err_msg=k)
    a, b = _leaves(got[1]), _leaves(want[1])
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-10, err_msg=k)


def test_trainer_fits_the_preset_and_the_classifier_and_serves_them():
    """An epoch of the ``simple_pointnet`` preset and of ``pointnet_cls``
    under ``classification`` through ``Trainer.fit`` on the CPU (the
    dropout masks from the trainer's generator): finite losses; the
    classifier's angular errors NaN; the trained weights serve through the
    predictor unchanged."""
    for name in STEPS:
        trainer = _trainer(name, num_classes=40)  # the six-class mix's labels
        trainer.fit(log_every=0)
        assert np.isfinite(trainer.history["train"]).all()
        assert np.isnan(trainer.history["train_ang"]).all() == (name == "pointnet_cls")
        v = to_flax_variables(trainer.model)
        pred = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=N,
                                    max_batch=4, device="cpu")
        x = trainer.test_ds.points[:, :N].astype(np.float32)
        trainer.model.eval()
        with torch.no_grad():
            want = _as_tuple(trainer.model(torch.from_numpy(pred._pad(x))))
        for g, w in zip(_as_tuple(pred(x)), want):
            np.testing.assert_array_equal(g, w[:len(x)].numpy())


def test_the_demo_runs_on_the_cpu():
    """``demos/pointnet_demo_torch.py``: the classifier's outputs and the
    NLL plus the regulariser, as ``pointnet_cls_loss`` computes them."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos",
                        "pointnet_demo_torch.py")
    spec = importlib.util.spec_from_file_location("pointnet_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    log_probs, trans_feat, loss = demo.demo(batch=2, num_points=N, device="cpu")
    assert log_probs.shape == (2, 40) and trans_feat.shape == (2, 64, 64)
    np.testing.assert_allclose(torch.logsumexp(log_probs, -1).numpy(), 0.0, atol=1e-5)
    assert torch.isfinite(loss) and float(loss) > 0


# ---------- the reference .pth layouts ----------


@pytest.mark.parametrize("name", MODELS)
def test_pth_layout_both_ways_matches_jax(name, tmp_path, rng):
    """The port's export equals the JAX package's (names, shapes, values,
    ``Conv1d`` weights ``(out, in, 1)``); the port's import of that
    ``state_dict`` equals JAX's import bit for bit and gives back the tree;
    a ``.pth`` the port writes serves through ``from_torch_checkpoint``
    with the module's own outputs, bit for bit."""
    v = random_flax_variables(3, name, **_kw(name))
    got = export_state_dict(v["params"], v["batch_stats"], name)
    want = jax_export.export_pointnet_state_dict(v["params"], v["batch_stats"], name)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(a.ndim == 3 for a in got.values())
    sd = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in want.items()}
    port_tree = import_state_dict(sd, name)
    jax_tree = jax_import.import_pointnet_state_dict(sd, name)
    for a, b in zip(port_tree, jax_tree):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    _ = [np.testing.assert_array_equal(a, b)
         for a, b in zip(_leaves(port_tree[0]).values(), _leaves(v["params"]).values())]
    module = load_flax_variables(MODEL_REGISTRY[name](**_kw(name)), v)
    path = str(tmp_path / f"{name}.pth")
    save_torch_checkpoint(path, **to_flax_variables(module), model=name)
    x = rng.normal(size=(2, N, 3)).astype(np.float32)
    tree = to_flax_variables(module)
    kw = dict(num_points=N, device="cpu")
    served = OrientationPredictor.from_torch_checkpoint(path, name, **kw)(x)
    direct = OrientationPredictor(name, tree["params"], tree["batch_stats"], **kw)(x)
    for a, b in zip(_as_tuple(served), _as_tuple(direct)):
        np.testing.assert_array_equal(a, b)
    other = load_reference_state_dict(MODEL_REGISTRY[name](**_kw(name)), sd, name)
    for a, b in zip(other.state_dict().values(), module.state_dict().values()):
        if a.is_floating_point():
            assert torch.equal(a, b)
    with pytest.raises(KeyError):
        import_state_dict({"nonsense.weight": np.zeros(3)}, name)


def _sweep(seeds=range(12)):
    """The readings behind the bounds above: the port's f32 train forward
    and step against JAX float64, and the JAX float32 step against it too;
    one line a seed and the largest of each."""
    worst = {}

    def note(what, seed, r):
        print(f"seed {seed} {what}: " + " ".join(f"{x:.2e}" for x in r), flush=True)
        worst[what] = tuple(max(a, b) for a, b in zip(worst.get(what, r), r))

    for seed in seeds:
        for name in MODELS:
            note(f"{name} forward f32 vs f64", seed,
                 _forward_readings(*_train_forward(name, seed, np.float32)))
        for name in STEPS:
            exact = _jax_step(name, np.float64, seed)
            note(f"{name} step port f32 vs JAX f64", seed,
                 _step_readings(_port_step(name, np.float32, seed, np.float64), exact))
            j32 = _jax_step(name, np.float32, seed)
            note(f"{name} step JAX f32 vs JAX f64", seed, _step_readings(
                (float(j32[0]), j32[1], j32[2], j32[3],
                 _port_step(name, np.float32, seed, np.float64)[4]), exact))
    for what, r in worst.items():
        print(f"largest, {what}: " + " ".join(f"{x:.2e}" for x in r))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_pointnet.py
    _sweep()
