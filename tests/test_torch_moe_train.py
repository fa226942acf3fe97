"""Training the MoE point transformer (preset ``moe_point_transformer``, task
``forward_mse_aux``) in the port against the JAX package on the CPU, at a
small size (depth 2, embed 16, FFN 32, 4 experts, N=64): one train step of
each dispatch (the loss, every gradient leaf and the Adam update) against
the JAX float64 step, the port in float64 and in float32, with flax's
dropout masks fed to the port and the routing compared first; the experts'
initialisation against flax's ``lecun_normal`` at the preset's full width;
the Trainer, its checkpoint and the CLI's ``--moe-dispatch``.

Dropout: the JAX step's masks (two ``Dropout`` calls a layer and one
attention-probability mask) are read from a jitted forward whose
``Dropout`` calls are intercepted and recomputed as flax computes them,
and whose attention masks are recomputed from the key flax's
``dot_product_attention_weights`` receives; that forward's output must be
flax's own bit for bit. The port gets them through test-only patches of
``models.layers.dropout`` and ``models.point_transformer.
attention_keep_mask``.
"""

import contextlib
import dataclasses
import inspect
import json
from unittest import mock

import flax.linen.attention as flax_attention
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.models import MoEPointTransformer as JaxMoEPT
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.config import preset as jax_preset
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.models import MoEPointTransformer, layers
from pointcloud_orientation_tpu_torch.models import point_transformer as PTM
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import run as R
from pointcloud_orientation_tpu_torch.train.trainer import config_model_kwargs
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)

DEPTH, E, FFN = 2, 16, 32
SMALL = dict(depth=DEPTH, embed_dim=E, num_heads=2, ffn_dim=FFN)
N = 64
DISPATCHES = ("masked", "capacity")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed, "moe_point_transformer", **SMALL)
    x = rng.normal(size=(4, N, 3)).astype(np.float32)
    axes = rng.normal(size=(4, 3, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    valid = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    return v, x, axes, valid, jax.random.PRNGKey(seed + 100)


def _jax_model(dispatch):
    return JaxMoEPT(**SMALL, dispatch=dispatch)


_MASKS = {}


def _flax_masks_and_routing(dispatch, seed):
    """The keep masks of the JAX float64 train forward on ``rngs={"dropout":
    key}`` (the Dropout modules' in call order, each layer's attention mask
    ``(N, N)``) and each layer's top-1 assignment, read from a jitted
    forward with them as extra outputs (cached)."""
    if (dispatch, seed) not in _MASKS:
        _MASKS[dispatch, seed] = _read_flax_masks(dispatch, seed)
    return _MASKS[dispatch, seed]


def _read_flax_masks(dispatch, seed):
    v, x, _, _, key = _step_inputs(seed)
    model = _jax_model(dispatch)
    weights_fn = flax_attention.dot_product_attention_weights
    apply = dict(train=True, rngs={"dropout": key})

    def forward(params, x, drops, attn, routes):
        def intercept(next_fun, args, kwargs, context):
            module = context.module
            if isinstance(module, nn.Dense) and module.name == "router":
                out = next_fun(*args, **kwargs)
                routes.append(jnp.argmax(jax.nn.softmax(out, -1), -1))
                return out
            if not isinstance(module, nn.Dropout) or context.method_name != "__call__":
                return next_fun(*args, **kwargs)
            (inputs,) = args
            keep_prob = 1.0 - module.rate
            keep = jax.random.bernoulli(module.make_rng(module.rng_collection), p=keep_prob,
                                        shape=inputs.shape)
            drops.append(keep)
            return jax.lax.select(keep, inputs / keep_prob, jnp.zeros_like(inputs))

        def weights(*args, **kwargs):
            a = inspect.signature(weights_fn).bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if a["dropout_rate"] > 0.0 and not a["deterministic"]:
                assert a["broadcast_dropout"]
                shape = (1,) * (a["key"].ndim - 2) + (a["query"].shape[-3], a["key"].shape[-3])
                attn.append(jax.random.bernoulli(a["dropout_rng"], 1.0 - a["dropout_rate"],
                                                 shape)[0, 0])
            return weights_fn(*args, **kwargs)

        with nn.intercept_methods(intercept), \
                mock.patch.object(flax_attention, "dot_product_attention_weights", weights):
            return model.apply({"params": params}, x, **apply), drops, attn, routes

    v, x = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (v, x))
    with jax.enable_x64(True):
        got, drops, attn, routes = jax.block_until_ready(
            jax.jit(lambda p, x: forward(p, x, [], [], []))(v["params"], x))
        want = jax.block_until_ready(
            jax.jit(lambda p, x: model.apply({"params": p}, x, **apply))(v["params"], x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(drops) == 2 * DEPTH and len(attn) == DEPTH and len(routes) == DEPTH
    return ([np.array(m) for m in drops], [np.array(m) for m in attn],
            [np.array(r) for r in routes])


@contextlib.contextmanager
def _fed_dropout(drops, attn):
    queue = [torch.from_numpy(m) for m in drops]
    attn_queue = [torch.from_numpy(m) for m in attn]

    def fed(x, p, generator):
        keep = queue.pop(0)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    with mock.patch.object(layers, "dropout", fed), \
            mock.patch.object(PTM, "attention_keep_mask", lambda *a: attn_queue.pop(0)):
        yield
    assert not queue and not attn_queue, "the model applied fewer dropouts than flax"


_JAX = {}


def _jax_step(dispatch, seed):
    """Loss, gradients and the Adam-updated params (optax's defaults at lr
    1e-3) of the JAX float64 step on the preset's task (the masked mean of
    ``forward_mse_aux``), jitted."""
    key = (dispatch, seed)
    if key in _JAX:
        return _JAX[key]
    v, x, axes, valid, rng = _step_inputs(seed)
    v, x, axes, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                               (v, x, axes, valid))
    model = _jax_model(dispatch)
    cfg = jax_preset("moe_point_transformer")

    def loss_fn(params):
        out = model.apply({"params": params}, jnp.asarray(x), train=True, rngs={"dropout": rng})
        per = jax_tasks.TASKS["forward_mse_aux"].loss(out, {"axes": jnp.asarray(axes)}, cfg)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        opt = optax.adam(1e-3)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    with jax.enable_x64(True):
        _JAX[key] = jax.tree_util.tree_map(np.asarray, step(v["params"]))
    return _JAX[key]


def _trainer(dispatch, **cfg):
    return Trainer(preset("moe_point_transformer", batch_size=4, num_points=N,
                          moe_dispatch=dispatch, **cfg),
                   OrientationDataset.synthetic(samples_per_class=3, num_points=N,
                                                class_names=["chair"]),
                   device="cpu", **SMALL)


def _port_step(dispatch, seed, dtype):
    """One ``Trainer.train_step`` of the preset (the model and batch in
    ``dtype``) with the JAX step's masks: loss, gradients, updated params
    and each layer's assignment."""
    v, x, axes, valid, _ = _step_inputs(seed)
    drops, attn, _ = _flax_masks_and_routing(dispatch, seed)
    trainer = _trainer(dispatch)
    load_flax_variables(trainer.model, v)
    trainer.model.to(dtype)
    routes = []
    for layer in trainer.model.layers:
        layer.moe.router.register_forward_hook(
            lambda mod, inp, out: routes.append(torch.argmax(torch.softmax(out, -1), -1).numpy()))
    batch = {"points": torch.from_numpy(x).to(dtype), "axes": torch.from_numpy(axes).to(dtype)}
    with _fed_dropout(drops, attn):
        m = trainer.train_step(batch, torch.from_numpy(valid).to(dtype), None)
    return (float(m["loss"]), to_flax_variables(trainer.model, grads=True)["params"],
            to_flax_variables(trainer.model)["params"], routes)


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _step_readings(got, want):
    """Loss (relative), every gradient leaf relative in norm (each
    attention's key bias, zero in exact arithmetic, by its norm against the
    query bias's) and the Adam-updated params, absolute, where the gradient
    is above 1e-6 (on gradients near Adam's 1e-8, rounding decides the
    step)."""
    loss = abs(got[0] - float(want[0])) / abs(float(want[0]))
    g, w = _by_path(got[1]), _by_path(want[1])
    grads = {}
    for k in w:
        scale = w[k.replace("key", "query")] if "['key']['bias']" in k else w[k]
        grads[k] = float(np.linalg.norm(g[k] - w[k]) / np.linalg.norm(scale))
    p, q = _by_path(got[2]), _by_path(want[2])
    params = max(float(np.abs(p[k] - q[k])[np.abs(w[k]) > 1e-6].max(initial=0.0)) for k in q)
    return loss, grads, params


# bounds of the port's step against the JAX float64 step (loss relative,
# every gradient leaf relative in norm, the updated params absolute; Adam's
# steps are 1e-3). Both sides round the pooled features and the aux loss
# to float32 (the JAX model's ``astype(jnp.float32)``), so float64 agrees to
# float32's resolution. Over seeds 0-5 the readings were at most (8.0e-8,
# 4.2e-7, 1.9e-8) for the port in float64 and (3.0e-7, 6.3e-7, 5.9e-8) in
# float32, both dispatches, the routing equal everywhere
# (``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_moe_train.py``
# prints them).
STEP_BOUNDS = {torch.float64: (1e-6, 5e-6, 1e-7), torch.float32: (1e-6, 5e-6, 5e-7)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_train_step_matches_jax(dispatch, dtype):
    """One step of the preset's task with flax's dropout masks: each layer's
    assignment equal to the JAX step's token for token first, then the
    loss, every gradient leaf and the Adam update within ``STEP_BOUNDS`` of
    the JAX float64 step."""
    want = _jax_step(dispatch, 0)
    got = _port_step(dispatch, 0, dtype)
    _, _, routes = _flax_masks_and_routing(dispatch, 0)
    assert len(got[3]) == DEPTH
    for g, w in zip(got[3], routes):
        assert (g != w).sum() == 0
    loss, grads, params = _step_readings(got, want)
    bounds = STEP_BOUNDS[dtype]
    assert loss <= bounds[0], loss
    assert max(grads.values()) <= bounds[1], max(grads.items(), key=lambda kv: kv[1])
    assert params <= bounds[2], params
    # the router and the experts were trained (the router only through gate and mean_prob)
    assert all(np.abs(_by_path(got[1])[k]).max() > 0 for k in _by_path(got[1])
               if "MoEFeedForward" in k)


def test_train_step_planted_fault_fails_the_bounds():
    """A wrong aux weight in the port's loss moves the router's gradient
    past its bound: the step check sees the aux path."""
    want = _jax_step("masked", 0)
    v, x, axes, valid, _ = _step_inputs(0)
    drops, attn, _ = _flax_masks_and_routing("masked", 0)
    trainer = _trainer("masked", moe_aux_weight=0.02)
    load_flax_variables(trainer.model, v)
    trainer.model.double()
    batch = {"points": torch.from_numpy(x).double(), "axes": torch.from_numpy(axes).double()}
    with _fed_dropout(drops, attn):
        m = trainer.train_step(batch, torch.from_numpy(valid).double(), None)
    bad = (float(m["loss"]), to_flax_variables(trainer.model, grads=True)["params"],
           to_flax_variables(trainer.model)["params"], [])
    loss, grads, _ = _step_readings(bad, want)
    router = max(v for k, v in grads.items() if "router" in k)
    assert loss > STEP_BOUNDS[torch.float64][0] and router > STEP_BOUNDS[torch.float64][1]


def test_expert_initialisation_matches_flax_lecun_normal():
    """The Trainer's initialisation at the preset's full width (E=64,
    F=2,048, 4 experts): ``wi (4, 64, 2048)`` with standard deviation
    ``1/sqrt(E*K)`` = 0.0625 and ``wo (4, 2048, 64)`` ``1/sqrt(F*K)``, as
    flax's ``lecun_normal`` counts the expert axis as receptive field (a
    flax draw of the same shapes within 1% of those too), truncated at two
    standard deviations; zero expert biases and a router without bias."""
    trainer = Trainer(preset("moe_point_transformer", batch_size=4, num_points=16),
                      OrientationDataset.synthetic(samples_per_class=2, num_points=16,
                                                   class_names=["chair"]), device="cpu")
    init = jax.nn.initializers.lecun_normal()
    for i, layer in enumerate(trainer.model.layers):
        moe = layer.moe
        assert moe.router.bias is None and not moe.bi.any() and not moe.bo.any()
        for name, fan_in in (("wi", 64 * 4), ("wo", 2048 * 4)):
            w = getattr(moe, name).detach().numpy()
            flax_w = np.asarray(init(jax.random.PRNGKey(i), w.shape, jnp.float32))
            for draw in (w, flax_w):
                assert abs(draw.std() / (1 / np.sqrt(fan_in)) - 1) < 0.01, (name, draw.std())
            assert np.abs(w).max() <= 2 * (1 / np.sqrt(fan_in)) / 0.87962566103423978 + 1e-7
    assert trainer.model.layers[0].moe.wi.shape == (4, 64, 2048)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_trainer_fits_the_preset_and_checkpoints(dispatch, tmp_path):
    """Both dispatches through ``Trainer`` on the CPU at depth 2: an epoch,
    the test pass and a checkpoint round trip; the config's MoE fields
    reach the model as the JAX trainer passes them; no kernel counts; the
    predictor refuses the model with the JAX ``ValueError``."""
    cfg = preset("moe_point_transformer", epochs=1, batch_size=4, num_points=N,
                 moe_dispatch=dispatch, moe_capacity_factor=2.0, moe_experts=3)
    assert config_model_kwargs(cfg) == {"dtype": None, "n_experts": 3, "dispatch": dispatch,
                                        "capacity_factor": 2.0}
    ds = OrientationDataset.synthetic(samples_per_class=12, num_points=N,
                                      class_names=["chair", "sofa"])
    trainer = Trainer(cfg, ds, device="cpu", **SMALL)
    moe = trainer.model.layers[0].moe
    assert isinstance(trainer.model, MoEPointTransformer) and trainer.class_names == ["chair"]
    assert (moe.dispatch, moe.capacity_factor, moe.n_experts) == (dispatch, 2.0, 3)
    before = K.launch_counts()
    trainer.fit(log_every=0)
    assert K.launch_counts() == before
    assert np.isfinite(trainer.history["train"][0]) and trainer.best_val_epoch == 1
    test = trainer.test()
    assert np.isfinite(test.mean_loss) and 0 <= test.mean_angular_error <= 180
    out, aux = trainer.predict(ds.points[:2, :N])
    assert out.shape == (2, 3) and aux.shape == () and aux >= 1.0 - 1e-5
    path = trainer.save_checkpoint(str(tmp_path))
    other = Trainer(cfg, ds, device="cpu", **SMALL)
    assert other.restore_checkpoint(path) == 1
    for a, b in zip(other.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    from pointcloud_orientation_tpu_torch import OrientationPredictor

    with pytest.raises(ValueError, match="training-only"):
        OrientationPredictor("moe_point_transformer", to_flax_variables(trainer.model)["params"],
                             device="cpu")


def test_bf16_trainer_step_is_finite_and_near_f32():
    """``compute_dtype="bfloat16"``: parameters and Adam state stay f32,
    the step's loss within 2% of the f32 step's on the same weights and
    batch (no dropout)."""
    losses = []
    for dtype in (None, "bfloat16"):
        trainer = _trainer("masked", compute_dtype=dtype)
        trainer.model.load_state_dict(_trainer("masked").model.state_dict())
        _, x, axes, valid, _ = _step_inputs(1)
        trainer.model.train()
        for layer in trainer.model.layers:
            layer.dropout = 0.0
            layer.attn.dropout = 0.0
        m = trainer.train_step({"points": torch.from_numpy(x), "axes": torch.from_numpy(axes)},
                               torch.from_numpy(valid), torch.Generator().manual_seed(0))
        losses.append(float(m["loss"]))
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert np.isfinite(losses).all() and abs(losses[1] / losses[0] - 1) < 0.02, losses


def test_cli_moe_dispatch(tmp_path, monkeypatch, capsys):
    """``--moe-dispatch capacity`` reaches the config and the model (the JAX
    flag); the run writes the JAX run's artifacts for ``forward_mse_aux``:
    metrics and summary, and no prediction PLY (its outputs decode to no
    axes there)."""
    monkeypatch.setattr(R, "load_dataset", lambda spec, num_points, classes=None:
                        OrientationDataset.synthetic(samples_per_class=8, num_points=32,
                                                     class_names=list(classes)))
    seen = []
    monkeypatch.setattr(R, "Trainer", lambda cfg, ds, **kw: seen.append(cfg) or Trainer(
        cfg, ds, **kw, **SMALL))
    R.main(["--preset", "moe_point_transformer", "--moe-dispatch", "capacity", "--epochs", "1",
            "--num-points", "32", "--batch-size", "4", "--device", "cpu",
            "--out", str(tmp_path)])
    assert seen[0].moe_dispatch == "capacity" and seen[0].task == "forward_mse_aux"
    m = json.loads((tmp_path / "metrics.json").read_text())
    assert m["config"]["moe_dispatch"] == "capacity" and np.isfinite(m["test"]["loss"])
    assert (tmp_path / "summary.txt").exists() and not (tmp_path / "pred_ply").exists()
    assert "[forward_mse_aux] test loss" in capsys.readouterr().out
    assert R._decode_axes("forward_mse_aux", (np.zeros((1, 3)), np.float32(1.0)), 0) is None
    with pytest.raises(SystemExit):
        R.main(["--preset", "moe_point_transformer", "--moe-dispatch", "sorted"])


def test_config_is_the_jax_preset():
    got, want = dataclasses.asdict(preset("moe_point_transformer")), dataclasses.asdict(
        jax_preset("moe_point_transformer"))
    assert got == {k: want[k] for k in got}
    assert set(want) - set(got) == set()  # bn_sync_axis is a field of both now


def _sweep(seeds=range(6)):
    """Print the readings behind ``STEP_BOUNDS``."""
    for seed in seeds:
        for dispatch in DISPATCHES:
            want = _jax_step(dispatch, seed)
            for dtype in (torch.float64, torch.float32):
                r = _step_readings(_port_step(dispatch, seed, dtype), want)
                print(seed, dispatch, dtype, r[0], max(r[1].values()), r[2], flush=True)


if __name__ == "__main__":
    _sweep()
