"""The port's point transformer (``models/point_transformer.py``) against the
JAX package's on the CPU, at a small size (depth 2, a narrow feed-forward,
N of 128 or 256): eval outputs on both attention backends through
``utils/jax_weights``, bf16 outputs over seeds, one train step of the
``point_transformer`` preset's task (loss, every gradient leaf, the Adam
update), the Trainer, the CLI and the predictor, and the MvM trunk's bf16
LayerNorm funnel. The JAX flash backend runs its Pallas kernels in
interpret mode (``pltpu.force_tpu_interpret_mode()``).

Dropout: flax draws its masks from ``jax.random`` and the port from a
``torch.Generator``. The JAX step's masks are read from an unjitted forward
on the same key whose ``Dropout`` calls are intercepted and recomputed as
flax computes them (``make_rng``, then ``jax.random.bernoulli``), and whose
attention-probability masks are recomputed from the key flax's
``dot_product_attention_weights`` receives (one ``(N, N)`` mask a layer,
broadcast over batch and heads); that forward's output must be flax's own
bit for bit. The port gets them through test-only patches of
``models.layers.dropout`` and ``models.point_transformer.
attention_keep_mask``.
"""

import contextlib
import inspect
from unittest import mock

import flax.linen.attention as flax_attention
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from pointcloud_orientation_tpu.models import PointNetPPMvM as JaxPointNetPPMvM
from pointcloud_orientation_tpu.models.point_transformer import PointTransformer as JaxPT
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.config import preset as jax_preset
from pointcloud_orientation_tpu_torch import OrientationPredictor
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.models import PointNetPPMvM, PointTransformer, layers
from pointcloud_orientation_tpu_torch.models import point_transformer as PTM
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train.run import main as run_main
from pointcloud_orientation_tpu_torch.train.trainer import config_model_kwargs
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)
from pointcloud_orientation_tpu_torch.utils import grad_check as GC

DEPTH, FFN = 2, 32
SMALL = dict(depth=DEPTH, ffn_dim=FFN)
IMPLS = ("xla", "flash")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(seed):
    return random_flax_variables(seed, "point_transformer", **SMALL)


def _clouds(seed, b=2, n=256):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def _jax_apply(v, x, impl, dtype=None):
    """The JAX model's eval outputs, jitted and awaited: an eager forward
    in interpret mode can deadlock (the kernels' interpret callbacks
    dispatch JAX operations while the next eager operation waits)."""
    model = JaxPT(**SMALL, attention_impl=impl, dtype=dtype)
    with pltpu.force_tpu_interpret_mode():
        apply = jax.jit(lambda p, x: model.apply({"params": p}, x))
        return np.asarray(apply(v["params"], jnp.asarray(x)))


def _port(v, impl, dtype=None, **kw):
    return load_flax_variables(
        PointTransformer(**model_kwargs("point_transformer", v["params"]), attention_impl=impl,
                         dtype=dtype, **kw), v)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_eval_outputs_match_jax(impl):
    """f32 outputs on the same carried weights; they lay 1.5e-7 apart
    (outputs of order 1), bound 2e-6."""
    v, x = _variables(0), _clouds(0)
    want = _jax_apply(v, x, impl)
    with torch.no_grad():
        got = _port(v, impl).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-6


def _bf16_readings(seed, impl):
    v, x = _variables(seed), _clouds(seed)
    want = _jax_apply(v, x, impl, jnp.bfloat16)
    f32 = _jax_apply(v, x, impl)
    with torch.no_grad():
        got = _port(v, impl, "bfloat16").eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    return (float(np.abs(got - want).max()), float(np.abs(got - f32).max()),
            float(np.abs(want - f32).max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_outputs_match_jax_bf16(impl, seed):
    """``dtype="bfloat16"`` against the JAX model with ``dtype=jnp.bfloat16``
    to ``tests/test_torch_bf16.py``'s bound (1e-2), and both within its
    0.05 of the f32 outputs. Over seeds 0-5 (``_sweep``) the port lay at
    most 2.6e-4 from JAX's bf16 outputs and 9.8e-3 from the f32 ones."""
    port_vs_jax, port_vs_f32, jax_vs_f32 = _bf16_readings(seed, impl)
    assert port_vs_jax <= 1e-2
    assert port_vs_f32 < 0.05 and jax_vs_f32 < 0.05


def test_flax_tree_round_trip_and_sizes_from_the_tree():
    """``random_flax_variables`` has the JAX model's tree and shapes (with
    and without remat, whose names are explicit); loading and reading back
    gives the same numbers, and the model's sizes are read from the tree."""
    v = random_flax_variables(1, "point_transformer", embed_dim=32, num_heads=2, depth=3,
                              ffn_dim=48)
    for remat in (False, True):
        init = JaxPT(embed_dim=32, num_heads=2, depth=3, ffn_dim=48, remat=remat).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)))
        assert (jax.tree_util.tree_structure(init["params"])
                == jax.tree_util.tree_structure(v["params"]))
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: np.shape(a) == np.shape(b), init["params"], v["params"]))
    kw = model_kwargs("point_transformer", v["params"])
    assert kw == {"in_dim": 3, "embed_dim": 32, "depth": 3, "num_heads": 2, "ffn_dim": 48}
    back = to_flax_variables(load_flax_variables(PointTransformer(**kw), v))
    assert back["batch_stats"] == {}
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back["params"],
                                                         v["params"]))
    with pytest.raises(ValueError, match="query/kernel"):
        load_flax_variables(PointTransformer(**{**kw, "num_heads": 4}), v)


@pytest.mark.parametrize("impl", IMPLS)
def test_predictor_serves_the_transformer_as_the_model(impl):
    """``OrientationPredictor("point_transformer", attention_impl=...)`` on
    the CPU: the JAX model's outputs on the padded bucket, unit forward
    vectors, no kernel launched; the flash backend refuses a cloud size
    that is not a multiple of 128."""
    v = _variables(2)
    x = _clouds(2, b=3, n=200)
    pred = OrientationPredictor("point_transformer", v["params"], num_points=256,
                                attention_impl=impl, device="cpu")
    before = K.launch_counts()
    got = pred(x)
    assert K.launch_counts() == before
    cycled = np.tile(x, (1, 2, 1))[:, :256]  # points cycled to 256, the bucket 4
    want = _jax_apply(v, np.concatenate([cycled, cycled[:1]], 0), impl)[:3]
    assert got.shape == (3, 3) and np.abs(got - want).max() <= 2e-6
    fwd = pred.forward_vectors(x)
    assert np.abs(np.linalg.norm(fwd, axis=-1) - 1).max() <= 1e-6
    if impl == "flash":
        odd = OrientationPredictor("point_transformer", v["params"], num_points=200,
                                   attention_impl=impl, device="cpu")
        with pytest.raises(ValueError, match="divisible by block_k_major=128"):
            odd(x)


# ---------------------------------------------------------------------------
# one train step, dropout masks read from flax
# ---------------------------------------------------------------------------


def _flax_masks(v, x, key, impl, dtype=np.float32):
    """The keep masks of the JAX train forward on ``rngs={"dropout": key}``
    in ``dtype`` (``jax.random.bernoulli`` draws other masks under
    ``enable_x64``): the Dropout modules' in call order, and each layer's
    attention mask ``(N, N)`` (none on the flash backend). The forward is
    jitted with the masks as extra outputs."""

    def forward(params, x, drops, attn):
        def recompute(next_fun, args, kwargs, context):
            module = context.module
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

        with nn.intercept_methods(recompute), \
                mock.patch.object(flax_attention, "dot_product_attention_weights", weights):
            return model.apply({"params": params}, x, **apply), drops, attn

    weights_fn = flax_attention.dot_product_attention_weights
    model = JaxPT(**SMALL, attention_impl=impl)
    v, x = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (v, x))
    apply = dict(train=True, rngs={"dropout": key})
    with jax.enable_x64(dtype == np.float64), pltpu.force_tpu_interpret_mode():
        got, drops, attn = jax.block_until_ready(
            jax.jit(lambda p, x: forward(p, x, [], []))(v["params"], x))
        want = jax.block_until_ready(
            jax.jit(lambda p, x: model.apply({"params": p}, x, **apply))(v["params"], x))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(drops) == 3 * DEPTH and len(attn) == (DEPTH if impl == "xla" else 0), \
        (len(drops), len(attn))
    return [np.array(m) for m in drops], [np.array(m) for m in attn]


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


def _step_inputs(seed, n=128):
    rng = np.random.default_rng(seed)
    v = _variables(seed)
    x = _clouds(seed, b=4, n=n)
    axes = rng.normal(size=(4, 3, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    valid = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    return v, x, axes, valid, jax.random.PRNGKey(seed + 100)


_JAX = {}


def _jax_step(impl, dtype, seed):
    """Loss, gradients and the Adam-updated params (optax's defaults at lr
    1e-3) of the JAX step on the ``forward_mse`` task (masked mean), jitted;
    the flash kernels in interpret mode."""
    key = (impl, dtype, seed)
    if key in _JAX:
        return _JAX[key]
    v, x, axes, valid, rng = _step_inputs(seed)
    v, x, axes, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                               (v, x, axes, valid))
    model = JaxPT(**SMALL, attention_impl=impl)
    cfg = jax_preset("point_transformer")

    def loss_fn(params):
        out = model.apply({"params": params}, jnp.asarray(x), train=True, rngs={"dropout": rng})
        per = jax_tasks.TASKS["forward_mse"].loss(out, {"axes": jnp.asarray(axes)}, cfg)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        opt = optax.adam(1e-3)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    with jax.enable_x64(dtype == np.float64), pltpu.force_tpu_interpret_mode():
        _JAX[key] = jax.tree_util.tree_map(np.asarray, step(v["params"]))
    return _JAX[key]


def _port_step(impl, seed, jax_dtype=np.float32, masks=None):
    """One f32 ``Trainer.train_step`` of the ``point_transformer`` preset on
    the same inputs with the masks of the JAX step in ``jax_dtype`` (or
    ``masks``): loss, gradients, updated params and the model."""
    v, x, axes, valid, rng = _step_inputs(seed)
    drops, attn = masks or _flax_masks(v, x, rng, impl, jax_dtype)
    dtype = np.float32
    cfg = preset("point_transformer", batch_size=4, num_points=128, transformer_attention=impl)
    trainer = Trainer(cfg, OrientationDataset.synthetic(samples_per_class=3, num_points=128,
                                                        class_names=["chair"]),
                      device="cpu", **SMALL)
    load_flax_variables(trainer.model, v)
    batch = {"points": torch.from_numpy(x.astype(dtype)),
             "axes": torch.from_numpy(axes.astype(dtype))}
    with _fed_dropout(drops, attn), pytest.warns(UserWarning) if impl == "flash" \
            else contextlib.nullcontext():
        m = trainer.train_step(batch, torch.from_numpy(valid.astype(dtype)), None)
    return (float(m["loss"]), to_flax_variables(trainer.model, grads=True)["params"],
            to_flax_variables(trainer.model)["params"], trainer.model)


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _key_bias(path):
    return "['key']['bias']" in path


def _step_readings(got, want):
    """Loss (relative), every gradient leaf relative in norm (each
    attention's key bias, zero in exact arithmetic, by its norm against the
    query bias's), and the Adam-updated params, absolute, on the entries
    whose gradient is above 1e-6 (Adam steps by ``lr * g / (|g| + 1e-8)``:
    on gradients near 1e-8, as the key biases' rounding noise, rounding
    decides the step)."""
    loss = abs(got[0] - float(want[0])) / abs(float(want[0]))
    g, w = _by_path(got[1]), _by_path(want[1])
    grads = {}
    for k in w:
        scale = w[k.replace("key", "query")] if _key_bias(k) else w[k]
        grads[k] = float(np.linalg.norm(g[k] - w[k]) / np.linalg.norm(scale))
    p, q = _by_path(got[2]), _by_path(want[2])
    params = max(float(np.abs(p[k] - q[k])[np.abs(w[k]) > 1e-6].max(initial=0.0)) for k in q)
    return loss, grads, params


# bounds of the port's f32 step against the JAX float64 step on the xla
# backend (flax draws other dropout masks under enable_x64, so the port is
# fed those) and against the JAX f32 step on the flash backend (the
# library's kernels take f32 products whatever the operands): loss
# relative, every gradient leaf relative in norm, the updated params
# absolute (Adam's steps are 1e-3). Over seeds 0-5 the readings were at most
# (1.9e-7, 7.4e-7, 5.9e-8) on xla and (2.1e-7, 1.25e-6, 1.2e-7) on flash
# (``PYTHONPATH=. python tests/test_torch_point_transformer.py`` prints
# them).
STEP_BOUNDS = (1e-6, 1e-5, 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_jax(impl, seed):
    """One step of the preset's task with flax's dropout masks: the loss,
    every gradient leaf and the Adam update within ``STEP_BOUNDS`` of the
    JAX step (its float64 step on the xla backend, whose attention,
    residual and feed-forward dropout all apply; its f32 step on the flash
    backend, with no attention dropout and the kernels' VJP)."""
    jax_dtype = np.float64 if impl == "xla" else np.float32
    want = _jax_step(impl, jax_dtype, seed)
    got = _port_step(impl, seed, jax_dtype)
    loss, grads, params = _step_readings(got, want)
    assert loss <= STEP_BOUNDS[0], loss
    assert max(grads.values()) <= STEP_BOUNDS[1], max(grads.items(), key=lambda kv: kv[1])
    assert params <= STEP_BOUNDS[2], params
    assert GC.zero_gradient_leaves(got[3]) == {f"layers.{i}.attn.key.bias" for i in range(DEPTH)}


def test_train_step_planted_faults_fail_the_bounds():
    """The step's bounds see a wrong dropout mask and a wrong flash
    backward: one layer's attention mask fed transposed, or the dQ kernel's
    output scaled by 1.01, moves a gradient reading past its bound."""
    v, x, axes, valid, rng = _step_inputs(0)
    drops, attn = _flax_masks(v, x, rng, "xla", np.float64)
    bad = _port_step("xla", 0, masks=(drops, [attn[0].T.copy(), *attn[1:]]))
    assert max(_step_readings(bad, _jax_step("xla", np.float64, 0))[1].values()) > STEP_BOUNDS[1]
    dq = K.flash_attention_bwd_dq
    with mock.patch.object(K, "flash_attention_bwd_dq", lambda *a: 1.01 * dq(*a)):
        bad = _port_step("flash", 0)
    assert max(_step_readings(bad, _jax_step("flash", np.float32, 0))[1].values()) \
        > STEP_BOUNDS[1]


# ---------------------------------------------------------------------------
# the model's options, the Trainer, the CLI
# ---------------------------------------------------------------------------


def test_flash_backend_refuses_what_the_library_refuses_and_warns_in_train():
    v = _variables(3)
    model = _port(v, "flash")
    with pytest.raises(ValueError, match="divisible by block_k_major=128"):
        model.eval()(torch.from_numpy(_clouds(3, n=200)))
    with pytest.raises(ValueError, match="smaller or equal to q_seq_len=64"):
        model.eval()(torch.from_numpy(_clouds(3, n=64)))
    with pytest.warns(UserWarning, match="does not apply attention-probability dropout"):
        model.train()(torch.from_numpy(_clouds(3, n=128)), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="attention_impl"):
        PointTransformer(attention_impl="ring")


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_keeps_the_parameters_outputs_and_gradients(impl):
    """``remat=True`` recomputes each layer in the backward from the
    generator state the layer started from: the same parameters, outputs
    and gradients as without it, dropout masks included."""
    v, x = _variables(4), torch.from_numpy(_clouds(4, n=128))
    plain, remat = _port(v, impl).train(), _port(v, impl, remat=True).train()
    assert [n for n, _ in plain.named_parameters()] == [n for n, _ in remat.named_parameters()]
    outs = []
    with pytest.warns(UserWarning) if impl == "flash" else contextlib.nullcontext():
        for model in (plain, remat):
            out = model(x, torch.Generator().manual_seed(5))
            out.square().sum().backward()
            outs.append((out.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", IMPLS)
def test_trainer_fits_the_preset_with_its_attention_and_checkpoints(impl, tmp_path):
    """The ``point_transformer`` preset (a model without BatchNorm state)
    through ``Trainer`` on the CPU at depth 2: an epoch, the best-val
    snapshot, the test pass and a checkpoint round trip; no kernel counts
    on the CPU."""
    cfg = preset("point_transformer", epochs=1, batch_size=4, num_points=128,
                 transformer_attention=impl)
    ds = OrientationDataset.synthetic(samples_per_class=12, num_points=256,
                                      class_names=["chair", "sofa"])
    trainer = Trainer(cfg, ds, device="cpu", fused_mlp_train=True, **SMALL)
    assert isinstance(trainer.model, PointTransformer) and trainer.class_names == ["chair"]
    assert trainer.model.layers[0].attn.attention_impl == impl
    before = K.launch_counts()
    with pytest.warns(UserWarning) if impl == "flash" else contextlib.nullcontext():
        trainer.fit(log_every=0)
    assert K.launch_counts() == before
    assert np.isfinite(trainer.history["train"][0]) and trainer.best_val_epoch == 1
    assert not any(k.endswith("running_mean") for k in trainer.best_state)
    test = trainer.test()
    assert np.isfinite(test.mean_loss) and np.isfinite(test.mean_angular_error)
    path = trainer.save_checkpoint(str(tmp_path))
    other = Trainer(cfg, ds, device="cpu", **SMALL)
    assert other.restore_checkpoint(path) == 1
    for a, b in zip(other.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)


def test_cli_trains_the_preset_with_flash_attention(tmp_path, capsys):
    with pytest.warns(UserWarning):
        run_main(["--preset", "point_transformer", "--attention", "flash", "--epochs", "1",
                  "--num-points", "128", "--batch-size", "16", "--device", "cpu",
                  "--out", str(tmp_path)])
    assert "[forward_mse] test loss" in capsys.readouterr().out
    assert (tmp_path / "metrics.json").exists() and (tmp_path / "summary.txt").exists()
    with pytest.raises(SystemExit):
        run_main(["--preset", "point_transformer", "--attention", "ring"])


def test_config_takes_the_attention_field_as_the_jax_config_does():
    """``transformer_attention`` is a field of the config (no longer an
    unported default), the preset is the JAX package's, and the model is
    built with the field's backend and the compute type."""
    want = jax_preset("point_transformer")
    got = preset("point_transformer")
    for name in ("task", "model", "rotation_mode", "num_points", "batch_size", "lr", "epochs",
                 "target_row", "transformer_attention"):
        assert getattr(got, name) == getattr(want, name), name
    assert tuple(got.classes) == tuple(want.classes)
    cfg = preset("point_transformer", transformer_attention="flash", compute_dtype="bfloat16")
    assert config_model_kwargs(cfg) == {"dtype": "bfloat16", "attention_impl": "flash"}
    with pytest.raises(NotImplementedError, match="transformer_attention"):
        preset("point_transformer", transformer_attention="ring")


# ---------------------------------------------------------------------------
# the MvM trunk's LayerNorm funnel in bf16
# ---------------------------------------------------------------------------


def _mvm_readings(seed):
    v = random_flax_variables(seed, "pointnet_pp_mvm")
    x = _clouds(seed)
    want = jax.block_until_ready(
        JaxPointNetPPMvM(sampling="first", dtype=jnp.bfloat16).apply(v, jnp.asarray(x)))
    f32 = jax.block_until_ready(JaxPointNetPPMvM(sampling="first").apply(v, jnp.asarray(x)))
    model = load_flax_variables(PointNetPPMvM(sampling="first", dtype="bfloat16"), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return [(float(np.abs(g.numpy() - np.asarray(w)).max()),
             float(np.abs(g.numpy() - np.asarray(f)).max())) for g, w, f in zip(got, want, f32)]


# (mu in radians, kappa, weight): twice the largest reading of the port's
# bf16 head against JAX's over seeds 0-5 (``_sweep``: 0.040, 0.0127,
# 0.0056); the port's bf16 head lay as far from the f32 head (0.040, 0.0089,
# 0.0042), the spread of bf16 trunk features through the heads
MVM_BF16_BOUNDS = (8e-2, 2.5e-2, 1.2e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_mvm_head_bf16_layer_norm_funnel_matches_jax_bf16(seed):
    """``PointNetPPMvM(dtype="bfloat16")`` (flax's ``LayerNorm(dtype=
    bfloat16)``: statistics in f32 from the widened input, bf16 out; no
    longer refused) against the JAX head in bf16 on the same weights: mu,
    kappa and the weights within ``MVM_BF16_BOUNDS`` of JAX's."""
    readings = _mvm_readings(seed)
    for (port_vs_jax, _), bound in zip(readings, MVM_BF16_BOUNDS):
        assert port_vs_jax <= bound, readings


def _sweep(seeds=range(6)):
    """Print the readings behind the bounds above."""
    for seed in seeds:
        print("seed", seed, "bf16", {impl: _bf16_readings(seed, impl) for impl in IMPLS},
              "mvm", _mvm_readings(seed))
        for impl in IMPLS:
            jax_dtype = np.float64 if impl == "xla" else np.float32
            r = _step_readings(_port_step(impl, seed, jax_dtype), _jax_step(impl, jax_dtype, seed))
            print("  step", impl, r[0], max(r[1].values()), r[2])


if __name__ == "__main__":
    _sweep()
