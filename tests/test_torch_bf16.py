"""The port's bfloat16 trunk (``compute_dtype="bfloat16"``) against the JAX
package's on the CPU: the MLP+max kernels' bf16 plain versions against the
Pallas kernels with ``bf16=True`` (interpret mode), the 8-dir model's eval
logits, and one 8dir_kl train step in both train configurations, with
``set_pallas_mode("always")`` so that the JAX side takes the kernels it
takes on the TPU. The CUDA kernels are held against these plain versions on
the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

bf16 rounds every product's operands, and a sum taken in another order can
put an f32 value on the other side of a bf16 rounding midpoint. Where the
test needs the same decisions on both sides it uses dyadic inputs
(``_dyadic_case``), on which every sum is exact in any order; elsewhere its
bounds were read over seeds by ``_sweep`` (run this file as a script).
"""

import contextlib
import math
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.losses import soft_label_kl_8dir as jax_kl
from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.ops.geometry import set_pallas_mode
from pointcloud_orientation_tpu.ops.pallas_kernels import _sa_mlp_max_bwd_impl, sa_mlp_max_pallas
from pointcloud_orientation_tpu_torch import OrientationPredictor
from pointcloud_orientation_tpu_torch import data as D
from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train.config import TrainConfig
from pointcloud_orientation_tpu_torch.train.run import main as run_main
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside other
    test processes on the same cores, PyTorch's thread pool otherwise
    spends most of its time waiting for its own descheduled threads (this
    file summed 756 s under six test workers, against about 65 s alone).
    Restored for the files that follow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (B, K, S, MLP widths) of the three set abstractions, at B=2
SA_SHAPES = {
    "sa1": (2, 32, 128, (3, 64, 64, 128)),
    "sa2": (2, 32, 32, (131, 128, 128, 256)),
    "sa3": (2, 32, 1, (259, 256, 512, 1024)),
}


def _dyadic_case(rng, B, Kn, S, widths):
    """Inputs on which every f32 product and sum of the MLP is exact in any
    order, before and after rounding to bf16 (grouped in multiples of 1/8 in
    [-1, 1], W in {-1, 0, 1}, scale a power of two near 1/sqrt(Cin), shift a
    multiple of the layer's granularity): both sides round the same values
    to bf16 and take the same ReLU and max decisions."""
    g = (rng.integers(-8, 9, size=(B, Kn, S, widths[0])) / 8.0).astype(np.float32)
    layers, bits = [], 3
    for ci, co in zip(widths[:-1], widths[1:]):
        e = math.ceil(math.log2(math.sqrt(ci)))
        bits += e
        layers.append((rng.integers(-1, 2, size=(ci, co)).astype(np.float32),
                       np.full(co, 2.0 ** -e, np.float32),
                       (rng.integers(-16, 17, size=co) * 2.0 ** -bits).astype(np.float32)))
    return g, layers


def _random_case(rng, B, Kn, S, widths):
    g = rng.normal(size=(B, Kn, S, widths[0])).astype(np.float32)
    layers = [((rng.normal(size=(ci, co)) / math.sqrt(ci)).astype(np.float32),
               rng.uniform(0.5, 1.5, size=co).astype(np.float32),
               (0.1 * rng.normal(size=co)).astype(np.float32))
              for ci, co in zip(widths[:-1], widths[1:])]
    return g, layers


def _j(layers):
    return [tuple(jnp.asarray(a) for a in layer) for layer in layers]


def _t(layers):
    return [tuple(torch.from_numpy(a) for a in layer) for layer in layers]


@pytest.mark.parametrize("case", ["dyadic", "random"])
@pytest.mark.parametrize("stage", list(SA_SHAPES))
def test_sa_mlp_max_plain_bf16_matches_pallas_bf16(rng, stage, case):
    """``sa_mlp_max_plain(bf16=True)`` against ``sa_mlp_max_pallas(bf16=True)``
    in interpret mode. Dyadic inputs: within 1e-5 of the output's scale
    (exact in practice). Random inputs: sums in another order flip a few
    bf16 roundings of intermediate activations; over 3 seeds per stage the
    two lay up to 3.5e-4 of scale apart at one entry and 3.0e-5 relative in
    norm: held to 1e-4 in norm, and the f32 result lies over 10 times
    further from the Pallas bf16 result, so the rounding bites."""
    B, Kn, S, widths = SA_SHAPES[stage]
    g, layers = (_dyadic_case if case == "dyadic" else _random_case)(rng, B, Kn, S, widths)
    want = np.asarray(sa_mlp_max_pallas(jnp.asarray(g), _j(layers), True, True))
    got = K.sa_mlp_max(torch.from_numpy(g), _t(layers), bf16=True).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if case == "dyadic":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        dist = np.linalg.norm(got - want)
        assert dist <= 1e-4 * np.linalg.norm(want)
        f32 = K.sa_mlp_max(torch.from_numpy(g), _t(layers)).numpy()
        assert np.linalg.norm(f32 - want) > 10 * dist


@pytest.mark.parametrize("stage", list(SA_SHAPES))
def test_sa_mlp_max_bwd_plain_bf16_matches_pallas_bwd_bf16(rng, stage):
    """The explicit bf16 backward against ``_sa_mlp_max_bwd_impl(bf16=True)``
    in interpret mode, on dyadic inputs (the same ReLU and max decisions) and
    a random cotangent: every output within 1e-5 of its scale (over 3 seeds
    per stage the largest gap was 2.8e-7 of scale). Autograd through the
    bf16 forward would leave the backward's products in f32: that lies
    further away, which shows the rounding of dz, a_in and W bites."""
    B, Kn, S, widths = SA_SHAPES[stage]
    g, layers = _dyadic_case(rng, B, Kn, S, widths)
    dp = rng.normal(size=(B, S, widths[-1])).astype(np.float32)
    want_dg, want_layers = _sa_mlp_max_bwd_impl(jnp.asarray(g), _j(layers), jnp.asarray(dp),
                                                True, True)
    got_dg, got_layers = K.sa_mlp_max_bwd(torch.from_numpy(g), _t(layers), torch.from_numpy(dp),
                                          bf16=True)
    pairs = [(got_dg, want_dg)] + [(a, b) for ga, wa in zip(got_layers, want_layers)
                                   for a, b in zip(ga, wa)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    with torch.enable_grad():  # autograd through the forward: products of f32 cotangents
        gt = torch.from_numpy(g).requires_grad_()
        flat = [p.requires_grad_() for layer in _t(layers) for p in layer]
        pooled = K.sa_mlp_max_plain(gt, [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)],
                                    bf16=True)
        auto = torch.autograd.grad(pooled, [gt, *flat], torch.from_numpy(dp))
    gaps = [np.abs(a.numpy() - np.asarray(b)).max() / np.abs(np.asarray(b)).max()
            for a, (_, b) in zip(auto, pairs)]
    assert max(gaps) > 1e-4


def test_bf16_wrappers_count_nothing_on_the_cpu_and_keep_f32_io(rng):
    """On CPU tensors the bf16 variants take their plain versions and count
    nothing; they take f32 grouped features and return f32."""
    K.reset_launch_counts()
    g, layers = _dyadic_case(rng, 1, 4, 3, (5, 7, 6))
    out = K.sa_mlp_max(torch.from_numpy(g), _t(layers), bf16=True)
    dg, _ = K.sa_mlp_max_bwd(torch.from_numpy(g), _t(layers), torch.ones((1, 3, 6)), bf16=True)
    assert out.dtype == dg.dtype == torch.float32
    assert set(K.launch_counts()) == {"sa_group", "sa_mlp_max", "sa_mlp_max_bf16",
                                      "sa_group_scatter", "sa_mlp_max_bwd",
                                      "sa_mlp_max_bwd_bf16", "knn", "fps", "ball_query",
                                      "topk_min", "flash_attention_fwd",
                                      "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}
    assert not any(K.launch_counts().values())
    with pytest.raises(TypeError):
        K.sa_mlp_max(torch.from_numpy(g).bfloat16(), _t(layers), bf16=True)


# ---------------------------------------------------------------------------
# the model in eval: serving logits
# ---------------------------------------------------------------------------

_JAX_EVAL = {}  # dtype -> jitted apply, traced with the Pallas kernels on


def _jax_logits(v, x, dtype):
    """The JAX 8-dir model's eval logits with the kernels the TPU takes
    (fused grouping, fused MLP+max; interpret mode), jitted once per dtype."""
    if dtype not in _JAX_EVAL:
        model = JaxPointNetPP8Dir(sampling="first", dtype=dtype)
        _JAX_EVAL[dtype] = jax.jit(lambda v, x: model.apply(v, x, train=False))
    set_pallas_mode("always")
    try:
        return np.asarray(_JAX_EVAL[dtype](v, jnp.asarray(x)))
    finally:
        set_pallas_mode("auto")


def _eval_readings(seed):
    """|port bf16 - JAX bf16|, |port bf16 - JAX f32| and |JAX bf16 - JAX
    f32| (largest entry) of the logits of B=2 clouds of N=256 points."""
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed)
    x = rng.normal(size=(2, 256, 3)).astype(np.float32)
    want = _jax_logits(v, x, jnp.bfloat16)
    f32 = _jax_logits(v, x, None)
    model = load_flax_variables(PointNetPP8Dir(sampling="first", dtype="bfloat16"), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 8)
    return (float(np.abs(got - want).max()), float(np.abs(got - f32).max()),
            float(np.abs(want - f32).max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pointnet_pp_8dir_bf16_logits_match_jax_bf16(seed):
    """``PointNetPP8Dir(dtype="bfloat16")`` in eval against the JAX model
    with ``dtype=jnp.bfloat16`` on the same carried weights. Over 20 seeds
    (``_sweep``) the two lay up to 3.8e-3 apart (bf16 rounding flips where
    the sums run in another order); bound 1e-2. Both lie within 0.05 of the
    f32 logits, the bound of ``tests/test_bf16.py`` (up to 5.9e-3 over the
    20 seeds)."""
    port_vs_jax, port_vs_f32, jax_vs_f32 = _eval_readings(seed)
    assert port_vs_jax <= 1e-2
    assert port_vs_f32 < 0.05 and jax_vs_f32 < 0.05


def test_predictor_serves_bf16_and_refuses_other_dtypes(rng):
    v = random_flax_variables(4)
    x = rng.normal(size=(3, 200, 3)).astype(np.float32)
    kw = dict(num_points=256, max_batch=4, device="cpu", sampling="first")
    f32 = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)(x)
    for dtype in ("bfloat16", torch.bfloat16):
        pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                    dtype=dtype, **kw)
        out = pred(x)
        assert out.dtype == np.float32 and out.shape == (3, 8)
        assert 0 < np.abs(out - f32).max() < 0.05
        assert all(p.dtype == torch.float32 for p in pred.model.parameters())
    for dtype in ("float16", torch.float64):
        with pytest.raises(NotImplementedError):
            OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                 dtype=dtype, **kw)


# ---------------------------------------------------------------------------
# one train step in each train configuration
# ---------------------------------------------------------------------------


class _NoDropPP8Dir(nn.Module):
    """PointNetPP8Dir's variable tree with dropout off and deterministic
    centroids, in ``dtype``, so that both frameworks run the same function."""

    dtype: object = None

    @nn.compact
    def __call__(self, xyz, train: bool = False):
        trunk = JaxTrunk(p_drop=0.0, sampling="first", dtype=self.dtype)
        return nn.Dense(8)(trunk(xyz, train=train))


_JAX_STEPS = {}  # (fused, dtype) -> jitted step


def _step_inputs(seed):
    """Variables and B=8 clouds of N=256 points, the last sample padded."""
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed)
    pts = rng.normal(size=(8, 256, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(8), size=8).astype(np.float32)
    valid = np.asarray([1.0] * 7 + [0.0], np.float32)
    return v, pts, probs, valid


def _jax_step(fused, dtype, seed):
    """Loss, batch statistics and gradients of the JAX model's train step,
    with the TPU's kernels (``always``; ``PCOT_FUSED_MLP=1`` for the fused
    configuration), jitted once per configuration and dtype."""
    v, pts, probs, valid = _step_inputs(seed)
    key = (fused, dtype)
    if key not in _JAX_STEPS:
        model = _NoDropPP8Dir(dtype=dtype)

        def loss_fn(params, stats, pts, probs, valid):
            logits, mut = model.apply({"params": params, "batch_stats": stats}, pts,
                                      train=True, mutable=["batch_stats"])
            _, per = jax_kl(logits, probs)
            return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0), mut["batch_stats"]

        _JAX_STEPS[key] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    old = os.environ.get("PCOT_FUSED_MLP")
    os.environ["PCOT_FUSED_MLP"] = "1" if fused else "0"
    set_pallas_mode("always")
    try:
        (loss, stats), grads = _JAX_STEPS[key](v["params"], v["batch_stats"], pts, probs, valid)
    finally:
        set_pallas_mode("auto")
        if old is None:
            del os.environ["PCOT_FUSED_MLP"]
        else:
            os.environ["PCOT_FUSED_MLP"] = old
    return (float(loss), jax.tree_util.tree_map(np.asarray, stats),
            jax.tree_util.tree_map(np.asarray, grads))


def _port_step(fused, seed):
    """One bf16 step of the port's Trainer on the same inputs: loss, and
    statistics and gradients as flax trees; checks that the parameters and
    Adam's state stay f32."""
    v, pts, probs, valid = _step_inputs(seed)
    cfg = preset("8dir_kl", batch_size=4, num_points=256, compute_dtype="bfloat16")
    trainer = Trainer(cfg, D.OrientationDataset.synthetic(samples_per_class=3, num_points=256),
                      device="cpu", fused_mlp_train=fused, sampling="first", p_drop=0.0)
    load_flax_variables(trainer.model, v)
    batch = {"points": torch.from_numpy(pts), "probs_8dir": torch.from_numpy(probs),
             "forward": torch.zeros((8, 3))}
    m = trainer.train_step(batch, torch.from_numpy(valid), None)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(t.dtype == torch.float32 for s in trainer.optimizer.state.values()
               for t in s.values() if t.dim())
    got = to_flax_variables(trainer.model)
    return (float(m["loss"]), got["batch_stats"],
            to_flax_variables(trainer.model, grads=True)["params"])


def _leaves(tree):
    return [x for _, x in sorted(jax.tree_util.tree_leaves_with_path(tree),
                                 key=lambda kv: jax.tree_util.keystr(kv[0]))]


def _zero_in_exact_arithmetic(tree):
    """Per leaf (in ``_leaves`` order): whether its exact gradient is zero,
    so that both sides hold rounding noise there. A Dense bias that feeds a
    train-mode BatchNorm (the batch mean removes it), and the group-all
    stage's last BatchNorm bias (it shifts every cloud's pooled feature
    alike, and fc1's BatchNorm removes that shift)."""
    paths = sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree))
    return [("Dense" in p and p.endswith("['bias']") and "PointNetPPTrunk" in p)
            or p.endswith("['SetAbstraction_2']['SharedMLP_0']['BatchNorm_2']['bias']")
            for p in paths]


def _readings(got, want):
    """Loss (relative), statistics (largest |a - b| / (1 + |b|)) and the
    gradient (all leaves but those ``_zero_in_exact_arithmetic``, as one
    vector, relative in norm) of one step from another."""
    loss = abs(got[0] - want[0]) / abs(want[0])
    stats = max(float(np.max(np.abs(a - b) / (1 + np.abs(b))))
                for a, b in zip(_leaves(got[1]), _leaves(want[1])))
    keep = [not z for z in _zero_in_exact_arithmetic(want[2])]
    a = np.concatenate([x.ravel() for x, k in zip(_leaves(got[2]), keep) if k])
    b = np.concatenate([x.ravel() for x, k in zip(_leaves(want[2]), keep) if k])
    return loss, stats, float(np.linalg.norm(a - b) / np.linalg.norm(b))


# bounds (loss, statistics, gradient) of the port's bf16 step against the
# JAX bf16 step; over 20 seeds (``_sweep``) the largest readings were
# (1.8e-2, 1.4e-2, 0.72) in the default configuration and (9.8e-3, 1.4e-2,
# 0.60) in the fused one
STEP_BOUNDS = (4e-2, 3e-2, 1.0)
STEP_SEEDS = range(5)

# Leaves whose bf16 gradient at this size is more than rounding noise: the
# head Dense and the funnel's last BatchNorm (upstream of them the BatchNorm
# backward cancels most of the cotangent and max-pool decisions reroute the
# rest, see ``test_bf16_train_step_matches_jax_bf16_step``). Each is held
# relative in norm to HELD_BOUND; over 20 seeds (``_sweep``) the port's bf16
# step read at most 0.195 (default) and 0.12 (fused) from the JAX bf16 step
# on these leaves; a zero gradient reads 1.0 and a halved one 0.5. (That
# BatchNorm's bias read up to 0.36 and is left out.)
HELD_LEAVES = ("['Dense_0']['kernel']", "['Dense_0']['bias']",
               "['PointNetPPTrunk_0']['BatchNorm_1']['scale']")
HELD_BOUND = 0.3


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _held_readings(got, want):
    """Per held leaf, the gradient's distance relative in norm."""
    a, b = _by_path(got), _by_path(want)
    return {k: float(np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k])) for k in HELD_LEAVES}


@pytest.mark.parametrize("config", ["default", "fused"])
def test_bf16_train_step_matches_jax_bf16_step(config):
    """One 8dir_kl step with ``compute_dtype="bfloat16"`` (B=8 clouds of 256
    points, the last one padded) against ``value_and_grad`` of the JAX model
    with ``dtype=jnp.bfloat16`` on the same variables and batch, at 5 seeds:
    loss, BatchNorm statistics and gradient within ``STEP_BOUNDS``, and the
    head's and the funnel's last BatchNorm's gradients per leaf within
    ``HELD_BOUND`` (a zero or halved gradient planted there must fail it).

    bf16 leaves most of the gradient of a step rounding noise: the
    BatchNorm backward subtracts the batch means of the cotangents, and
    bf16 ties and near-ties under the max-pools reroute what is left. Over
    20 seeds the JAX bf16 step's own gradient lies 0.50-0.67 (default) and
    0.45-0.59 (fused) relative in norm from the JAX f32 step, and the
    port's bf16 step as far from either; larger steps do not help (per SA
    stage, JAX bf16 reads 0.42-0.61 from JAX f32 at B=128, N=1024 against
    0.50-0.70 at B=8, N=256, ``_size_sweep``). So the whole gradient is held
    only loosely here, its wiring is
    held by ``test_bf16_train_step_gradient_matches_autograd_reference``,
    and the test also holds the port to the f32 step no worse than the JAX
    bf16 step is held: the port's mean distance to the JAX f32 step over
    the seeds at most twice the JAX bf16 step's, in each reading (over 20
    seeds the ratio was at most 1.26; over these 5, 1.67 for the default
    step's loss, whose per-seed distances are single noisy draws)."""
    fused = config == "fused"
    ours, theirs = [], []
    for seed in STEP_SEEDS:
        port = _port_step(fused, seed)
        jax_bf16 = _jax_step(fused, jnp.bfloat16, seed)
        jax_f32 = _jax_step(fused, None, seed)
        got = _readings(port, jax_bf16)
        assert all(r <= b for r, b in zip(got, STEP_BOUNDS)), (seed, got, STEP_BOUNDS)
        held = _held_readings(port[2], jax_bf16[2])
        assert max(held.values()) <= HELD_BOUND, (seed, held)
        for factor in (0.0, 0.5):  # the controls: a lost and a halved gradient
            planted = jax.tree_util.tree_map(lambda x: factor * x, port[2])
            assert min(_held_readings(planted, jax_bf16[2]).values()) > HELD_BOUND
        ours.append(_readings(port, jax_f32))
        theirs.append(_readings(jax_bf16, jax_f32))
    ours, theirs = np.mean(ours, axis=0), np.mean(theirs, axis=0)
    assert (ours <= 2 * theirs).all(), (ours, theirs)


def _group_by_autograd(xyz, feats, cidx, nsample):
    return K.sa_group(xyz, feats.to(xyz.dtype), cidx, nsample)


def _mlp_by_autograd(grouped, bf16, *flat):
    return K.sa_mlp_max_plain(grouped, [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)],
                              bf16)


@contextlib.contextmanager
def _autograd_reference():
    """``SAGroupFeatsFn`` and ``SAMlpMaxFn`` replaced by their plain
    forwards under autograd: the same forward values (the plain MLP is one
    2-D product per layer in either grad mode), and a backward that shares
    no code with the explicit ones."""
    with mock.patch.object(K.SAGroupFeatsFn, "apply", _group_by_autograd), \
            mock.patch.object(K.SAMlpMaxFn, "apply", _mlp_by_autograd):
        yield


def _halved_input_cotangent(fused):
    """A planted wiring fault: the grouped features' gradient (the scatter
    in the default path, the fused MLP's input gradient) halved."""
    if fused:
        bwd = K.sa_mlp_max_bwd

        def halved(*args, **kwargs):
            dg, dlayers = bwd(*args, **kwargs)
            return (None if dg is None else 0.5 * dg), dlayers

        return mock.patch.object(K, "sa_mlp_max_bwd", halved)
    scatter = K.sa_group_scatter
    return mock.patch.object(K, "sa_group_scatter", lambda *a, **kw: 0.5 * scatter(*a, **kw))


def _f32_backward():
    """A planted fault: the fused bf16 step's backward run in f32 (its
    recompute then takes f32 max decisions)."""
    bwd = K.sa_mlp_max_bwd
    return mock.patch.object(K, "sa_mlp_max_bwd",
                             lambda *a, bf16=False, **kw: bwd(*a, bf16=False, **kw))


def _wiring_readings(got, want):
    """The gradient (all leaves but those ``_zero_in_exact_arithmetic``, as
    one vector) relative in norm, and the largest per-leaf reading."""
    keep = [not z for z in _zero_in_exact_arithmetic(want[2])]
    a = [x for x, k in zip(_leaves(got[2]), keep) if k]
    b = [x for x, k in zip(_leaves(want[2]), keep) if k]
    whole = np.linalg.norm(np.concatenate([x.ravel() - y.ravel() for x, y in zip(a, b)]))
    whole /= np.linalg.norm(np.concatenate([y.ravel() for y in b]))
    return float(whole), max(float(np.linalg.norm(x - y) / np.linalg.norm(y)) for x, y in zip(a, b))


# bounds (whole gradient, largest leaf) of the bf16 step against the
# autograd reference; over 20 seeds (``_sweep``) the default step read
# exactly 0 and the fused one at most (7.6e-3, 0.28), the leaf being sa2's
# last BatchNorm bias, whose gradient sums cotangents that nearly cancel
WIRING_BOUNDS = (3e-2, 0.5)
WIRING_SEEDS = range(3)


@pytest.mark.parametrize("config", ["default", "fused"])
def test_bf16_train_step_gradient_matches_autograd_reference(config):
    """The bf16 step's gradient through the explicit backwards (the
    grouping's scatter, and in the fused configuration the MLP+max
    backward with bf16 products) against autograd through the same
    forward (``_autograd_reference``), at 3 seeds: the same loss, and the
    gradient within ``WIRING_BOUNDS``. Both run the same forward, so no
    max-pool decision differs and what is left is the backward's own
    rounding: the default step matches exactly, the fused one to rounding
    of the bf16 backward's operands. Planted faults must fail the bounds:
    the input cotangent halved (reads 0.5 and more), and in the fused
    configuration the backward in f32 (over 20 seeds it read 0.21-0.30 for
    the whole gradient)."""
    fused = config == "fused"
    for seed in WIRING_SEEDS:
        got = _port_step(fused, seed)
        with _autograd_reference():
            want = _port_step(fused, seed)
        assert got[0] == want[0]
        readings = _wiring_readings(got, want)
        assert all(r <= b for r, b in zip(readings, WIRING_BOUNDS)), (seed, readings)
        plants = [_halved_input_cotangent(fused)] + ([_f32_backward()] if fused else [])
        for plant in plants:
            with plant:
                bad = _port_step(fused, seed)
            assert _wiring_readings(bad, want)[0] > WIRING_BOUNDS[0]


def test_compute_dtype_is_accepted_where_the_jax_package_takes_it(tmp_path):
    """``compute_dtype`` "bfloat16" (and None, "float32") through ``preset``,
    ``TrainConfig.replace`` and the ``run`` CLI; other dtypes raise."""
    assert preset("8dir_kl", compute_dtype="bfloat16").compute_dtype == "bfloat16"
    assert preset("8dir_kl").replace(compute_dtype="float32").compute_dtype == "float32"
    assert TrainConfig().compute_dtype is None
    for bad in ("float16", "bf16"):
        with pytest.raises(NotImplementedError):
            preset("8dir_kl", compute_dtype=bad)
        with pytest.raises(NotImplementedError):
            TrainConfig().replace(compute_dtype=bad)
    run_main(["--preset", "8dir_kl", "--epochs", "1", "--num-points", "128", "--batch-size",
              "8", "--device", "cpu", "--compute-dtype", "bfloat16", "--out",
              str(tmp_path)])
    import json

    cfg = json.loads((tmp_path / "metrics.json").read_text())["config"]
    assert cfg["compute_dtype"] == "bfloat16"
    assert np.isfinite(json.loads((tmp_path / "metrics.json").read_text())["test"]["loss"])


def _sweep(n_eval=20, n_step=20):
    """Print the readings behind the bounds above, per seed and the largest."""
    worst = np.zeros(3)
    for seed in range(n_eval):
        r = _eval_readings(seed)
        worst = np.maximum(worst, r)
        print(f"eval seed {seed}: port-JAX bf16 {r[0]:.2e}, port-JAX f32 {r[1]:.2e}, "
              f"JAX bf16-JAX f32 {r[2]:.2e}", flush=True)
    print(f"eval largest: {worst}")
    for config in ("default", "fused"):
        fused = config == "fused"
        readings, ours, theirs, held, wiring, f32_bwd = [], [], [], [], [], []
        for seed in range(n_step):
            port = _port_step(fused, seed)
            jb, jf = _jax_step(fused, jnp.bfloat16, seed), _jax_step(fused, None, seed)
            readings.append(_readings(port, jb))
            ours.append(_readings(port, jf))
            theirs.append(_readings(jb, jf))
            held.append(list(_held_readings(port[2], jb[2]).values()))
            with _autograd_reference():
                ref = _port_step(fused, seed)
            wiring.append(_wiring_readings(port, ref))
            if fused:
                with _f32_backward():
                    f32_bwd.append(_wiring_readings(_port_step(fused, seed), ref)[0])
            print(f"{config} seed {seed}: port-JAX bf16 {readings[-1]}, port-JAX f32 "
                  f"{ours[-1]}, JAX bf16-JAX f32 {theirs[-1]}, held leaves {held[-1]}, "
                  f"vs autograd {wiring[-1]}", flush=True)
        print(f"{config} largest: {np.max(readings, axis=0)}; mean distance to JAX f32, port "
              f"over JAX bf16: {np.mean(ours, axis=0) / np.mean(theirs, axis=0)}; held leaves "
              f"{np.max(held, axis=0)}; vs autograd {np.max(wiring, axis=0)}"
              + (f"; f32 backward vs autograd {min(f32_bwd):.3f}-{max(f32_bwd):.3f}"
                 if fused else ""))


def _size_sweep(sizes=((8, 256), (32, 1024), (128, 1024)), n_seeds=2):
    """Print, per SA stage, the JAX bf16 step's gradient relative in norm
    from the JAX f32 step's at larger steps (XLA paths, no padding), to see
    whether a larger step would make the bf16 gradient comparable."""
    steps = {}
    set_pallas_mode("never")
    for B, N in sizes:
        for seed in range(n_seeds):
            rng = np.random.default_rng(seed)
            v = random_flax_variables(seed)
            pts = rng.normal(size=(B, N, 3)).astype(np.float32)
            probs = rng.dirichlet(np.ones(8), size=B).astype(np.float32)
            grads = {}
            for dtype in (jnp.bfloat16, None):
                if (B, N, dtype) not in steps:
                    model = _NoDropPP8Dir(dtype=dtype)

                    def loss_fn(params, stats, pts, probs, model=model):
                        logits, _ = model.apply({"params": params, "batch_stats": stats}, pts,
                                                train=True, mutable=["batch_stats"])
                        return jnp.mean(jax_kl(logits, probs)[1])

                    steps[(B, N, dtype)] = jax.jit(jax.grad(loss_fn))
                grads[dtype] = _by_path(steps[(B, N, dtype)](v["params"], v["batch_stats"],
                                                             pts, probs))
            keep = [not z for z in _zero_in_exact_arithmetic(v["params"])]
            paths = [p for p, k in zip(sorted(grads[None]), keep) if k]
            for stage in ("SetAbstraction_0", "SetAbstraction_1", "SetAbstraction_2"):
                names = [p for p in paths if stage in p]
                a = np.concatenate([grads[jnp.bfloat16][p].ravel() for p in names])
                b = np.concatenate([grads[None][p].ravel() for p in names])
                print(f"B={B} N={N} seed {seed} {stage}: JAX bf16-JAX f32 "
                      f"{np.linalg.norm(a - b) / np.linalg.norm(b):.3f}", flush=True)
    set_pallas_mode("auto")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16.py [sizes]
    import sys

    _size_sweep() if sys.argv[1:] == ["sizes"] else _sweep()
