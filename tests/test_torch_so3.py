"""The port's SO(3) slice against the JAX package: ``so3_matrix`` against
``random_so3_matrix``, every pipeline target under ``rotation_mode`` "so3"
and "none" from the JAX rotation, the target synthesis on vertical forward
vectors, the three SO(3) models (``PointNetPP``, ``PointNetPPXYZ``,
``PointNetPPXYZSchmidt``) in eval and served, the trunk with FPS and the
ball query, the ``forward_mse`` and ``axes`` tasks' loss and gradients
against the JAX float64 step, and the three presets.

Near a vertical forward vector the yaw angle is ``atan2`` of rounding noise
and of signed zeros: a one-ulp difference in the rotation moves it
anywhere. So the targets are synthesised from the JAX rotation itself (the
rotations are compared on their own, within 1e-6), and yaw angles are
compared as angles, ``wrap_angle(a - b)``, so that ``pi`` and ``-pi`` (the
two signs of a zero ``fx`` behind a forward that points back) agree.
"""

import dataclasses
import math
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.data import gt as jax_gt
from pointcloud_orientation_tpu.data import pipeline as jax_pipeline
from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.ops import rotations as jax_rot
from pointcloud_orientation_tpu.train import config as jax_config
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu_torch.data import OrientationDataset, gt, rotate_batch
from pointcloud_orientation_tpu_torch.data.pipeline import augment_batch
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.ops import rotations
from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig, preset
from pointcloud_orientation_tpu_torch.train.config import PRESETS
from pointcloud_orientation_tpu_torch.train import tasks as T
from pointcloud_orientation_tpu_torch.train.trainer import config_model_kwargs
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)

SEED = 3
ANGLE_KEYS = ("vm_mu", "mvm_mu")  # yaw angles: compared modulo 2 pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside other
    test processes on the same cores, PyTorch's thread pool otherwise
    spends most of its time waiting for its own descheduled threads (five
    copies of tests/test_torch_per_label.py at once took 666 s each with 8
    threads, against 7 s alone). Restored for the files that follow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _jax_angles(key, batch):
    """The Euler angles ``random_so3_matrix`` draws from ``key``."""
    return jax.random.uniform(key, (batch, 3), minval=0.0, maxval=2.0 * math.pi)


# Euler angles (tx, ty, tz) whose forward vector is vertical to within
# f32's cos(pi/2), or whose rotation holds exact zeros and signed zeros
_EDGE_ANGLES = np.asarray([[np.pi / 2, 0, 0], [3 * np.pi / 2, 0, 0], [0, 0, 0],
                           [np.pi, 0, 0], [0, np.pi / 2, 0], [np.pi / 2, np.pi / 2, np.pi],
                           [0, 0, np.pi / 2]], np.float32)


def test_so3_matrix_matches_jax_random_so3_matrix():
    """The port's ``so3_matrix`` of the angles JAX draws equals
    ``random_so3_matrix``'s rotation within 1e-6 (the JAX products run at
    HIGHEST, the port's are written out elementwise in f32); on the edge
    angles too, against JAX's product of the same three matrices. The
    port's own draw is a rotation: orthonormal, determinant 1."""
    key = jax.random.PRNGKey(SEED)
    want = np.asarray(jax_rot.random_so3_matrix(key, 64))
    got = rotations.so3_matrix(torch.from_numpy(np.array(_jax_angles(key, 64))))
    assert got.dtype == torch.float32 and got.shape == (64, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    with mock.patch.object(jax.random, "uniform", lambda k, shape, **kw: jnp.asarray(
            _EDGE_ANGLES)):
        want = np.asarray(jax_rot.random_so3_matrix(key, len(_EDGE_ANGLES)))
    got = rotations.so3_matrix(torch.from_numpy(_EDGE_ANGLES)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    r = rotations.random_so3_matrix(torch.Generator().manual_seed(0), 32).double()
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(), np.eye(3)[None].repeat(32, 0),
                               atol=1e-6)
    np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0, atol=1e-6)


def _class_arrays(b, rng):
    uniform = rng.random(b) < 0.3
    symm = rng.random(b) < 0.3
    k_spec = rng.choice(np.asarray([0, 1, 2, 4], np.int32), b)
    return uniform, symm, k_spec


def _jax_batch(rot_mode, pts, uniform, symm, k_spec, rot=None):
    """The JAX pipeline's batch with the subsample a no-op (N = M); with
    ``rot``, the JAX rotation draw replaced by it (unjitted)."""
    args = (jax.random.PRNGKey(SEED), jnp.asarray(pts), jnp.asarray(uniform),
            jnp.asarray(symm), jnp.asarray(k_spec))
    if rot is None:
        out = jax_pipeline.augment_batch(*args, num_points=pts.shape[1], rotation_mode=rot_mode)
    else:
        with jax.disable_jit(), mock.patch.object(jax_pipeline, "random_so3_matrix",
                                                  lambda key, b: jnp.asarray(rot)):
            out = jax_pipeline.augment_batch(*args, num_points=pts.shape[1],
                                             rotation_mode=rot_mode)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_targets_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = _np(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ANGLE_KEYS:  # as angles: pi and -pi are one
            d = np.abs(np.remainder(g.astype(np.float64) - w + np.pi, 2 * np.pi) - np.pi)
            assert d.max() <= 2e-6, (k, d.max())
        elif k == "mvm_k":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["so3", "so3-vertical", "none"])
def test_pipeline_targets_match_jax(case):
    """Every target of the pipeline (points, rotation, axes, forward, the
    8-direction, vM and MvM targets) from the JAX rotation, the port's
    ``rotate_batch`` against the JAX ``augment_batch``: ``so3`` on its own
    draw of 64 rotations, ``so3-vertical`` on the edge angles (vertical
    forward vectors, exact and signed zeros), and ``none`` (the identity).
    Angles within 2e-6 as angles, the rest within 1e-6."""
    rng = np.random.default_rng(SEED)
    b = 64 if case == "so3" else len(_EDGE_ANGLES)
    pts = rng.normal(size=(b, 96, 3)).astype(np.float32)
    uniform, symm, k_spec = _class_arrays(b, rng)
    if case == "so3-vertical":
        with mock.patch.object(jax.random, "uniform", lambda k, shape, **kw: jnp.asarray(
                _EDGE_ANGLES)):
            rot = np.asarray(jax_rot.random_so3_matrix(jax.random.PRNGKey(0), b))
        want = _jax_batch("so3", pts, uniform, symm, k_spec, rot)
        fwd = want["forward"]
        assert np.hypot(fwd[0, 0], fwd[0, 2]) < 1e-7  # tx = pi/2: vertical to within cos(pi/2)
    else:
        want = _jax_batch(case, pts, uniform, symm, k_spec)
    got = rotate_batch(torch.from_numpy(pts), torch.from_numpy(want["rotation"]),
                       torch.from_numpy(uniform), torch.from_numpy(symm),
                       torch.from_numpy(k_spec))
    _assert_targets_equal(got, want)
    if case == "none":
        np.testing.assert_array_equal(want["rotation"], np.eye(3, dtype=np.float32)[None]
                                      .repeat(b, 0))
        np.testing.assert_array_equal(_np(got["points"]), pts)

    # the port's own draw: uniforms for the subsample first, then the
    # rotation's draws, and the identity under "none"
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    mode = "none" if case == "none" else "so3"
    big = rng.normal(size=(4, 128, 3)).astype(np.float32)
    masks = [torch.from_numpy(a[:4]) for a in (uniform, symm, k_spec)]
    out = augment_batch(g1, torch.from_numpy(big), *masks, 96, rotation_mode=mode)
    u = torch.rand((4, 128), generator=g2)
    want_rot = (torch.eye(3).expand(4, 3, 3) if mode == "none"
                else rotations.random_so3_matrix(g2, 4))
    torch.testing.assert_close(out["rotation"], want_rot, rtol=0, atol=0)
    idx = torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :96]
    sub = torch.gather(torch.from_numpy(big), 1, idx[:, :, None].expand(-1, -1, 3))
    torch.testing.assert_close(out["points"], rotations.rotate_points(sub, want_rot))


def test_vertical_forward_vectors_match_jax_targets():
    """The target synthesis on hand-made forward vectors: exactly vertical
    (horizontal length 0, ``forward_to_mu``'s degenerate branch), just above
    and just below its 1e-8 threshold, of either sign and either sign of
    zero, against the JAX functions on the same vectors: the 8-direction
    probabilities within 1e-6, the angles as angles within 1e-6."""
    h = np.float32(1.5e-8)
    fwd = np.asarray([[0, 1, 0], [0, -1, 0], [-0.0, 1, -0.0], [h, 1, 0], [0, 1, h],
                      [-h, -1, 0], [0, 1, -h], [5e-9, 1, 5e-9], [h, 1, -h], [1e-30, 1, 0]],
                     np.float32)
    side = np.roll(fwd, 1, axis=-1)
    rng = np.random.default_rng(SEED)
    uniform, symm, k_spec = _class_arrays(len(fwd), rng)
    t = torch.from_numpy
    want_probs = np.asarray(jax_gt.eight_dir_gt(jnp.asarray(fwd), jnp.asarray(uniform)))
    np.testing.assert_allclose(gt.eight_dir_gt(t(fwd), t(uniform)).numpy(), want_probs,
                               rtol=1e-6, atol=1e-6)
    got = {"vm": gt.single_peak_gt(t(fwd), t(symm)),
           "mvm": gt.mvm_gt(t(side), t(fwd), t(k_spec))}
    want = {"vm": jax_gt.single_peak_gt(jnp.asarray(fwd), jnp.asarray(symm)),
            "mvm": jax_gt.mvm_gt(jnp.asarray(side), jnp.asarray(fwd), jnp.asarray(k_spec))}
    for name in got:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            if i == 0:  # mu
                a = np.remainder(a - b + np.pi, 2 * np.pi) - np.pi
                b = np.zeros_like(b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f"{name}[{i}]")
    mu = rotations.forward_to_mu(t(fwd)).numpy()
    assert mu[0] == 0.0 and mu[7] == 0.0  # degenerate: the forward taken as -z


# (port model, its options); the JAX model takes the same names
_MODELS = {
    "pp": ("pointnet_pp", {}),
    "xyz": ("pointnet_pp_xyz", {}),
    "xyz-raw": ("pointnet_pp_xyz", {"normalize_heads": False}),
    "schmidt": ("pointnet_pp_xyz_schmidt", {}),
    "schmidt-gs": ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True}),
    "schmidt-raw": ("pointnet_pp_xyz_schmidt", {"normalize_heads": False}),
    "schmidt-gs-raw": ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True,
                                                   "normalize_heads": False}),
    "pp-fps-ball": ("pointnet_pp", {"sampling": "fps", "grouping": "ball"}),
    "schmidt-gs-fps-ball": ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True,
                                                        "sampling": "fps",
                                                        "grouping": "ball"}),
}


def _grid_clouds(rng, b, n):
    """Clouds in the unit ball on a grid of 1/64 (every squared distance of
    FPS and the ball query exact in f32, so that no rounding decides a
    centroid or a neighbour)."""
    x = rng.normal(size=(b, n, 3))
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    return (np.round(x * 64) / 64).astype(np.float32)


@pytest.mark.parametrize("case", list(_MODELS))
def test_model_outputs_match_jax(case):
    """Each SO(3) model in eval (CPU plain versions; ``sampling="first"``
    unless the case sets FPS and the ball query, which both packages start
    at index 0 without a generator or ``sampling`` rng) against the JAX
    model on the same flax variables and clouds (B=2, N=256): within 1e-5.
    Normalised heads are unit vectors; Gram-Schmidt's up vector is unit,
    and orthogonal to the forward one where that is unit too (with raw
    heads it is projected on a forward vector of any length, as in JAX)."""
    name, kw = _MODELS[case]
    kw = {"sampling": "first", **kw}
    v = random_flax_variables(SEED, name)
    clouds = _grid_clouds(np.random.default_rng(SEED), 2, 256)
    want = JAX_MODELS[name](**kw).apply(v, jnp.asarray(clouds))
    want = tuple(np.asarray(x) for x in (want if isinstance(want, tuple) else (want,)))
    model = load_flax_variables(MODEL_REGISTRY[name](**kw), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(clouds))
    got = tuple(x.numpy() for x in (got if isinstance(got, tuple) else (got,)))
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 3)] * len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if kw.get("normalize_heads", True) and name != "pointnet_pp":
        for g in got:
            np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, rtol=1e-6)
    if kw.get("gram_schmidt"):  # up is normalised, and orthogonal to a unit forward
        np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0, rtol=1e-6)
        if kw.get("normalize_heads", True):
            assert np.abs((got[0] * got[1]).sum(-1)).max() < 1e-6


@pytest.mark.parametrize("name", ["pointnet_pp", "pointnet_pp_xyz", "pointnet_pp_xyz_schmidt"])
def test_flax_variables_round_trip_and_match_the_flax_tree(name):
    """``random_flax_variables`` has the JAX model's tree (names and
    shapes, its head scopes ``Dense_0``, ``head_x``/``head_y`` or
    ``head_y``/``head_z``), the tree fixes no constructor argument, and
    ``to_flax_variables`` of a model loaded from it gives it back exactly."""
    shapes = jax.eval_shape(lambda: JAX_MODELS[name]().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)), train=False))
    v = random_flax_variables(1, name)
    assert jax.tree_util.tree_map(lambda x: x.shape, v) == \
        jax.tree_util.tree_map(lambda x: x.shape, shapes)
    assert model_kwargs(name, v["params"]) == {}
    back = to_flax_variables(load_flax_variables(MODEL_REGISTRY[name](), v))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(v)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name, kw", [
    ("pointnet_pp", {}),
    ("pointnet_pp_xyz", {"normalize_heads": False}),
    ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True}),
], ids=["pp", "xyz-raw", "schmidt-gs"])
def test_predictor_outputs_and_forward_vectors_match_jax(name, kw):
    """B=6 (two chunks of max_batch 4) of 100-point clouds cycled to 160:
    the native outputs (a tuple of two axes for the two-axis heads) and
    ``forward_vectors`` (the last head, or the raw vector) within 1e-5."""
    v = random_flax_variables(7, name)
    common = dict(num_points=160, max_batch=4, sampling="first", **kw)
    jax_pred = JaxPredictor(name, v["params"], v["batch_stats"], **common)
    port = OrientationPredictor(name, v["params"], v["batch_stats"], device="cpu", **common)
    clouds = np.random.default_rng(SEED).normal(size=(6, 100, 3)).astype(np.float32)
    want, got = jax_pred(clouds), port(clouds)
    assert isinstance(got, tuple) == isinstance(want, tuple) == (name != "pointnet_pp")
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert isinstance(g, np.ndarray) and g.shape == (6, 3)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    fwd = port.forward_vectors(clouds)
    np.testing.assert_allclose(fwd, jax_pred.forward_vectors(clouds), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the tasks' train step against the JAX float64 step
# ---------------------------------------------------------------------------

B, N = 6, 256
# case: (task, model, config fields)
_STEPS = {
    "forward_mse-row0": ("forward_mse", "pointnet_pp", {"target_row": 0}),
    "forward_mse-row2": ("forward_mse", "pointnet_pp", {"target_row": 2}),
    "axes": ("axes", "pointnet_pp_xyz_schmidt", {"lambda_orth": 0.1}),
    "axes-gs-raw": ("axes", "pointnet_pp_xyz_schmidt",
                    {"lambda_orth": 0.7, "axes_gram_schmidt": True,
                     "axes_normalize_heads": False}),
    "axes-xyz": ("axes", "pointnet_pp_xyz", {"lambda_orth": 0.3}),
}


def _step_inputs(case, seed=SEED):
    """Variables, B=6 clouds of N=256 points, the axes of JAX SO(3)
    rotations (the targets), the last sample padded, and both configs."""
    task, model, fields = _STEPS[case]
    rng = np.random.default_rng(seed)
    v = random_flax_variables(seed, model)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    rot = jax_rot.random_so3_matrix(jax.random.PRNGKey(seed), B)
    axes = np.asarray(jax_rot.axes_gt_from_rotation(rot))
    valid = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    cfg = TrainConfig(task=task, model=model, rotation_mode="so3", **fields)
    jcfg = jax_config.TrainConfig(task=task, model=model, rotation_mode="so3", **fields)
    return v, pts, axes, valid, cfg, jcfg


_JAX_STEPS = {}


def _jax_step(case, seed=SEED):
    """Loss, batch statistics and gradients of the JAX model's train step in
    float64 (dropout the identity, centroids "first", the model built as
    the JAX ``Trainer._build_model`` builds it), with the float32 loss and
    the float64 angular errors of the outputs."""
    if (case, seed) in _JAX_STEPS:
        return _JAX_STEPS[case, seed]
    task, model_name, _ = _STEPS[case]
    v, pts, axes, valid, _, jcfg = _step_inputs(case, seed)
    fields = {f.name for f in dataclasses.fields(JAX_MODELS[model_name])}
    model_kw = {k: val for k, val in (("gram_schmidt", jcfg.axes_gram_schmidt),
                                      ("normalize_heads", jcfg.axes_normalize_heads))
                if k in fields}
    model = JAX_MODELS[model_name](sampling="first", **model_kw)
    adapter = jax_tasks.TASKS[task]

    def run(dtype, grads=True):
        cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                      {"v": v, "pts": pts, "axes": axes, "valid": valid})

        def loss_fn(params):
            out, mut = model.apply({"params": params, "batch_stats": cast["v"]["batch_stats"]},
                                   cast["pts"], train=True, mutable=["batch_stats"])
            per = adapter.loss(out, {"axes": cast["axes"]}, jcfg)
            loss = jnp.sum(per * cast["valid"]) / jnp.maximum(jnp.sum(cast["valid"]), 1.0)
            return loss, (mut["batch_stats"], out)

        # eager, not jitted: XLA's CPU fusion recomputes the pooled stage's
        # operand of the max in another rounding, so the jitted VJP can miss
        # the max's location (at seed 3 it gives the group-all stage's
        # gradients the wrong sign; the eager step agrees with finite
        # differences)
        if not grads:
            return loss_fn(cast["v"]["params"])[0]
        (loss, (stats, out)), grad = jax.value_and_grad(loss_fn, has_aux=True)(
            cast["v"]["params"])
        ang = adapter.angular_error(out, {"axes": cast["axes"]}, jcfg)
        return loss, stats, grad, out, ang

    with jax.enable_x64(True), mock.patch.object(fnn.Dropout, "__call__",
                                                 lambda self, x, *a, **k: x):
        loss, stats, grads, out, ang = run(jnp.float64)
        loss32 = run(jnp.float32, grads=False)
        _JAX_STEPS[case, seed] = jax.tree_util.tree_map(np.asarray,
                                                        (loss, stats, grads, loss32, out, ang))
    return _JAX_STEPS[case, seed]


def _norm_excess(got, want) -> float:
    """As in tests/test_torch_train_step.py: how far ``got`` lies from
    ``want`` in norm beyond 1e-5 per entry, relative to ``want``'s norm."""
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


def _loss_rtol(want_loss, jax_f32_loss) -> float:
    """The bound on the port's float32 loss relative to the float64 one, as
    ``_loss_rtol`` of tests/test_torch_heads_train.py: 1e-5, or the JAX
    float32 step's own distance from float64 where that is larger. Read
    over seeds 0-11 on these five cases (``python tests/test_torch_so3.py
    0 1 ... 11`` prints it): the port's loss within 1.5e-5 of float64 and
    JAX float32's within 1.5e-4; where the port passed 1e-5 (seed 0, axes
    1.1e-5 and axes-xyz 1.5e-5) JAX float32 lay 2.5e-5 and 3.8e-5 away."""
    want = float(want_loss)
    return max(1e-5, abs(float(jax_f32_loss) - want) / abs(want))


@pytest.mark.parametrize("case", list(_STEPS))
def test_task_train_step_matches_jax_f64_step(case):
    """One float32 Trainer step of ``forward_mse`` (``target_row`` 0 and 2)
    and ``axes`` (``lambda_orth`` 0.1 to 0.7; Gram-Schmidt and raw heads;
    both two-axis models) against the JAX float64 step on the same
    variables and batch: loss within ``_loss_rtol``, running statistics
    within 2e-6, each gradient leaf within 3e-2 relative in norm beyond
    1e-5 per entry (the bounds of tests/test_torch_heads_train.py; the
    worst leaf over seeds 0-11 read 2.3e-2, at seed 8, ``_sweep``). The
    angular error of the same outputs in float64 on both sides within 1e-6
    degrees (``arccos`` near 0 turns a cosine error of 1e-7, f32's, into
    0.026 degrees, and float64's 2.2e-16 into 1.2e-6)."""
    want_loss, want_stats, want_grads, jax_f32_loss, want_out, want_ang = _jax_step(case)
    v, pts, axes, valid, cfg, _ = _step_inputs(case)
    ds = OrientationDataset.synthetic(samples_per_class=2, num_points=N)
    trainer = Trainer(cfg.replace(batch_size=B, num_points=N), ds, device="cpu",
                      sampling="first", p_drop=0.0)
    load_flax_variables(trainer.model, v)
    batch = {"points": torch.from_numpy(pts), "axes": torch.from_numpy(axes)}
    m = trainer.train_step(batch, torch.from_numpy(valid), None)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                               rtol=_loss_rtol(want_loss, jax_f32_loss))
    got_grads = to_flax_variables(trainer.model, grads=True)["params"]
    leaves = jax.tree_util.tree_leaves_with_path
    assert len(leaves(got_grads)) == len(leaves(want_grads))
    for (path, g), (_, w) in zip(leaves(got_grads), leaves(want_grads)):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(g).all(), name
        assert _norm_excess(g, w) <= 3e-2, (name, _norm_excess(g, w))
    got_stats = to_flax_variables(trainer.model)["batch_stats"]
    for (path, g), (_, w) in zip(leaves(got_stats), leaves(want_stats)):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=jax.tree_util.keystr(path))

    out64 = tuple(torch.from_numpy(np.asarray(o)) for o in
                  (want_out if isinstance(want_out, tuple) else (want_out,)))
    out64 = out64 if len(out64) > 1 else out64[0]
    ang = T.TASKS[cfg.task].angular_error(out64, {"axes": torch.from_numpy(axes).double()}, cfg)
    assert ang.dtype == torch.float64
    np.testing.assert_allclose(ang.numpy(), want_ang, rtol=0, atol=1e-6)
    assert (ang >= 0).all() and (ang <= 180).all()


def test_axes_loss_terms_and_angles_at_their_edges():
    """The axes loss by its terms (the heads' MSE mean, then ``lambda_orth``
    times the squared dot product) and the angular error where ``arccos``
    is steepest, against the JAX adapters in float64: parallel, opposite
    and orthogonal vectors, a zero vector (``_unit``'s eps 1e-8 keeps it
    finite), and the forward_mse angle on rows 0 and 2. Angles within
    2e-6 degrees: one float64 ulp of the cosine at 1 is 1.2e-6 degrees."""
    rng = np.random.default_rng(SEED)
    axes = np.asarray(jax_rot.axes_gt_from_rotation(jax_rot.random_so3_matrix(
        jax.random.PRNGKey(1), 5)), np.float64)
    fz = axes[:, 2].copy()
    fz[1] = -fz[1]  # opposite: 180 degrees
    fz[2] = axes[2, 0]  # orthogonal: 90 degrees
    fz[3] = 0.0  # zero vector
    fz[4] += 1e-9 * rng.normal(size=3)  # parallel to within 1e-9
    vy = axes[:, 1] + 0.1 * rng.normal(size=(5, 3))
    for lam in (0.0, 0.1, 2.5):
        cfg = TrainConfig(task="axes", model="pointnet_pp_xyz_schmidt", lambda_orth=lam)
        jcfg = jax_config.TrainConfig(task="axes", lambda_orth=lam)
        with jax.enable_x64(True):
            want = np.asarray(jax_tasks.TASKS["axes"].loss((jnp.asarray(vy), jnp.asarray(fz)),
                                                           {"axes": jnp.asarray(axes)}, jcfg))
            want_ang = np.asarray(jax_tasks.TASKS["axes"].angular_error(
                (jnp.asarray(vy), jnp.asarray(fz)), {"axes": jnp.asarray(axes)}, jcfg))
        out = (torch.from_numpy(vy), torch.from_numpy(fz))
        got = T.TASKS["axes"].loss(out, {"axes": torch.from_numpy(axes)}, cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        terms = ((vy - axes[:, 1]) ** 2).mean(-1) / 2 + ((fz - axes[:, 2]) ** 2).mean(-1) / 2
        np.testing.assert_allclose(got, terms + lam * (vy * fz).sum(-1) ** 2, rtol=1e-12)
        ang = T.TASKS["axes"].angular_error(out, {"axes": torch.from_numpy(axes)}, cfg).numpy()
        np.testing.assert_allclose(ang, want_ang, rtol=0, atol=2e-6)
    # arccos amplifies at the ends: the f32 axes' unit length (to 1e-7) and
    # _unit's eps put the opposite vectors' angle 0.0115 degrees from 180
    assert 179.9 < ang[1] <= 180.0 and abs(ang[2] - 90.0) < 1e-5 and ang[4] < 0.1
    for row in (0, 2):
        cfg = TrainConfig(task="forward_mse", model="pointnet_pp", target_row=row)
        jcfg = jax_config.TrainConfig(task="forward_mse", target_row=row)
        with jax.enable_x64(True):
            want = np.asarray(jax_tasks.TASKS["forward_mse"].angular_error(
                jnp.asarray(fz), {"axes": jnp.asarray(axes)}, jcfg))
        got = T.TASKS["forward_mse"].angular_error(torch.from_numpy(fz),
                                                   {"axes": torch.from_numpy(axes)}, cfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# the presets and the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pointnet_pp_forward", "axes_all_labels", "8dir"])
def test_preset_fields_equal_jax_and_train_a_step(name):
    """Every field of the port's preset equals the JAX package's
    ``PRESETS`` entry (the JAX config module imports no JAX); the model is
    built as the JAX ``_build_model`` builds it (``gram_schmidt``,
    ``normalize_heads``); and a B=4, N=256 Trainer step on the CPU is finite
    with float32 parameters and Adam state."""
    ours, theirs = preset(name), jax_config.PRESETS[name]
    for field in ours.__dataclass_fields__:
        assert getattr(ours, field) == getattr(theirs, field), field
    classes = list(ours.classes) if ours.classes else None
    ds = OrientationDataset.synthetic(samples_per_class=4, num_points=N, class_names=classes)
    for extra in ({}, {"axes_gram_schmidt": True, "axes_normalize_heads": False}):
        cfg = preset(name, batch_size=4, num_points=N, **extra)
        trainer = Trainer(cfg, ds, device="cpu")
        kw = config_model_kwargs(cfg)
        if cfg.model == "pointnet_pp_xyz_schmidt":
            assert kw["gram_schmidt"] == trainer.model.gram_schmidt == cfg.axes_gram_schmidt
            assert kw["normalize_heads"] == trainer.model.normalize_heads \
                == cfg.axes_normalize_heads
        else:
            assert "gram_schmidt" not in kw and "normalize_heads" not in kw
        idx, valid, _ = next(trainer.train_ds.batches(4))
        batch, valid, _ = trainer.device_batch(trainer.train_ds, idx, valid,
                                               trainer.generator(0, 1, 0))
        assert torch.allclose(torch.linalg.det(batch["rotation"]), torch.ones(4), atol=1e-5)
        m = trainer.train_step(batch, valid, trainer.generator(0, 1, 0))
        assert math.isfinite(float(m["loss"]))
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in trainer.model.parameters())
        assert all(t.dtype == torch.float32 for st in trainer.optimizer.state.values()
                   for t in st.values() if t.dim())


def test_forward_mse_trains_on_the_cpu_and_the_unported_still_raises():
    """``TrainConfig(task="forward_mse", model="pointnet_pp",
    rotation_mode="so3")`` trains an epoch with the FPS/ball trunk on the
    CPU; every JAX preset is ported (the MoE transformer's last, with the
    JAX preset's fields) and the MoE model is accepted as the JAX config
    accepts it; an unknown rotation mode and the JAX field still unported
    raise. A dataset with stored targets
    gives them to the batch under ``rotation_mode="none"``
    (tests/test_torch_real_data.py holds that path against the JAX
    trainer)."""
    cfg = TrainConfig(task="forward_mse", model="pointnet_pp", rotation_mode="so3", epochs=1,
                      batch_size=4, num_points=N)
    ds = OrientationDataset.synthetic(samples_per_class=3, num_points=N)
    trainer = Trainer(cfg, ds, device="cpu", sampling="fps", grouping="ball")
    hist = trainer.fit(log_every=0)
    assert math.isfinite(hist["train"][0]) and 0 <= hist["val_ang"][0] <= 180
    for name in ("moe_point_transformer",):  # the last preset ported: the JAX one's fields
        got = dataclasses.asdict(preset(name))
        want = dataclasses.asdict(jax_config.PRESETS[name])
        assert got == {k: want[k] for k in got}
    assert set(PRESETS) == set(jax_config.PRESETS)
    with pytest.raises(NotImplementedError):
        TrainConfig(rotation_mode="so2")
    assert TrainConfig(model="moe_point_transformer").model == jax_config.TrainConfig(
        model="moe_point_transformer").model
    sync = preset("pointnet_pp_forward", bn_sync_axis="data")  # the JAX field, refused in use
    assert sync.bn_sync_axis == "data"
    with pytest.raises(ValueError, match="global batch"):
        Trainer(sync, OrientationDataset.synthetic(samples_per_class=1, num_points=N),
                device="cpu")
    stored = OrientationDataset.synthetic(samples_per_class=1, num_points=N)
    stored.targets = {"axes": np.zeros((len(stored), 3, 3), np.float32)}
    t = Trainer(cfg.replace(rotation_mode="none"), stored, device="cpu")
    idx, valid, _ = next(stored.batches(4))
    batch, _, _ = t.device_batch(stored, idx, valid, t.generator(0, 1, 0))
    assert not batch["axes"].any() and batch["axes"].shape == (4, 3, 3)


def _sweep(seeds):
    """Print, per case and seed, the port's and JAX float32's loss distance
    from the float64 step and the port's worst gradient leaf: the reading
    behind the bounds of ``test_task_train_step_matches_jax_f64_step``."""
    for seed in seeds:
        for case in _STEPS:
            want_loss, _, want_grads, jax_f32_loss, _, _ = _jax_step(case, seed)
            v, pts, axes, valid, cfg, _ = _step_inputs(case, seed)
            ds = OrientationDataset.synthetic(samples_per_class=2, num_points=N)
            trainer = Trainer(cfg.replace(batch_size=B, num_points=N), ds, device="cpu",
                              sampling="first", p_drop=0.0)
            load_flax_variables(trainer.model, v)
            m = trainer.train_step({"points": torch.from_numpy(pts),
                                    "axes": torch.from_numpy(axes)}, torch.from_numpy(valid), None)
            got = to_flax_variables(trainer.model, grads=True)["params"]
            worst = max(_norm_excess(g, w) for g, w in zip(jax.tree_util.tree_leaves(got),
                                                           jax.tree_util.tree_leaves(want_grads)))
            rel = abs(float(m["loss"]) - float(want_loss)) / abs(float(want_loss))
            rel32 = abs(float(jax_f32_loss) - float(want_loss)) / abs(float(want_loss))
            print(f"seed {seed} {case:16s} loss port {rel:.2e} jax-f32 {rel32:.2e}  "
                  f"worst grad {worst:.2e}", flush=True)


if __name__ == "__main__":
    import sys

    _sweep([int(a) for a in sys.argv[1:]] or range(6))
