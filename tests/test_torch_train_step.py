"""One train step of the port's PointNetPP8Dir against the JAX package's, the
batch pipeline and dataset against theirs, and the port's Trainer on the CPU
(finite losses, best-val snapshot, checkpoint round trip)."""

import contextlib
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.data import OrientationDataset as JaxDataset
from pointcloud_orientation_tpu.data import split_indices as jax_split_indices
from pointcloud_orientation_tpu.data.gt import eight_dir_gt as jax_eight_dir_gt
from pointcloud_orientation_tpu.losses import soft_label_kl_8dir as jax_kl
from pointcloud_orientation_tpu.losses import softmax_mse_8dir_loss as jax_mse
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.ops import rotations as jax_rot
from pointcloud_orientation_tpu.ops.geometry import set_pallas_mode
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu_torch import data as D
from pointcloud_orientation_tpu_torch import losses as TL
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import rotations as R
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import tasks as T
from pointcloud_orientation_tpu_torch.train.trainer import clip_by_global_norm_
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)

LR = 1e-3


class _NoDropPP8Dir(nn.Module):
    """PointNetPP8Dir's variable tree (``PointNetPPTrunk_0``, ``Dense_0``)
    with dropout off and deterministic centroids, so that both frameworks
    run the same function (their random streams differ)."""

    @nn.compact
    def __call__(self, xyz, train: bool = False):
        return nn.Dense(8)(JaxTrunk(p_drop=0.0, sampling="first")(xyz, train=train))


def _tiny_dataset(**kw):
    return D.OrientationDataset.synthetic(samples_per_class=3, num_points=256, **kw)


def _tiny_trainer(fused=False, **cfg):
    c = preset("8dir_kl", batch_size=4, num_points=256, epochs=2, **cfg)
    return Trainer(c, _tiny_dataset(), device="cpu", fused_mlp_train=fused,
                   sampling="first", p_drop=0.0)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _pre_bn_bias(path) -> bool:
    """A Dense bias that feeds a train-mode BatchNorm: every Dense but the
    head's ``Dense_0`` at the top of the tree."""
    keys = [p.key for p in path]
    return keys[-1] == "bias" and keys[-2].startswith("Dense") and len(keys) > 2


def _norm_excess(got, want) -> float:
    """How far ``got`` lies from ``want`` in norm beyond 1e-5 per entry,
    relative to the norm of ``want``: a leaf whose exact gradient is zero
    passes when its rounding noise stays under 1e-5 per entry."""
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


# mode -> (Pallas mode, PCOT_FUSED_MLP, dtype of the JAX step, dtype of the port's step)
_MODES = {
    "auto-f64": ("auto", False, np.float64, np.float64),
    "auto": ("auto", False, np.float64, np.float32),
    "always": ("always", False, np.float64, np.float32),
    "always-fused": ("always", True, np.float32, np.float32),
}
_JAX_STEPS = {}  # (Pallas mode, fused, dtype, seed) -> the JAX step's results
SEED = 42


def _step_inputs(seed=SEED):
    """Variables and a batch of B=8 clouds of N=256 points, the last sample
    padded, as float32 numbers (cast up for the float64 runs)."""
    rng = np.random.default_rng(seed)
    B, N = 8, 256
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), random_flax_variables(seed))
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(8), size=B).astype(np.float32)
    fwd = rng.normal(size=(B, 3)).astype(np.float32)
    valid = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    return v, pts, probs, fwd, valid


def _jax_step(pallas_mode, fused, dtype, seed=SEED):
    """Loss, batch statistics and gradients of the JAX model's train step,
    jitted, and its parameters after one optax Adam step. The caller sets
    ``PCOT_FUSED_MLP`` to match ``fused``."""
    key = (pallas_mode, fused, dtype, seed)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    v, pts, probs, _, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                                     _step_inputs(seed))
    model = _NoDropPP8Dir()

    def loss_fn(params):
        logits, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                  jnp.asarray(pts), train=True, mutable=["batch_stats"])
        _, per = jax_kl(logits, jnp.asarray(probs))
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0), mut["batch_stats"]

    @jax.jit
    def step(params):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        tx = optax.adam(LR)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, stats, grads, optax.apply_updates(params, updates)

    set_pallas_mode(pallas_mode)
    try:
        with jax.enable_x64(dtype == np.float64):
            _JAX_STEPS[key] = jax.tree_util.tree_map(np.asarray, step(v["params"]))
    finally:
        set_pallas_mode("auto")
    return _JAX_STEPS[key]


def _port_step(fused, dtype, seed=SEED):
    """One step of the port's Trainer on the same inputs: its loss, and its
    gradients, statistics and parameters after the step as flax trees."""
    v, pts, probs, fwd, valid = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                                       _step_inputs(seed))
    trainer = _tiny_trainer(fused=fused)
    trainer.model.to(torch.from_numpy(pts).dtype)
    load_flax_variables(trainer.model, v)
    batch = {"points": torch.from_numpy(pts), "probs_8dir": torch.from_numpy(probs),
             "forward": torch.from_numpy(fwd)}
    with contextlib.ExitStack() as stack:
        if dtype == np.float64:  # the float32 wrappers' plain versions take any float dtype
            stack.enter_context(mock.patch.object(K, "sa_group", K.sa_group_plain))
            stack.enter_context(mock.patch.object(K, "sa_group_scatter",
                                                  K.sa_group_scatter_plain))
            # the JAX trunk casts its output to float32 (models/layers.py:258), which
            # rounds the feature and, in the backward, its cotangent: do the same
            hook = trainer.model.trunk.register_forward_hook(
                lambda module, args, out: out.float().double())
            stack.callback(hook.remove)
        m = trainer.train_step(batch, torch.from_numpy(valid), None)
    got = to_flax_variables(trainer.model)
    return (float(m["loss"]), got["batch_stats"],
            to_flax_variables(trainer.model, grads=True)["params"], got["params"], v["params"])


def _readings(got, want):
    """Loss (relative), statistics (largest |a - b| / (1 + |b|)) and
    gradients (largest ``_norm_excess`` over the leaves) of ``got`` from
    ``want``, both (loss, statistics, gradients, ...)."""
    loss = abs(got[0] - float(want[0])) / abs(float(want[0]))
    stats = max(float(np.max(np.abs(a - b) / (1 + np.abs(b))))
                for (_, a), (_, b) in zip(_leaves(got[1]), _leaves(want[1])))
    grads = max(_norm_excess(a, b) for (_, a), (_, b) in zip(_leaves(got[2]), _leaves(want[2])))
    return loss, stats, grads


@pytest.mark.parametrize("mode", list(_MODES))
def test_train_step_matches_jax(monkeypatch, mode):
    """One step of the port's Trainer against value_and_grad + optax.adam
    on the same variables and batch (B=8 clouds of 256 points, the last one
    padded).

    'auto-f64' runs both sides in float64 (the JAX model's XLA path; the
    port's plain versions, which the float32 wrappers call on CPU tensors;
    the trunk's output rounded to float32 on both sides, as the JAX trunk
    returns float32): loss within 1e-5 relative, every gradient within rtol 1e-4 and atol
    1e-5 (times the leaf's largest gradient when above 1), running
    statistics within 1e-6, and the parameters after one Adam step within
    1e-5. The Dense biases that feed a train-mode BatchNorm have gradient
    zero in exact arithmetic (the batch mean removes them) and hold rounding
    noise; Adam's first step moves such a parameter by lr*g/(|g|+eps), so
    those are only held to |change| <= lr.

    'auto' and 'always' hold the port's float32 step to the same float64
    JAX step, taken through the XLA path ('auto') or through the fused
    grouping kernel and its scatter VJP in interpret mode ('always'). The
    float64 step is the reference because the JAX model's own float32 step
    lies far from it: over 21 seeds of these shapes (``_sweep``) it differs
    from it by up to 1.2e-5 in the loss, 1.5e-5 in the statistics and
    6.3e-2 relative in norm in a leaf's gradient (its reductions round
    more, and the rounding flips ReLU and max-pool choices between
    near-equal values), where the port's float32 step differs by at most
    1.1e-6, 7.8e-7 and 1.1e-2 (8.2e-7, 8.6e-7 and 7.5e-4 at this seed).
    Bounds: loss 1e-5 relative, statistics 2e-6, and each gradient leaf
    within 3e-2 relative in norm beyond 1e-5 per entry (``_norm_excess``;
    a leaf whose exact gradient is zero, as the pre-BatchNorm Dense
    biases', is held to that 1e-5). Adam's first step is lr*sign(g) where
    |g| >> eps, so a gradient entry at rounding-noise level moves its
    parameter anywhere in [-lr, lr]: the parameters after the step are held
    only in 'auto-f64'.

    'always-fused' (``PCOT_FUSED_MLP=1``: the fused MLP+max kernel, its
    backward and ghost BatchNorm statistics, against the port's
    ``fused_mlp_train``) runs the JAX side in float32 only, as its Pallas
    kernels take float32 alone, so the comparison carries the JAX step's
    own float32 error (above). Over 31 seeds (``_sweep``) the two differ by
    at most 9.2e-6 in the loss, 7.5e-6 in the statistics and 6.4e-2 in a
    gradient leaf (8.7e-7, 9.7e-6 and 1.6e-2 at this seed). Bounds: loss
    2e-5 relative, statistics 2e-5, each gradient leaf 2e-1."""
    pallas_mode, fused, jax_dtype, dtype = _MODES[mode]
    if fused:
        monkeypatch.setenv("PCOT_FUSED_MLP", "1")
    want_loss, want_stats, want_grads, want_params = _jax_step(pallas_mode, fused, jax_dtype)
    loss, got_stats, got_grads, got_params, params0 = _port_step(fused, dtype)
    f64 = dtype == np.float64
    np.testing.assert_allclose(loss, float(want_loss), rtol=2e-5 if fused else 1e-5)

    for (path, g), (_, w) in zip(_leaves(got_grads), _leaves(want_grads)):
        name = jax.tree_util.keystr(path)
        if f64:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(w).max()),
                                       err_msg=name)
        else:
            assert _norm_excess(g, w) <= (2e-1 if fused else 3e-2), (name, _norm_excess(g, w))
    tol = 1e-6 if f64 else 2e-5 if fused else 2e-6
    for (path, g), (_, w) in zip(_leaves(got_stats), _leaves(want_stats)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=jax.tree_util.keystr(path))
    if not f64:
        return
    n_checked = 0
    for (path, g), (_, w), (_, w0) in zip(_leaves(got_params), _leaves(want_params),
                                         _leaves(params0)):
        name = jax.tree_util.keystr(path)
        if _pre_bn_bias(path):
            assert np.abs(g - w0).max() <= LR * (1 + 1e-4), name
            assert np.abs(w - w0).max() <= LR * (1 + 1e-4), name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        n_checked += 1
    assert n_checked == 3 * 9 + 2 * 3 + 2  # SA kernels + BN scale/bias, FC ditto, head


def test_adam_and_clip_match_optax_on_the_same_gradients(rng):
    """The port's optimizer step (torch Adam with optax's constants) and
    global-norm clip against optax on identical gradients, over two steps."""
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    p_jax, state = [jnp.asarray(p) for p in params], None
    state = tx.init(p_jax)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.Adam(tp, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        clip_by_global_norm_(tp, 1.0)
        opt.step()
    for a, b in zip(tp, p_jax):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_pipeline_pieces_match_jax(rng):
    """Yaw matrices, rotation, axes, 8-dir targets (uniform classes too),
    losses, the angular error and the subsample from the same uniforms."""
    B, M, N = 4, 300, 128
    theta = rng.uniform(0, 2 * math.pi, size=B).astype(np.float32)
    pts = rng.normal(size=(B, M, 3)).astype(np.float32)
    u = rng.uniform(size=(B, M)).astype(np.float32)
    uniform = np.asarray([False, True, False, True])

    rot_j = jax_rot.yaw_matrix(jnp.asarray(theta))
    rot_t = R.yaw_matrix(torch.from_numpy(theta))
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(R.rotate_points(torch.from_numpy(pts), rot_t).numpy(),
                               np.asarray(jax_rot.rotate_points(jnp.asarray(pts), rot_j)),
                               rtol=1e-6, atol=1e-6)
    axes_t = R.axes_gt_from_rotation(rot_t)
    axes_j = jax_rot.axes_gt_from_rotation(rot_j)
    np.testing.assert_allclose(axes_t.numpy(), np.asarray(axes_j), rtol=1e-6, atol=1e-7)
    probs_t = D.eight_dir_gt(axes_t[:, 2], torch.from_numpy(uniform))
    probs_j = jax_eight_dir_gt(axes_j[:, 2], jnp.asarray(uniform))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), rtol=1e-6, atol=1e-7)

    _, idx = jax.lax.top_k(jnp.asarray(u), N)
    want = np.take_along_axis(pts, np.asarray(idx)[:, :, None], axis=1)
    got = D.subsample_by_uniform(torch.from_numpy(pts), torch.from_numpy(u), N)
    np.testing.assert_array_equal(got.numpy(), want)

    logits = rng.normal(size=(B, 8)).astype(np.float32)
    for ours, theirs in ((TL.soft_label_kl_8dir, jax_kl), (TL.softmax_mse_8dir_loss, jax_mse)):
        a = ours(torch.from_numpy(logits), probs_t)
        b = theirs(jnp.asarray(logits), probs_j)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-7)
    batch_t = {"probs_8dir": probs_t, "forward": axes_t[:, 2]}
    batch_j = {"probs_8dir": probs_j, "forward": axes_j[:, 2]}
    ang_t = T.TASKS["8dir_kl"].angular_error(torch.from_numpy(logits), batch_t, None).numpy()
    ang_j = np.asarray(jax_tasks.TASKS["8dir_kl"].angular_error(jnp.asarray(logits), batch_j, None))
    np.testing.assert_array_equal(np.isnan(ang_t), uniform)
    np.testing.assert_allclose(ang_t, ang_j, rtol=1e-4, atol=1e-3)  # degrees


def test_augment_batch_is_seeded_and_consistent():
    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 200, 3)).astype(np.float32))
    uniform = torch.tensor([False, True, False])
    symm = torch.tensor([False, True, False])
    k_spec = torch.tensor([1, 0, 2], dtype=torch.int32)

    def run(seed):
        return D.augment_batch(torch.Generator().manual_seed(seed), pts, uniform, symm, k_spec,
                               64)

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["points"], c["points"])
    assert a["points"].shape == (3, 64, 3) and a["probs_8dir"].shape == (3, 8)
    torch.testing.assert_close(a["forward"], a["axes"][:, 2])
    torch.testing.assert_close(a["probs_8dir"].sum(-1), torch.ones(3))
    assert torch.equal(a["probs_8dir"][1], torch.full((8,), 0.125))
    # the forward of a yaw rotation stays horizontal
    assert a["forward"][:, 1].abs().max() < 1e-6


def test_dataset_splits_and_batches_match_jax():
    kw = dict(seed=3, samples_per_class=5, num_points=64)
    ours, theirs = D.OrientationDataset.synthetic(**kw), JaxDataset.synthetic(**kw)
    np.testing.assert_array_equal(ours.points, theirs.points)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for a, b in zip(D.split_indices(37, 42), jax_split_indices(37, 42)):
        np.testing.assert_array_equal(a, b)
    sub_o = ours.select_classes(["sofa", "chair"]).split(42)
    sub_t = theirs.select_classes(["sofa", "chair"]).split(42)
    for a, b in zip(sub_o, sub_t):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.uniform_mask, b.uniform_mask)
    for shuffle, seed in ((False, 0), (True, 43)):
        got = list(ours.batches(4, shuffle=shuffle, seed=seed))
        want = list(theirs.batches(4, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) == math.ceil(len(ours) / 4)
        for (i1, v1, f1), (i2, v2, f2) in zip(got, want):
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(v1, v2)
            assert f1 == f2
    assert got[-1][1].min() == 0.0  # 30 clouds: the tail batch is padded and masked
    for a, b in zip(ours.gather_host(np.arange(3)), theirs.gather_host(np.arange(3))):
        np.testing.assert_array_equal(a, b)


def test_trainer_two_epochs_best_val_and_resume(tmp_path):
    """Two epochs on the CPU: finite losses, a best-val snapshot, and a
    checkpoint after epoch 1 whose resumed epoch 2 equals the uninterrupted
    run's, bit for bit."""
    full = _tiny_trainer()
    full.fit(log_every=0)
    assert len(full.history["train"]) == 2 and np.isfinite(full.history["train"]).all()
    assert np.isfinite(full.history["val"]).all() and np.isfinite(full.step_losses).all()
    assert len(full.step_losses) == math.ceil(len(full.train_ds) / 4)
    assert full.best_val_epoch in (1, 2) and full.best_val == min(full.history["val"])
    test = full.test()
    assert np.isfinite(test.mean_loss)

    first = _tiny_trainer()
    first.fit(epochs=1, log_every=0)
    path = first.save_checkpoint(str(tmp_path))
    resumed = _tiny_trainer()
    assert resumed.restore_checkpoint(path) == 1
    resumed.fit(start_epoch=2, log_every=0)
    assert resumed.history == full.history
    for (k, a), b in zip(resumed.model.state_dict().items(), full.model.state_dict().values()):
        assert torch.equal(a, b), k

    full.write_artifacts(str(tmp_path / "out"), test)
    lines = (tmp_path / "out" / "summary.txt").read_text().splitlines()
    assert lines[-1].startswith("Overall\t") and len(lines) == 7


def test_config_takes_the_ported_presets_and_refuses_the_rest():
    cfg = preset("8dir_kl")
    assert (cfg.task, cfg.batch_size, cfg.num_points, cfg.lr, cfg.rotation_mode) == (
        "8dir_kl", 16, 10_000, 1e-3, "yaw")
    assert preset("8dir_mse").task == "8dir_mse"
    assert preset("8dir_kl", compute_dtype=None).task == "8dir_kl"  # a default is fine
    with pytest.raises(NotImplementedError):
        preset("simple_pointnet")
    with pytest.raises(NotImplementedError):
        preset("8dir_kl", compute_dtype="float16")
    with pytest.raises(NotImplementedError):
        preset("8dir_kl", task="forward_mse_aux")
    with pytest.raises(TypeError):
        preset("8dir_kl", no_such_field=1)


def _sweep(n_default=21, n_fused=31):
    """The readings behind the float32 bounds of ``test_train_step_matches_jax``:
    over seeds 0.., the port's float32 step and the JAX float32 step against
    the JAX float64 step on the XLA path, and the port's fused float32 step
    against the JAX fused float32 step. Prints one line per seed and the
    largest (loss, statistics, gradients) of each comparison."""
    import os

    worst = {}

    def note(name, seed, r):
        print(f"seed {seed} {name}: loss {r[0]:.2e} stats {r[1]:.2e} grads {r[2]:.2e}",
              flush=True)
        worst[name] = tuple(max(a, b) for a, b in zip(worst.get(name, r), r))

    for seed in range(n_default):
        exact = _jax_step("auto", False, np.float64, seed)
        note("port f32 vs JAX f64", seed, _readings(_port_step(False, np.float32, seed), exact))
        jax32 = _jax_step("auto", False, np.float32, seed)
        note("JAX f32 vs JAX f64", seed, _readings((float(jax32[0]),) + jax32[1:], exact))
    os.environ["PCOT_FUSED_MLP"] = "1"
    for seed in range(n_fused):
        note("port fused f32 vs JAX fused f32", seed,
             _readings(_port_step(True, np.float32, seed), _jax_step("always", True,
                                                                       np.float32, seed)))
    for name, r in worst.items():
        print(f"largest, {name}: loss {r[0]:.2e} stats {r[1]:.2e} grads {r[2]:.2e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_step.py
    _sweep()
