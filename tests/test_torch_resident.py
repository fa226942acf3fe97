"""The port's default fit on the CPU: the device-resident splits, the
whole-epoch and block paths of the JAX ``Trainer`` (``_resident``,
``_epoch_batches``, ``_run_phase_scan``, ``_fit_blocks``), by the JAX
dispatch rule.

The block fit, the per-epoch resident fit (``checkpoint_every`` with a
``checkpoint_dir``) and the step path (``host_resident``) run the same
steps on the same batches and are bit-equal: history, class history,
weights, statistics, optimizer state, the best-val snapshot and its epoch,
and the kernel wrappers' calls. The block fit against the JAX ``Trainer``'s
default fit on a deterministic configuration; preemption at a block end;
the dispatch rule and the timings the block path keeps.
"""

import contextlib
import dataclasses
import os
from typing import Optional
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu import data as jax_data
from pointcloud_orientation_tpu import models as jax_models
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import preset as jax_preset
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu_torch import data
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import tasks as port_tasks
from pointcloud_orientation_tpu_torch.train import trainer as TR
from pointcloud_orientation_tpu_torch.train.reliability import PreemptionGuard
from pointcloud_orientation_tpu_torch.utils.jax_weights import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)
import torch_parallel_ranks as R

N, B = 128, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_per_label.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name -> (preset, overrides, the dataset's classes): 8dir_kl's KL and the
# mixture head's matched loss; 2 steps an epoch, the last batch partial
CONFIGS = {
    "8dir_kl": ("8dir_kl", {}, ("chair", "sofa", "bottle")),
    "mvm": ("mvm", {"classes": ("chair", "bowl", "cone")}, ("chair", "bowl", "cone")),
}


def _dataset(classes, per_class: int = 5):
    return OrientationDataset.synthetic(samples_per_class=per_class, num_points=N,
                                        class_names=list(classes))


def _state(t):
    opt = t.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in t.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()}, t.step)


def _counting():
    """Count each kernel wrapper's calls (on the CPU they run their plain
    versions, so the launch counters stay at 0)."""
    calls = {}
    stack = contextlib.ExitStack()
    for name in ("sa_group", "sa_mlp_max", "sa_group_scatter", "sa_mlp_max_bwd"):
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        stack.enter_context(mock.patch.object(K, name, counted))
    return stack, calls


def _fit(name, tmp_path, monkeypatch, **kw):
    p, over, classes = CONFIGS[name]
    monkeypatch.setenv("PCOT_EPOCH_BLOCK", "2")
    ckpt = kw.pop("checkpoint_dir", None)
    t = Trainer(preset(p, num_points=N, batch_size=B, epochs=3, **over, **kw),
                _dataset(classes), device="cpu")
    stack, calls = _counting()
    with stack:
        t.fit(log_every=0, checkpoint_dir=ckpt)
    return t, calls


@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_per_epoch_and_step_fits_are_bit_equal(name, tmp_path, monkeypatch):
    """Three epochs in blocks of 2, in the per-epoch loop on the resident
    splits (periodic checkpoints), and on the step path
    (``host_resident``): the same history and class history, weights,
    statistics and Adam moments, best-val snapshot and epoch, step
    losses and kernel wrapper calls, bit for bit."""
    blocks, calls = _fit(name, tmp_path, monkeypatch)
    assert calls["sa_group"] > 0 and calls["sa_mlp_max"] > 0
    for other, other_calls in (
            _fit(name, tmp_path, monkeypatch, checkpoint_every=1,
                 checkpoint_dir=str(tmp_path / "ckpt")),
            _fit(name, tmp_path, monkeypatch, host_resident=True)):
        assert other.history == blocks.history
        np.testing.assert_equal(other.class_history, blocks.class_history)  # NaN: no val
        a, b = _state(other), _state(blocks)
        assert a[2] == b[2] == blocks.step
        for k in a[0]:
            assert torch.equal(a[0][k], b[0][k]), k
        for i in a[1]:
            for k in a[1][i]:
                assert torch.equal(a[1][i][k], b[1][i][k]), (i, k)
        assert other.best_val_epoch == blocks.best_val_epoch is not None
        for k in blocks.best_state:
            assert torch.equal(other.best_state[k], blocks.best_state[k]), k
        assert other.step_losses == blocks.step_losses
        assert other_calls == calls
    assert blocks.best_val == pytest.approx(other.best_val, rel=1e-7)  # f32 against f64


def test_resident_batch_equals_the_host_batch(monkeypatch):
    """A batch built from the resident split (``index_select`` on the
    device) equals the host gather's, key for key and bit for bit, under
    ``rotation_mode="none"`` with stored targets, which keep their
    dtypes; the epoch's index and valid matrices are the batches the step
    path draws."""
    ds = _dataset(("chair", "sofa"))
    rng = np.random.default_rng(3)
    ds.targets = {"axes": rng.normal(size=(len(ds), 3, 3)).astype(np.float32),
                  "probs_8dir": rng.random((len(ds), 8)).astype(np.float32),
                  "mvm_k": rng.integers(0, 4, len(ds)).astype(np.int32)}
    t = Trainer(preset("8dir_kl", num_points=64, batch_size=B, rotation_mode="none"), ds,
                device="cpu")
    idx_mat, valid_mat = t._epoch_batches(t.train_ds, True, 2)
    want = list(t.train_ds.batches(B, shuffle=True, seed=t.cfg.seed + 2))
    assert idx_mat.shape == (len(want), B) and valid_mat.dtype == torch.float32
    resident = t._resident(t.train_ds)
    assert t._resident(t.train_ds) is resident  # cached by identity
    assert resident["tgt_mvm_k"].dtype == torch.int32
    assert resident["tgt_axes"].dtype == resident["points"].dtype == torch.float32
    for bi, (idx, valid, _) in enumerate(want):
        assert np.array_equal(idx_mat[bi].numpy(), idx)
        assert np.array_equal(valid_mat[bi].numpy(), valid)
        got = t.build_batch({k: v.index_select(0, idx_mat[bi]) for k, v in resident.items()},
                            t.generator(0, 2, bi))
        host, host_valid, labels = t.device_batch(t.train_ds, idx, valid, t.generator(0, 2, bi))
        assert got.keys() == host.keys() and {"axes", "probs_8dir", "mvm_k"} <= got.keys()
        for k in host:
            assert got[k].dtype == host[k].dtype and torch.equal(got[k], host[k]), k
        assert np.array_equal(labels, got["labels"].numpy())
        assert torch.equal(host_valid, valid_mat[bi])
        assert torch.equal(got["axes"], torch.from_numpy(t.train_ds.targets["axes"][idx]))


def test_preemption_at_a_block_end_saves_and_resumes(tmp_path, monkeypatch, capsys):
    """A guard requested before the fit stops it at the first block's end,
    with 2 of 6 epochs of history (as tests/test_reliability.py); the
    block path's only checkpoint is that preemption's; resumed from it,
    the run equals the uninterrupted one bit for bit."""
    monkeypatch.setenv("PCOT_EPOCH_BLOCK", "2")
    cfg = preset("8dir_kl", num_points=N, batch_size=B, epochs=6)
    ds = _dataset(("chair",), per_class=4)
    ckpt = str(tmp_path / "ckpt")
    with PreemptionGuard() as guard:
        guard.request()
        run = Trainer(cfg, ds, device="cpu")
        run.fit(log_every=0, checkpoint_dir=ckpt, preemption_guard=guard)
    assert len(run.history["train"]) == 2 and run.epoch == 2
    assert "[preempt] graceful stop after epoch 2" in capsys.readouterr().out
    assert os.listdir(ckpt) == ["epoch_2.pt"]
    full = Trainer(cfg, ds, device="cpu")
    full.fit(log_every=0)
    resumed = Trainer(cfg, ds, device="cpu")
    assert resumed.restore_checkpoint(os.path.join(ckpt, "epoch_2.pt")) == 2
    resumed.fit(log_every=0, start_epoch=3)
    np.testing.assert_equal(resumed.history, full.history)  # NaN: chairs have no val angle
    assert resumed.best_val == full.best_val and resumed.best_val_epoch == full.best_val_epoch
    a, b = _state(resumed), _state(full)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(torch.equal(a[1][i][k], b[1][i][k]) for i in a[1] for k in a[1][i])
    assert all(torch.equal(resumed.best_state[k], full.best_state[k]) for k in full.best_state)


@pytest.mark.parametrize("flags, path", [
    ({}, "blocks"),
    ({"debug_checks": True}, "epochs"),
    ({"host_resident": True}, "epochs"),
    ({"checkpoint_every": 1, "checkpoint_dir": True}, "epochs"),
    ({"checkpoint_every": 1}, "blocks"),
    ({"checkpoint_dir": True}, "blocks"),
])
def test_fit_dispatch_rule(flags, path, tmp_path):
    """The JAX rule (``trainer.py:830-838``): the per-epoch loop under
    ``debug_checks``, ``host_resident`` or ``checkpoint_dir`` with
    ``checkpoint_every``; else the blocks. The passes take the step path
    under ``debug_checks`` and ``host_resident`` alone."""
    flags = dict(flags)
    ckpt = str(tmp_path / "ckpt") if flags.pop("checkpoint_dir", False) else None
    cfg = preset("8dir_kl", num_points=64, batch_size=B, epochs=1, out_dir=str(tmp_path),
                 **flags)
    t = Trainer(cfg, _dataset(("chair",)), device="cpu")
    with mock.patch.object(t, "_fit_blocks", wraps=t._fit_blocks) as blocks, \
            mock.patch.object(t, "run_epoch", wraps=t.run_epoch) as epochs, \
            mock.patch.object(t, "_run_phase_stepwise", wraps=t._run_phase_stepwise) as step, \
            mock.patch.object(t, "_resident_pass", wraps=t._resident_pass) as resident:
        t.fit(log_every=0, checkpoint_dir=ckpt)
        t.test()
    assert (blocks.call_count, epochs.call_count) == ((1, 0) if path == "blocks" else (0, 1))
    stepwise = bool(flags.get("debug_checks") or flags.get("host_resident"))
    assert (step.call_count > 0, resident.call_count > 0) == (stepwise, not stepwise)


class _NoDrop8Dir(nn.Module):
    """PointNetPP8Dir's tree with dropout off and first-point sampling."""

    sampling: str = "first"
    grouping: str = "knn"
    bn_axis_name: Optional[str] = None
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, xyz, train: bool = False):
        return nn.Dense(8)(JaxTrunk(p_drop=0.0, sampling="first")(xyz, train=train))


# The JAX Trainer's default fit against the port's block fit on the
# deterministic configuration of tests/torch_parallel_ranks.py (no dropout,
# first-point centroids, no rotation, SGD) without host_resident, 3 epochs
# in blocks of 2, at lr 1e-2 (at the configuration's lr 1 the fit diverges
# by epoch 3 and the two runs part by orders). Both in float64 but for the
# per-sample losses, which both sides round to float32: the JAX block
# program carries its best val in float32 and cannot take a float64 one.
# Epoch 1 then agrees to 2e-8 (the trunk's float32 output, as
# tests/test_torch_parallel_dp.py's step); later epochs part by the two
# frameworks' float64 steps (2e-5 apart on a gradient there) carried through
# the max over neighbours. Readings at lr 1e-2: 1.5e-4 relative on the train
# loss and 4.0e-4 on the val loss (a sweep with lr 1e-1 read up to 1.8e-4
# and 4.4e-4); on a weight at most 1.8e-3, and per leaf at most 0.23 of the
# X. A fit that
# stopped one step short (the JAX fit at 2 epochs) lies from the JAX 3-epoch
# weights up to 1.4e-2 on a weight, and on every leaf 0.28 to 0.80 of the
# update; one at 1 epoch 2.4e-2, and 0.49 to 1.08. The bounds lie between:
# such fits fail both.
# The biases before a BatchNorm get no gradient (updates below 1e-15) and
# are held by WEIGHT_ATOL alone.
JAX_CFG = {**{k: v for k, v in R.JAX_STEP_CFG.items() if k != "host_resident"},
           "epochs": 3, "lr": 1e-2}
FIRST_EPOCH_RTOL, HISTORY_RTOL, WEIGHT_ATOL, UPDATE_RTOL = 1e-7, 2e-3, 5e-3, 0.4


def test_block_fit_against_the_jax_default_fit(monkeypatch):
    """History, best-val epoch, final weights and statistics at the bounds
    above, each weight leaf also within UPDATE_RTOL of the three steps'
    update; ``timings`` with the JAX block path's keys, ``eval_seconds``
    0 on both."""
    monkeypatch.setenv("PCOT_EPOCH_BLOCK", "2")
    v = random_flax_variables(R.JAX_STEP_WEIGHTS)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    ja, pa = jax_tasks.TASKS["8dir_kl"], port_tasks.TASKS["8dir_kl"]
    monkeypatch.setitem(jax_tasks.TASKS, "8dir_kl", dataclasses.replace(
        ja, loss=lambda o, b, c: ja.loss(o, b, c).astype(jnp.float32)))
    monkeypatch.setitem(port_tasks.TASKS, "8dir_kl", dataclasses.replace(
        pa, loss=lambda o, b, c: pa.loss(o, b, c).float()))
    monkeypatch.setitem(jax_models.MODEL_REGISTRY, "pointnet_pp_8dir", _NoDrop8Dir)
    real = JaxTrainer._init_state

    def init(self):
        state = real(self)
        params, stats = (jax.tree_util.tree_map(jnp.asarray, v64[k])
                         for k in ("params", "batch_stats"))
        return state.replace(params=params, batch_stats=stats, opt_state=self.tx.init(params))

    monkeypatch.setattr(JaxTrainer, "_init_state", init)
    with jax.enable_x64(True):
        jt = JaxTrainer(jax_preset("8dir_kl").replace(**JAX_CFG), R.jax_step_dataset(jax_data))
        jt.fit(log_every=0)
        want = jax.tree_util.tree_map(np.asarray, (jt.state.params, jt.state.batch_stats))

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            TR, "flax_dense_init_", lambda model, generator: load_flax_variables(model, v)))
        for name in ("sa_group", "sa_group_scatter", "sa_mlp_max"):  # any float dtype
            stack.enter_context(mock.patch.object(K, name, getattr(K, f"{name}_plain")))
        t = Trainer(preset("8dir_kl", **JAX_CFG), R.jax_step_dataset(data), device="cpu",
                    sampling="first", p_drop=0.0)
        t.model.double()
        t.model.trunk.register_forward_hook(lambda module, args, out: out.float().double())
        build = t.build_batch
        t.build_batch = lambda *a, **k: {n: x.double() if x.is_floating_point() else x
                                         for n, x in build(*a, **k).items()}
        with mock.patch.object(t, "_fit_blocks", wraps=t._fit_blocks) as blocks:
            t.fit(log_every=0)
    assert blocks.call_count == 1 and t.step == int(jt.state.step) == 3
    for k in ("train", "val"):
        assert t.history[k][0] == pytest.approx(jt.history[k][0], rel=FIRST_EPOCH_RTOL)
        np.testing.assert_allclose(t.history[k], jt.history[k], rtol=HISTORY_RTOL)
    assert t.best_val_epoch == jt.best_val_epoch == 1  # epoch 3 beats 2, not 1
    assert t.best_val == pytest.approx(jt.best_val, rel=FIRST_EPOCH_RTOL)
    got = to_flax_variables(t.model)
    for tree, ref in ((got["params"], want[0]), (got["batch_stats"], want[1])):
        have_l = jax.tree_util.tree_leaves_with_path(tree)
        want_l = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in have_l] == [p for p, _ in want_l]
        for (path, h), (_, w) in zip(have_l, want_l):
            np.testing.assert_allclose(np.asarray(h, np.float64), w, atol=WEIGHT_ATOL,
                                       err_msg=str(path))
    start = jax.tree_util.tree_leaves_with_path(v64["params"])
    for (path, h), (_, w), (_, w0) in zip(jax.tree_util.tree_leaves_with_path(got["params"]),
                                          jax.tree_util.tree_leaves_with_path(want[0]), start):
        update = np.abs(w - w0).max()
        if update > 1e-12:
            gap = np.abs(np.asarray(h, np.float64) - w).max()
            assert gap <= UPDATE_RTOL * update, (path, gap, update)
    assert set(t.timings) == set(jt.timings) == {"train_clouds_per_sec", "train_seconds",
                                                 "eval_seconds"}
    assert t.timings["eval_seconds"] == jt.timings["eval_seconds"] == 0.0
    assert t.timings["train_seconds"] > 0.0
    assert t.timings["train_clouds_per_sec"] == pytest.approx(
        len(t.train_ds) / t.timings["train_seconds"])
