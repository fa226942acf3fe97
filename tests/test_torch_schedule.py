"""The port's optimizers and learning-rate schedule against the JAX package's:
the per-step learning rate of a cosine run with warmup against the JAX
``Trainer.lr_schedule``, SGD and Adam updates on the same numpy gradients
against optax's chain, a resumed run's place in the schedule, and the JAX
``ValueError``\\ s. The ``simple_pointnet`` preset (no kernel) at 64 points
keeps the trainers cheap."""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_orientation_tpu.data import OrientationDataset as JaxDataset
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import preset as jax_preset
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train.trainer import (
    clip_by_global_norm_,
    lr_schedule_for,
    make_optimizer,
    warmup_cosine_decay_schedule,
)

N, B = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops (see
    tests/test_torch_per_label.py); restored for the files that follow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return dict(num_points=N, batch_size=B, epochs=4, lr_schedule="cosine", warmup_epochs=1, **kw)


def cfg_lr() -> float:
    return preset("simple_pointnet").lr


def _dataset(cls=OrientationDataset):
    return cls.synthetic(samples_per_class=24, num_points=N, class_names=["chair"])


def _lrs(trainer, epochs, start=1):
    """The learning rate each train step of ``epochs`` used, read from the
    optimizer after the step."""
    seen = []
    real = trainer.optimizer.step

    def step(*a, **k):
        seen.append(trainer.optimizer.param_groups[0]["lr"])
        return real(*a, **k)

    trainer.optimizer.step = step
    trainer.fit(epochs=epochs, start_epoch=start, log_every=0)
    return seen


LR_ATOL = 1e-7  # of the peak rate: the float32 resolution of the JAX schedule's value


def test_per_step_lr_equals_the_jax_trainer_schedule():
    """A cosine run with one warmup epoch (24 clouds, 16 in train: 4 steps an
    epoch, 16 in all): every step's learning rate equals the JAX
    ``Trainer.lr_schedule`` at the update count before the step, from 0 at
    the first step through the peak towards 0 at the end, within 1e-7 of
    the peak rate. JAX evaluates the schedule in float32, where
    ``0.5 * (1 + cos)`` carries about an ulp of 1 (6e-8) of absolute
    rounding; the port evaluates it in float64. Near the end that rounding
    is a large part of JAX's own small value (1.3e-6 relative at the last
    step here), so the bound is on the peak's scale."""
    cfg = _cfg()
    jax_trainer = JaxTrainer(jax_preset("simple_pointnet").replace(**cfg), _dataset(JaxDataset))
    port = Trainer(preset("simple_pointnet", **cfg), _dataset(), device="cpu")
    got = _lrs(port, 4)
    assert len(got) == 16 and port.step == 16
    want = [float(jax_trainer.lr_schedule(t)) for t in range(16)]
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_ATOL * cfg_lr())
    assert got[0] == 0.0 and max(got) == pytest.approx(1e-3) and got[4] == pytest.approx(1e-3)
    for t in range(20):  # past the horizon the schedule stays at its end value
        sched = port.lr_schedule(t)
        assert abs(sched - float(jax_trainer.lr_schedule(t))) <= LR_ATOL * cfg_lr()


@pytest.mark.parametrize("warmup, epochs, spe", [(0, 3, 5), (2, 5, 3), (1, 2, 1), (3, 7, 4)])
def test_schedule_function_equals_optax(warmup, epochs, spe):
    """:func:`lr_schedule_for` against ``optax.warmup_cosine_decay_schedule``
    built as the JAX trainer builds it, over every step and past the end,
    within 1e-7 of the peak rate (optax's float32 evaluation)."""
    lr = 3e-3
    cfg = preset("8dir_kl", lr=lr, epochs=epochs, lr_schedule="cosine", warmup_epochs=warmup)
    got = lr_schedule_for(cfg, spe)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else lr, peak_value=lr, warmup_steps=spe * warmup,
        decay_steps=spe * epochs)
    for t in range(spe * epochs + 3):
        assert abs(got(t) - float(want(jnp.int32(t)))) <= LR_ATOL * lr, t
    assert lr_schedule_for(preset("8dir_kl"), spe) is None


@pytest.mark.parametrize("optimizer, scheduled, clip",
                         [("sgd", False, None), ("sgd", True, 1.0), ("adam", True, None),
                          ("adam", False, 1.0)])
def test_updates_match_optax_on_the_same_gradients(rng, optimizer, scheduled, clip):
    """Four updates on the same numpy gradients: the port's optimizer (its
    rate set from the schedule at the count before each step, after the
    global-norm clip) against the JAX trainer's optax chain, to 1e-6 (the
    rate and the bound of ``test_adam_and_clip_match_optax_on_the_same_gradients``)."""
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 3 for s in shapes] for _ in range(4)]
    lr = 1e-3
    cfg = preset("8dir_kl", lr=lr, epochs=2, optimizer=optimizer,
                 lr_schedule="cosine" if scheduled else None, warmup_epochs=1 if scheduled else 0)
    schedule = lr_schedule_for(cfg, 2)
    rate = (optax.warmup_cosine_decay_schedule(0.0, lr, 2, 4) if scheduled else lr)
    parts = ([optax.clip_by_global_norm(clip)] if clip else [])
    parts.append(optax.sgd(rate) if optimizer == "sgd" else optax.adam(rate))
    tx = optax.chain(*parts)
    p_jax = [jnp.asarray(p) for p in params]
    state = tx.init(p_jax)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(cfg, tp, schedule(0) if schedule else lr)
    assert isinstance(opt, torch.optim.SGD if optimizer == "sgd" else torch.optim.Adam)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        if clip:
            clip_by_global_norm_(tp, clip)
        if schedule:
            for group in opt.param_groups:
                group["lr"] = schedule(step)
        opt.step()
        for a, b in zip(tp, p_jax):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    if optimizer == "sgd":
        assert opt.defaults["momentum"] == 0 and opt.defaults["weight_decay"] == 0


def test_resumed_run_keeps_its_place_in_the_schedule(tmp_path):
    """SGD on the cosine schedule: two epochs, a checkpoint, a fresh trainer
    restored from it for epochs 3-4; its learning rates, history and weights
    equal the uninterrupted run's, bit for bit."""
    cfg = preset("simple_pointnet", **_cfg(optimizer="sgd"))
    full = Trainer(cfg, _dataset(), device="cpu")
    lrs_full = _lrs(full, 4)
    first = Trainer(cfg, _dataset(), device="cpu")
    first.fit(epochs=2, log_every=0)
    path = first.save_checkpoint(str(tmp_path))
    resumed = Trainer(cfg, _dataset(), device="cpu")
    assert resumed.restore_checkpoint(path) == 2 and resumed.step == 8
    assert _lrs(resumed, 4, start=3) == lrs_full[8:]
    assert resumed.history == full.history
    for (k, a), b in zip(resumed.model.state_dict().items(), full.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_unknown_optimizer_schedule_and_too_long_warmup_raise_as_in_jax():
    """``ValueError`` where the JAX trainer raises one: an unknown optimizer
    or schedule, and a warmup that leaves no decay step (optax's)."""
    ds, jds = _dataset(), _dataset(JaxDataset)
    for kw in ({"optimizer": "rmsprop"}, {"lr_schedule": "step"},
               {"lr_schedule": "cosine", "warmup_epochs": 4, "epochs": 4}):
        cfg = dict(num_points=N, batch_size=B, **kw)
        with pytest.raises(ValueError):
            Trainer(preset("simple_pointnet", **cfg), ds, device="cpu")
        with pytest.raises(ValueError):
            JaxTrainer(jax_preset("simple_pointnet").replace(**cfg), jds)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)


def test_ported_fields_are_accepted_and_the_rest_still_refused():
    """The lifted fields take their JAX values (``keep_best`` changes
    nothing; ``host_resident``'s step path gives the resident blocks'
    history), the MoE fields among them, with the
    JAX config's defaults; ``bn_sync_axis`` is a field of both configs and
    the port's Trainer refuses any value (its DP is global-batch already;
    the JAX Trainer fails on it)."""
    cfg = preset("8dir_kl", optimizer="sgd", lr_schedule="cosine", warmup_epochs=2,
                 async_checkpoint=True, host_resident=True, keep_best=False)
    assert (cfg.optimizer, cfg.lr_schedule, cfg.warmup_epochs, cfg.async_checkpoint,
            cfg.host_resident, cfg.keep_best) == ("sgd", "cosine", 2, True, True, False)
    moe = dict(moe_experts=8, moe_dispatch="capacity", moe_aux_weight=0.1,
               moe_capacity_factor=2.0)
    cfg, jcfg = preset("8dir_kl", **moe), jax_preset("8dir_kl").replace(**moe)
    assert {k: getattr(cfg, k) for k in moe} == {k: getattr(jcfg, k) for k in moe} == moe
    assert ({k: getattr(preset("8dir_kl"), k) for k in moe}
            == {k: getattr(jax_preset("8dir_kl"), k) for k in moe})
    cfg = preset("8dir_kl", bn_sync_axis="data")
    assert cfg.bn_sync_axis == jax_preset("8dir_kl").replace(bn_sync_axis="data").bn_sync_axis
    with pytest.raises(ValueError, match="global batch"):
        Trainer(cfg, _dataset(), device="cpu")
    host = Trainer(preset("simple_pointnet", num_points=N, batch_size=B, epochs=1,
                          host_resident=True, keep_best=False), _dataset(), device="cpu")
    plain = Trainer(preset("simple_pointnet", num_points=N, batch_size=B, epochs=1), _dataset(),
                    device="cpu")
    assert host.fit(log_every=0) == plain.fit(log_every=0)
    assert math.isfinite(host.best_val) and host.best_state is not None
