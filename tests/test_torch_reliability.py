"""Preemption and asynchronous checkpoints of the port's Trainer on the
CPU: ``PreemptionGuard`` by a real signal (one-shot, handlers restored, a
guard outside the main thread), a run preempted after epoch 2 and resumed
from the checkpoint its writer thread wrote bit-equal to the uninterrupted
run, an asynchronous checkpoint byte for byte the synchronous one. The
guard against the JAX package's on the same signals."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.train.reliability import PreemptionGuard as JaxGuard
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train.reliability import PreemptionGuard

B, N = 4, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_per_label.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(**kw):
    cfg = preset("8dir_kl", batch_size=B, num_points=N, epochs=4, **kw)
    return Trainer(cfg, OrientationDataset.synthetic(samples_per_class=3, num_points=N),
                   device="cpu")


def _state(trainer):
    """Weights, statistics, optimizer state and step, for exact comparison."""
    opt = trainer.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()}, trainer.step)


def _assert_same(a, b):
    (ma, oa, sa), (mb, ob, sb) = a, b
    assert sa == sb and ma.keys() == mb.keys() and oa.keys() == ob.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JaxGuard], ids=["port", "jax"])
def test_guard_turns_the_first_sigterm_into_a_flag(guard_cls):
    """Inside the guard the first SIGTERM sets ``requested`` and ``signum``
    and puts the previous handler back (one-shot); leaving the guard
    restores the handler it found; ``request()`` sets the flag from code.
    Both packages' guards behave the same."""
    hits = []
    previous = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        before = signal.getsignal(signal.SIGTERM)
        with guard_cls() as guard:
            assert not guard.requested and signal.getsignal(signal.SIGTERM) != before
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested and guard.signum == signal.SIGTERM and hits == []
            assert signal.getsignal(signal.SIGTERM) == before  # the second reaches it
            os.kill(os.getpid(), signal.SIGTERM)
            assert hits == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) == before
        with guard_cls(signals=(signal.SIGUSR1,)) as guard:
            guard.request()
            assert guard.requested and guard.signum is None
        assert signal.getsignal(signal.SIGTERM) == before
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_guard_outside_the_main_thread_works_by_request():
    """Handlers install only in the main thread: elsewhere the guard enters
    without error, leaves the handlers alone and works through
    ``request()``."""
    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def body():
        with PreemptionGuard() as guard:
            seen["installed"] = bool(guard._previous)
            guard.request()
            seen["requested"] = guard.requested

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == {"installed": False, "requested": True}
    assert signal.getsignal(signal.SIGTERM) == before


class _FireAfter:
    """A guard whose flag rises once ``trainer`` has finished ``epoch``."""

    def __init__(self, trainer, epoch):
        self.trainer, self.epoch = trainer, epoch

    @property
    def requested(self):
        return self.trainer.epoch >= self.epoch


def test_preempted_run_resumes_bit_equal_from_its_async_checkpoint(tmp_path, capsys,
                                                                   monkeypatch):
    """``checkpoint_every=1`` with asynchronous writes; the guard fires after
    epoch 2: the run stops there with two epochs of history. ``epoch_1.pt``
    was written by the writer thread alone; ``epoch_2.pt`` by it and then
    again in the caller's thread by the preemption save, after the drain
    (as the JAX ``fit`` does). Each file is byte for byte the one the
    uninterrupted run's synchronous save wrote after that epoch. A fresh
    trainer restored from the writer thread's ``epoch_1.pt`` trains on to
    epoch 4: its history, weights, statistics and optimizer state equal
    the uninterrupted run's, bit for bit (the CPU plain versions, like the
    card kernels on this path, sum in a fixed order)."""
    from pointcloud_orientation_tpu_torch.train import trainer as TR

    full_dir = str(tmp_path / "full")
    full = _trainer(checkpoint_every=1)
    full.fit(log_every=0, checkpoint_dir=full_dir)

    writes = []
    write = TR.write_torch_file

    def recording(payload, path):
        writes.append((os.path.basename(path), threading.current_thread().name))
        write(payload, path)

    monkeypatch.setattr(TR, "write_torch_file", recording)
    ckpt = str(tmp_path / "ckpt")
    run = _trainer(checkpoint_every=1, async_checkpoint=True)
    hist = run.fit(log_every=0, checkpoint_dir=ckpt, preemption_guard=_FireAfter(run, 2))
    assert "[preempt] graceful stop after epoch 2" in capsys.readouterr().out
    assert len(hist["train"]) == 2 and run.epoch == 2 and not run._ckpt_pending
    assert sorted(os.listdir(ckpt)) == ["epoch_1.pt", "epoch_2.pt"]
    assert [(f, name.startswith("checkpoint")) for f, name in writes] == [
        ("epoch_1.pt", True), ("epoch_2.pt", True), ("epoch_2.pt", False)]
    for e in (1, 2):
        with open(os.path.join(ckpt, f"epoch_{e}.pt"), "rb") as a, \
                open(os.path.join(full_dir, f"epoch_{e}.pt"), "rb") as b:
            assert a.read() == b.read(), e

    resumed = _trainer(checkpoint_every=1, async_checkpoint=True)
    assert resumed.restore_checkpoint(os.path.join(ckpt, "epoch_1.pt")) == 1
    resumed.fit(start_epoch=2, log_every=0, checkpoint_dir=ckpt)
    assert resumed.history == full.history
    np.testing.assert_equal(resumed.class_history, full.class_history)  # NaN: a class with no val
    assert resumed.best_val == full.best_val and resumed.best_val_epoch == full.best_val_epoch
    _assert_same(_state(resumed), _state(full))
    for k in full.best_state:
        assert torch.equal(resumed.best_state[k].cpu(), full.best_state[k]), k
    assert sorted(os.listdir(ckpt)) == [f"epoch_{e}.pt" for e in range(1, 5)]


def test_guard_without_checkpoint_dir_returns_early(monkeypatch):
    """The block path polls the guard at block ends: blocks of one epoch
    stop after epoch 1 (as tests/test_reliability.py sets the block for
    JAX)."""
    monkeypatch.setenv("PCOT_EPOCH_BLOCK", "1")
    t = _trainer()
    hist = t.fit(log_every=0, preemption_guard=_FireAfter(t, 1))
    assert len(hist["val"]) == 1 and t.epoch == 1


def test_async_checkpoint_bytes_equal_the_synchronous_ones(tmp_path):
    """After an epoch: the same state saved synchronously and asynchronously
    (then waited for) gives identical files; training on after an
    asynchronous save does not reach the file (the state was copied to host
    memory before ``save_checkpoint`` returned)."""
    t = _trainer()
    t.fit(epochs=1, log_every=0)
    sync = t.save_checkpoint(str(tmp_path / "sync"))
    path = t.save_checkpoint(str(tmp_path / "async"), asynchronous=True)
    t.run_epoch(2)  # moves every weight while the write may be in flight
    t.wait_for_checkpoints()
    with open(sync, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    other = _trainer()
    assert other.restore_checkpoint(path) == 1 and other.step == t.step - 3
    assert not os.path.exists(path + ".tmp")


def test_async_write_errors_surface_at_the_wait(tmp_path, monkeypatch):
    from pointcloud_orientation_tpu_torch.train import trainer as TR

    def boom(payload, path):
        raise OSError("disk full")

    t = _trainer()
    monkeypatch.setattr(TR, "write_torch_file", boom)
    t.save_checkpoint(str(tmp_path), asynchronous=True)
    with pytest.raises(OSError, match="disk full"):
        t.wait_for_checkpoints()
