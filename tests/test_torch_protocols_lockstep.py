"""The port's lockstep protocols on the CPU, held to the port's own
sequential runs, exactly: each member of ``run_per_label_vmapped`` equal to
its own ``Trainer`` run, with unequal label subsets too (each member runs
its own epoch's steps, unpadded); a member's result independent of the
members beside it and of its slot; a protocol preempted after any epoch
resumed from its checkpoint equal to the uninterrupted run, its periodic
saves on ``checkpoint_every`` multiples; a preemption after the last epoch
completing the run; the CLI's
protocol flags and their errors. (The protocols against the JAX package's:
``tests/test_torch_protocols.py``.)"""

import json
import os

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import run as R
from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed

N, B = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_per_label.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unequal_ds():
    """Ten bottles and seven chairs: train splits of 7 and 4 clouds, 2 and 1
    steps at batch 4."""
    ds = OrientationDataset.synthetic(samples_per_class=10, num_points=N,
                                      class_names=["chair", "bottle"])
    keep = np.ones(len(ds), bool)
    keep[np.nonzero(ds.labels == ds.class_names.index("chair"))[0][:3]] = False
    return ds.subset(np.nonzero(keep)[0])


def _cfg(**kw):
    return preset("8dir_kl", num_points=N, batch_size=B, classes=("chair", "bottle"), **kw)


def _sequential(cfg, ds, label):
    t = Trainer(cfg.replace(classes=(label,), per_label=False), ds.select_classes([label]),
                device="cpu")
    t.fit(log_every=0)
    return t, t.test()


def test_members_equal_their_sequential_runs_with_unequal_subsets():
    """Two labels of unequal size (1 and 2 steps an epoch), two epochs,
    Adam: each member's history, best val and test loss equal its own
    sequential ``Trainer`` run exactly."""
    ds = _unequal_ds()
    cfg = _cfg(epochs=2)
    res = run_per_label_vmapped(cfg, ds, log_every=0, device="cpu")
    for label in ("chair", "bottle"):
        t, test = _sequential(cfg, ds, label)
        np.testing.assert_equal(res[label]["history"], t.history)  # NaN: bottles have no angle
        assert res[label]["best_val"] == t.best_val
        assert res[label]["best_val_epoch"] == t.best_val_epoch
        assert res[label]["test_loss"] == test.mean_loss
    assert {label: len(r["history"]["train"]) for label, r in res.items()} == {
        "chair": 2, "bottle": 2}


def test_member_results_do_not_depend_on_their_neighbours_or_slot():
    ds = _unequal_ds()
    cfg = _cfg(epochs=1)
    fwd = run_per_label_vmapped(cfg, ds, labels=["chair", "bottle"], log_every=0, device="cpu")
    rev = run_per_label_vmapped(cfg, ds, labels=["bottle", "chair"], log_every=0, device="cpu")
    dup = run_per_label_vmapped(cfg, ds, labels=["chair", "chair"], log_every=0, device="cpu")
    for other in (rev, dup):
        np.testing.assert_equal(other["chair"], fwd["chair"])
    np.testing.assert_equal(rev["bottle"], fwd["bottle"])
    seeds = run_multi_seed(cfg, ds, seeds=[3, 5], log_every=0, device="cpu")
    alone = run_multi_seed(cfg, ds, seeds=[5], log_every=0, device="cpu")
    np.testing.assert_equal(seeds[5], alone[5])
    assert seeds[3]["history"]["train"] != seeds[5]["history"]["train"]


class _FireOnPoll:
    """A guard whose flag reads True from its ``n``-th read on."""

    def __init__(self, n):
        self.n = n

    @property
    def requested(self):
        self.n -= 1
        return self.n <= 0


def _preempt_and_resume(tmp_path, protocol, fire_after):
    """Three epochs with ``checkpoint_every=2``: one periodic save, at 2
    (none at the last epoch). Preempted after epoch ``fire_after``, the run
    saves ``step_<fire_after>`` (``carry.pt`` and ``history.json`` with the
    JAX file's keys) and returns None; resumed from it, every member's
    results equal the uninterrupted run's exactly. A resume under other
    keys is refused."""
    ds = _unequal_ds()
    cfg = _cfg(epochs=3, checkpoint_every=2)

    def run(keys=None, **kw):
        if protocol == "per_label":
            return run_per_label_vmapped(cfg, ds, labels=keys, log_every=0, device="cpu", **kw)
        return run_multi_seed(cfg, ds, seeds=keys or [3, 4], log_every=0, device="cpu", **kw)

    full = run(checkpoint_dir=str(tmp_path / "full"))
    assert sorted(os.listdir(tmp_path / "full")) == ["step_2"]
    ckpt = str(tmp_path / "ckpt")
    assert run(checkpoint_dir=ckpt, preemption_guard=_FireOnPoll(fire_after)) is None
    step = os.path.join(ckpt, f"step_{fire_after}")
    assert sorted(os.listdir(ckpt)) == [f"step_{fire_after}"]
    assert sorted(os.listdir(step)) == ["carry.pt", "history.json"]
    with open(os.path.join(step, "history.json")) as f:
        hist = json.load(f)
    assert set(hist) == {"epoch", "keys", "history"} and hist["epoch"] == fire_after
    resumed = run(checkpoint_dir=ckpt, resume_from=step)
    np.testing.assert_equal(resumed, full)
    with pytest.raises(ValueError):
        run(keys=["bottle", "chair"] if protocol == "per_label" else [4, 3], resume_from=step)


@pytest.mark.parametrize("protocol", ["per_label", "multi_seed"])
def test_preempted_protocol_resumes_equal_to_the_uninterrupted_run(tmp_path, protocol):
    """Preempted after epoch 2, where the periodic save also falls
    (:func:`_preempt_and_resume`)."""
    _preempt_and_resume(tmp_path, protocol, 2)


@pytest.mark.parametrize("protocol", ["per_label", "multi_seed"])
def test_protocol_reads_the_guard_after_every_epoch(tmp_path, protocol):
    """Preempted after epoch 1, off the ``checkpoint_every`` grid: the guard
    is read after every epoch of every member, and the run saves and stops
    there (:func:`_preempt_and_resume`)."""
    _preempt_and_resume(tmp_path, protocol, 1)


def test_preemption_on_the_last_block_completes_the_run(tmp_path):
    res = run_multi_seed(_cfg(epochs=1), _unequal_ds(), seeds=[3], log_every=0, device="cpu",
                         checkpoint_dir=str(tmp_path), preemption_guard=_FireOnPoll(1))
    assert res is not None and os.listdir(tmp_path) == ["step_1"]


@pytest.fixture
def small_data(monkeypatch):
    """The CLI's ``synthetic`` data cut to 6 clouds a class (the flags are
    what these tests exercise)."""
    monkeypatch.setattr(R, "load_dataset", lambda spec, num_points, classes=None:
                        OrientationDataset.synthetic(samples_per_class=6, num_points=N,
                                                     class_names=list(classes)))


def _main(out, *flags, epochs=2):
    R.main(["--preset", "8dir_kl", "--epochs", str(epochs), "--num-points", str(N),
            "--batch-size", str(B), "--classes", "chair", "--device", "cpu", "--out", str(out),
            *flags])


def test_cli_seeds_checkpoint_and_resume(tmp_path, small_data):
    """``--seeds 1,2 --checkpoint-every 1`` writes each seed's metrics,
    ``seeds_summary.json`` and ``ckpt/step_1``; a run resumed from
    ``step_1`` ends with the same histories and test results."""
    _main(tmp_path / "a", "--seeds", "1,2", "--checkpoint-every", "1")
    assert {"seed_1", "seed_2", "seeds_summary.json", "ckpt"} <= set(os.listdir(tmp_path / "a"))
    assert os.listdir(tmp_path / "a" / "ckpt") == ["step_1"]
    _main(tmp_path / "b", "--seeds", "1,2", "--checkpoint-every", "1", "--resume-from",
          str(tmp_path / "a" / "ckpt" / "step_1"))
    for s in (1, 2):
        a, b = (json.loads((tmp_path / d / f"seed_{s}" / "metrics.json").read_text())
                for d in ("a", "b"))
        assert a["history"] == b["history"] and a["test"] == b["test"]


def test_cli_vmap_labels_schedule_and_flag_errors(tmp_path, small_data):
    """``--vmap-labels`` on a per-label preset trains its labels together
    (the summary and a directory a label); ``--lr-schedule`` reaches the
    config; ``--async-checkpoint`` with a protocol warns; ``--resume-from``
    without a protocol exits; ``--knn approx`` is not ported."""
    R.main(["--preset", "axes_all_labels", "--epochs", "1", "--num-points", str(N),
            "--batch-size", str(B), "--classes", "chair,sofa", "--device", "cpu", "--out",
            str(tmp_path / "v"), "--vmap-labels", "--lr-schedule", "cosine"])
    assert set(os.listdir(tmp_path / "v")) == {"chair", "sofa", "summary.txt"}
    m = json.loads((tmp_path / "v" / "chair" / "metrics.json").read_text())
    assert m["config"]["lr_schedule"] == "cosine" and m["vmapped_protocol"]["labels"] == 2
    with pytest.warns(UserWarning, match="async-checkpoint"):
        _main(tmp_path / "w", "--seeds", "3", "--async-checkpoint", epochs=1)
    with pytest.raises(SystemExit):
        _main(tmp_path / "x", "--resume-from", str(tmp_path))
    with pytest.raises(NotImplementedError):
        _main(tmp_path / "y", "--knn", "approx")
