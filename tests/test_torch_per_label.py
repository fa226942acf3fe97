"""The port's per-label protocol (``train/run.py`` ``run_per_label``) on the
CPU: one model per category into ``out/<label>``, ``summary.txt`` rewritten
after each label in label order, ``resume`` skipping a finished label, each
label's run independent of the ones before it, and the CLI's per-label
presets; the finished-run check against the JAX package's."""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.train import run as jax_run
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import preset
from pointcloud_orientation_tpu_torch.train import run as R

B, N = 4, 256
LABELS = ["chair", "sofa"]


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


def _cfg(tmp_path, **kw):
    return preset("axes_all_labels", epochs=1, batch_size=B, num_points=N,
                  axes_gram_schmidt=True, out_dir=str(tmp_path), **kw)


def _dataset():
    return OrientationDataset.synthetic(samples_per_class=8, num_points=N, class_names=LABELS)


def _summary(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def test_run_per_label_trains_each_label_and_writes_the_summary(tmp_path):
    """Two labels, 1 epoch: a directory each with its ``metrics.json`` (a
    one-label config, a full history and a test block) and ``summary.txt``;
    the top ``summary.txt`` has one line a label in label order, each its
    run's best val loss to 6 places, rewritten after each label (read from
    the write after the first label); the JAX package's
    ``_completed_best_val`` reads the same value from the port's files."""
    out = str(tmp_path / "out")
    writes = []
    real = R.write_summary_txt

    def recording(path, summary, overall=None):
        writes.append(dict(summary))
        real(path, summary, overall)

    with mock.patch.object(R, "write_summary_txt", recording):
        summary = R.run_per_label(_cfg(tmp_path), _dataset(), out, "cpu")
    assert list(summary) == LABELS
    assert [list(w) for w in writes] == [LABELS[:1], LABELS]
    assert sorted(os.listdir(out)) == sorted(LABELS + ["summary.txt"])
    rows = _summary(os.path.join(out, "summary.txt"))
    assert [r[0] for r in rows] == LABELS
    for label, value in rows:
        d = os.path.join(out, label)
        assert os.path.exists(os.path.join(d, "summary.txt"))
        with open(os.path.join(d, "metrics.json")) as f:
            m = json.load(f)
        assert m["config"]["classes"] == [label] and m["config"]["per_label"] is False
        assert len(m["history"]["val"]) == 1 and "test" in m
        assert value == f"{m['best_val']:.6f}" and summary[label] == m["best_val"]
        assert jax_run._completed_best_val(d, 1) == R._completed_best_val(d, 1) == m["best_val"]
        assert R._completed_best_val(d, 2) is None  # another epoch budget: not finished


def test_resume_skips_a_finished_label_and_runs_are_independent(tmp_path):
    """With ``resume=True`` a label whose ``metrics.json`` records a finished
    run at this budget is not trained again (its best val read back, its
    files untouched) and an unfinished one is; without it every label
    trains. The second label's run equals a run of that label alone: a fresh
    Trainer seeded from the config, whatever ran before."""
    out = str(tmp_path / "out")
    ds, cfg = _dataset(), _cfg(tmp_path)
    first = R.run_per_label(cfg, ds, out, "cpu")
    os.remove(os.path.join(out, LABELS[1], "metrics.json"))  # the second label unfinished
    stamp = os.stat(os.path.join(out, LABELS[0], "metrics.json")).st_mtime_ns
    trained = []
    real = R.run_single

    def recording(cfg, dataset, out_dir, *a, **kw):
        trained.append(kw["label"])
        return real(cfg, dataset, out_dir, *a, **kw)

    with mock.patch.object(R, "run_single", recording):
        again = R.run_per_label(cfg, ds, out, "cpu", resume=True)
    assert trained == [LABELS[1]]
    assert os.stat(os.path.join(out, LABELS[0], "metrics.json")).st_mtime_ns == stamp
    assert again == first  # the retrained label reproduces its first run
    assert [r[0] for r in _summary(os.path.join(out, "summary.txt"))] == LABELS

    trained.clear()
    with mock.patch.object(R, "run_single", recording):
        R.run_per_label(cfg, ds, out, "cpu", resume=True)
    assert trained == []
    with mock.patch.object(R, "run_single", recording):
        R.run_per_label(cfg, ds, out, "cpu")
    assert trained == LABELS

    alone, _ = R.run_single(cfg.replace(classes=(LABELS[1],), per_label=False),
                            ds.select_classes([LABELS[1]]), str(tmp_path / "alone"), "cpu")
    assert alone.best_val == first[LABELS[1]]
    with open(os.path.join(out, LABELS[1], "metrics.json")) as f:
        assert json.load(f)["history"] == json.loads(json.dumps(alone.history))


@pytest.mark.parametrize("name", ["axes_all_labels", "8dir"])
def test_cli_trains_the_per_label_presets(tmp_path, name, capsys):
    """``run --preset axes_all_labels`` (``--classes`` toilet,bowl) and
    ``--preset 8dir`` (chair, the preset's one label) on the CPU at B=4,
    N=256, 1 epoch: a directory and a summary line a label in that order,
    each loss finite."""
    out = tmp_path / name
    want = ["chair"] if name == "8dir" else ["toilet", "bowl"]
    R.main(["--preset", name, "--epochs", "1", "--num-points", str(N), "--batch-size", str(B),
            "--device", "cpu", "--out", str(out)]
           + ([] if name == "8dir" else ["--classes", ",".join(want)]))
    rows = _summary(out / "summary.txt")
    assert [r[0] for r in rows] == want
    assert all(np.isfinite(float(v)) for _, v in rows)
    assert all((out / label / "metrics.json").exists() for label in want)
    assert "done in" in capsys.readouterr().out
