"""The port's run artifacts that need matplotlib or the profiler, on the CPU:
``plot_loss_curves`` byte for byte the JAX package's PNG on the same
curves; ``write_artifacts``'s ``loss_curve.png``, and the one line it
prints where matplotlib does not import (the card's machine); the polar
density of ``viz/polar.py`` against the JAX ``_density`` and its PNGs
(``batch_plot_mvm`` over sidecar files, an MvM run's
``figs/pred_density_<i>.png``); ``StepTimer``; ``capture_trace`` and the
CLI's ``--profile-dir``."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.train.metrics import plot_loss_curves as jax_plot_loss_curves
from pointcloud_orientation_tpu.viz import polar as jax_polar
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.data.sidecar import write_multi_peak_vm_txt
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import run as R
from pointcloud_orientation_tpu_torch.train.metrics import plot_loss_curves
from pointcloud_orientation_tpu_torch.utils.profiling import StepTimer, capture_trace
from pointcloud_orientation_tpu_torch.viz import polar

N = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_loss_curve_png_equals_the_jax_one(tmp_path):
    train, val = [2.3, 2.1, 1.95, 1.9], [2.4, 2.2, 2.15, 2.2]
    plot_loss_curves(train, val, str(tmp_path / "a" / "port.png"), title="8dir_kl loss")
    jax_plot_loss_curves(train, val, str(tmp_path / "jax.png"), title="8dir_kl loss")
    assert (tmp_path / "a" / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def _trainer(**kw):
    return Trainer(preset("simple_pointnet", num_points=N, batch_size=4, epochs=2, **kw),
                   OrientationDataset.synthetic(samples_per_class=8, num_points=N,
                                                class_names=["chair"]), device="cpu")


def test_write_artifacts_draws_the_loss_curve_or_says_it_did_not(tmp_path, monkeypatch, capsys):
    t = _trainer()
    t.fit(log_every=0)
    t.write_artifacts(str(tmp_path / "with"))
    png = (tmp_path / "with" / "loss_curve.png").read_bytes()
    plot_loss_curves(t.history["train"], t.history["val"], str(tmp_path / "same.png"),
                     title="forward_mse loss")
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png == (tmp_path / "same.png").read_bytes()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now fails
    capsys.readouterr()
    t.write_artifacts(str(tmp_path / "without"))
    out = capsys.readouterr().out
    assert out.startswith("loss_curve.png not written:") and out.count("\n") == 1
    assert sorted(os.listdir(tmp_path / "without")) == ["metrics.json", "summary.txt"]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_polar_density_matches_jax(rng, k):
    """The normalised mixture density on the 720-point grid, components with
    kappa from near 0 to 80, to 1e-5 relative and 1e-6 absolute (float32
    densities, as in ``tests/test_torch_tta.py``)."""
    theta = np.linspace(-math.pi, math.pi, 720)
    mu = rng.uniform(-np.pi, np.pi, size=k).astype(np.float32)
    kappa = np.concatenate([[0.01, 80.0], rng.uniform(0, 40, size=2)])[:k].astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    got = polar._density(theta, mu, kappa, w)
    want = jax_polar._density(theta, mu, kappa, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(np.trapezoid(got, theta) - 1.0) < 1e-6


def test_polar_plots_of_sidecars_and_of_an_mvm_run(tmp_path):
    gt = tmp_path / "gt" / "chair"
    os.makedirs(gt)
    for i, k in enumerate((1, 3)):
        params = np.asarray([[0.3 * j, 4.0 + j, 1.0 / k] for j in range(k)], np.float32)
        write_multi_peak_vm_txt(params, k, str(gt / f"c{i}_multi_peak_vM_gt.txt"))
    assert polar.batch_plot_mvm("chair", str(tmp_path / "gt"), str(tmp_path / "png")) == 2
    assert sorted(os.listdir(tmp_path / "png" / "chair")) == [
        "c0_multi_peak_vM_gt.png", "c1_multi_peak_vM_gt.png"]
    cfg = preset("mvm", num_points=N, batch_size=4, epochs=1, classes=("chair", "bowl"))
    ds = OrientationDataset.synthetic(samples_per_class=5, num_points=N,
                                      class_names=["chair", "bowl"])
    R.run_single(cfg, ds, str(tmp_path / "run"), "cpu")
    figs = sorted(os.listdir(tmp_path / "run" / "figs"))
    assert figs == [f"pred_density_{i}.png" for i in range(min(4, 2))]
    assert {"loss_curve.png", "results.txt", "metrics.json"} <= set(os.listdir(tmp_path / "run"))


def test_step_timer_and_capture_trace(tmp_path):
    timer = StepTimer()
    for _ in range(3):
        with timer.track("step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.track("data"):
        pass
    avg = timer.averages()
    assert set(avg) == {"step", "data"} and timer.counts["step"] == 3 and avg["step"] >= 0
    timer.reset()
    assert not timer.averages()
    with capture_trace(str(tmp_path / "prof")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_cli_profile_dir_and_debug_checks(tmp_path, monkeypatch):
    monkeypatch.setattr(R, "load_dataset", lambda spec, num_points, classes=None:
                        OrientationDataset.synthetic(samples_per_class=8, num_points=N,
                                                     class_names=list(classes)))
    R.main(["--preset", "simple_pointnet", "--epochs", "1", "--num-points", str(N),
            "--batch-size", "4", "--device", "cpu", "--out", str(tmp_path / "out"),
            "--profile-dir", str(tmp_path / "prof"), "--debug-checks", "--host-resident"])
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    m = json.loads((tmp_path / "out" / "metrics.json").read_text())
    assert m["config"]["debug_checks"] and m["config"]["host_resident"]
    assert os.path.exists(tmp_path / "out" / "debug_log.txt")
