"""The port, chip_smoke.py and chip_sweep.py run where JAX is absent (the
port's modules, the selection micro-benchmarks among them, import; serving the 8-dir,
classifier, vM and MvM models, one train step in each train configuration
and one of the MvM task, the training CLI), and chip_smoke.py refuses to
run without a card."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A process in which jax, flax, optax, orbax, h5py, matplotlib, the JAX
# package and the root benchmarks folder (the JAX package's micro-benchmarks)
# cannot be imported, as on the card's machine.
_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "h5py", "matplotlib",
               "pointcloud_orientation_tpu", "benchmarks"}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked: the port must not need it")
            return None

    sys.meta_path.insert(0, Blocker())
""")


def _run(code: str, cwd: str = REPO, timeout: float = 300, args=()) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_and_serve_without_jax(tmp_path):
    code = _BLOCKER + textwrap.dedent("""
        import importlib, pkgutil
        import numpy as np
        import pointcloud_orientation_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert "pointcloud_orientation_tpu_torch.benchmarks.profile_vpu_select" in names
        import chip_smoke  # noqa: F401
        import chip_sweep  # noqa: F401
        for name in ("jax", "flax", "pointcloud_orientation_tpu", "benchmarks"):
            assert name not in sys.modules, name
        v = port.random_flax_variables(0)
        p = port.OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                      num_points=128, max_batch=2, device="cpu")
        out = p(np.random.default_rng(0).normal(size=(3, 100, 3)).astype(np.float32))
        assert out.shape == (3, 8) and np.isfinite(out).all()
        v = port.random_flax_variables(0, "pointnet_pp_cls", in_channels=6)
        p = port.OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                      num_points=128, max_batch=2, device="cpu")
        out = p(np.random.default_rng(0).normal(size=(3, 100, 6)).astype(np.float32))
        assert out.shape == (3, 40) and np.isfinite(out).all()
        # one CPU train step in each train configuration, and the CLI
        from pointcloud_orientation_tpu_torch.data import OrientationDataset
        from pointcloud_orientation_tpu_torch.train import Trainer, preset
        from pointcloud_orientation_tpu_torch.train.run import main
        ds = OrientationDataset.synthetic(samples_per_class=2, num_points=160)
        for fused in (False, True):
            t = Trainer(preset("8dir_kl", batch_size=4, num_points=160), ds, device="cpu",
                        fused_mlp_train=fused)
            idx, valid, _ = next(ds.batches(4))
            batch, valid, _ = t.device_batch(ds, idx, valid, t.generator(0, 1, 0))
            loss = float(t.train_step(batch, valid, t.generator(0, 1, 0))["loss"])
            assert np.isfinite(loss), loss
        # the distribution heads: served, and one CPU step of the MvM task
        for name, kw in (("pointnet_pp_von_mises", {"mu_parameterization": "atan2"}),
                         ("pointnet_pp_mvm", {"mu_init": "spread"})):
            v = port.random_flax_variables(0, name, **kw)
            p = port.OrientationPredictor(name, v["params"], v["batch_stats"], num_points=128,
                                          max_batch=2, device="cpu")
            out = p(np.random.default_rng(0).normal(size=(3, 100, 3)).astype(np.float32))
            assert isinstance(out, tuple) and all(o.shape[0] == 3 for o in out)
        t = Trainer(preset("mvm_robust", batch_size=4, num_points=160), ds, device="cpu")
        batch, valid, _ = t.device_batch(ds, idx, valid.cpu().numpy(), t.generator(0, 1, 0))
        assert np.isfinite(float(t.train_step(batch, valid, t.generator(0, 1, 0))["loss"]))
        main(["--preset", "8dir_kl", "--epochs", "1", "--num-points", "128",
              "--batch-size", "16", "--device", "cpu", "--out", sys.argv[1]])
        print("IMPORTED", len(names))
    """)
    r = _run(code, args=(str(tmp_path / "run"),))
    assert r.returncode == 0, r.stderr
    assert "IMPORTED" in r.stdout
    assert (tmp_path / "run" / "summary.txt").read_text().splitlines()[-1].startswith("Overall")
    # the blocker itself works: the JAX package and its benchmarks cannot come in
    for module in ("pointcloud_orientation_tpu.ops.dirs8", "benchmarks.profile_vpu_select"):
        r = _run(_BLOCKER + f"import {module}")
        assert r.returncode != 0 and "blocked" in r.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the rest of the repo, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
