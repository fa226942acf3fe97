"""The port, chip_smoke.py and chip_sweep.py run where JAX is absent (the
port's modules, the selection micro-benchmarks among them, import; serving the 8-dir,
classifier, vM and MvM models, one train step in each train configuration
and one of the MvM task, the training CLI; the point transformer served on
both attention backends and a flash train step), and chip_smoke.py refuses
to run without a card."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A process in which jax, flax, optax, orbax, tensorstore, zstandard,
# msgpack, h5py, matplotlib, the JAX package and the root benchmarks folder
# (the JAX package's micro-benchmarks) cannot be imported, as on the card's
# machine.
_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
               "msgpack", "h5py", "matplotlib", "pointcloud_orientation_tpu", "benchmarks"}

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
        # the JAX package's Orbax checkpoint (the committed fixture), read and served
        import glob
        ckpt = glob.glob("tests/data/orbax_transformer/step_*")[0]
        tree = port.utils.orbax_format.read_pytree(ckpt)
        assert tree["opt_state"][0][1] is None and tree["step"].dtype == np.int32
        p = port.OrientationPredictor.from_orbax_checkpoint(ckpt, "point_transformer",
                                                            num_points=128, device="cpu")
        assert p(np.zeros((2, 128, 3), np.float32)).shape == (2, 3)
        print("IMPORTED", len(names))
    """)
    r = _run(code, args=(str(tmp_path / "run"),))
    assert r.returncode == 0, r.stderr
    assert "IMPORTED" in r.stdout
    # the per-class rows and Overall, then the two mean 8-direction lines of run_single
    lines = (tmp_path / "run" / "summary.txt").read_text().splitlines()
    assert lines[-3].startswith("Overall")
    assert [ln.split("\t")[0] for ln in lines[-2:]] == ["mean_gt_8dir", "mean_pred_8dir"]
    # the blocker itself works: the JAX package and its benchmarks cannot come in
    for module in ("pointcloud_orientation_tpu.ops.dirs8", "benchmarks.profile_vpu_select"):
        r = _run(_BLOCKER + f"import {module}")
        assert r.returncode != 0 and "blocked" in r.stderr


def test_classifier_trains_and_its_demo_runs_without_jax():
    """One CPU train step of the classification config in each train
    configuration, and the classifier demo's port (``--device cpu``),
    where JAX cannot be imported."""
    code = _BLOCKER + textwrap.dedent("""
        import runpy
        import numpy as np
        from pointcloud_orientation_tpu_torch.data import OrientationDataset
        from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig
        ds = OrientationDataset.synthetic(samples_per_class=2, num_points=512)
        cfg = TrainConfig(task="classification", model="pointnet_pp_cls", batch_size=4,
                          num_points=512)
        for fused in (False, True):
            t = Trainer(cfg, ds, device="cpu", fused_mlp_train=fused)
            idx, valid, _ = next(ds.batches(4))
            batch, valid, _ = t.device_batch(ds, idx, valid, t.generator(0, 1, 0))
            m = t.train_step(batch, valid, t.generator(0, 1, 0))
            assert np.isfinite(float(m["loss"])) and np.isnan(m["angular"].numpy()).all()
        sys.argv = ["pointnet_pp_demo_torch.py", "--device", "cpu"]
        runpy.run_path("demos/pointnet_pp_demo_torch.py", run_name="__main__")
        for name in ("jax", "flax", "pointcloud_orientation_tpu"):
            assert name not in sys.modules, name
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "NLL (random weights)" in r.stdout


def test_point_transformer_serves_and_trains_without_jax():
    """The point transformer served on both attention backends and one CPU
    step of the ``point_transformer`` preset with flash attention (depth 2),
    where JAX cannot be imported."""
    code = _BLOCKER + textwrap.dedent("""
        import warnings
        import numpy as np
        import pointcloud_orientation_tpu_torch as port
        from pointcloud_orientation_tpu_torch.data import OrientationDataset
        from pointcloud_orientation_tpu_torch.train import Trainer, preset
        v = port.random_flax_variables(0, "point_transformer", depth=2, ffn_dim=64)
        x = np.random.default_rng(0).normal(size=(3, 100, 3)).astype(np.float32)
        outs = [port.OrientationPredictor("point_transformer", v["params"], num_points=128,
                                          device="cpu", attention_impl=impl)(x)
                for impl in ("xla", "flash")]
        assert all(o.shape == (3, 3) for o in outs)
        assert np.abs(outs[0] - outs[1]).max() < 1e-5
        ds = OrientationDataset.synthetic(samples_per_class=4, num_points=128,
                                          class_names=["chair"])
        t = Trainer(preset("point_transformer", batch_size=4, num_points=128,
                           transformer_attention="flash"), ds, device="cpu", depth=2,
                    ffn_dim=64)
        idx, valid, _ = next(ds.batches(4))
        batch, valid, _ = t.device_batch(ds, idx, valid, t.generator(0, 1, 0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert np.isfinite(float(t.train_step(batch, valid, t.generator(0, 1, 0))["loss"]))
        for name in ("jax", "flax", "pointcloud_orientation_tpu"):
            assert name not in sys.modules, name
        print("TRAINED")
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "TRAINED" in r.stdout


def test_real_data_trains_evaluates_and_exports_without_jax(tmp_path):
    """The real-data path where jax, h5py and matplotlib cannot be imported:
    a PLY tree written and rotated by the offline tools with its three
    ground-truth passes, read through the native parser, one epoch of the
    CLI on ``plygt:`` (stored targets), a reference-layout ``.pth`` of the
    trained weights served back and evaluated; the committed HDF5 fixture
    ``tests/data/modelnet_h5`` read by ``from_hdf5`` (no h5py) and one epoch
    of the CLI on ``hdf5:`` over its classes."""
    code = _BLOCKER + textwrap.dedent("""
        import os, sys
        import numpy as np
        from pointcloud_orientation_tpu_torch.data import OrientationDataset, fastply, offline
        from pointcloud_orientation_tpu_torch.data import synthetic_modelnet, write_ply
        from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
        from pointcloud_orientation_tpu_torch.train import Trainer, evaluate, preset, run
        from pointcloud_orientation_tpu_torch.utils import save_torch_checkpoint, to_flax_variables
        root = sys.argv[1]
        pts, labels, names = synthetic_modelnet(num_points=160, samples_per_class=6,
                                                class_names=["chair", "bottle"])
        for i, (p, l) in enumerate(zip(pts, labels)):
            os.makedirs(f"{root}/c/{names[l]}", exist_ok=True)
            write_ply(p, f"{root}/c/{names[l]}/{i}.ply")
        offline.rotate_tree(f"{root}/c", f"{root}/r", seed=0)
        offline.generate_8dir_gt(f"{root}/r")
        offline.generate_single_peak_gt(f"{root}/r")
        offline.generate_mvm_gt(f"{root}/r", f"{root}/r")
        fastply.reset_parser_counts()
        run.main(["--preset", "8dir_kl", "--data", f"plygt:{root}/r", "--epochs", "1",
                  "--num-points", "128", "--batch-size", "4", "--device", "cpu",
                  "--out", f"{root}/out"])
        assert fastply.parser_counts() == {"native": 12, "numpy": 0}, fastply.parser_counts()
        assert len(os.listdir(f"{root}/out/pred_ply")) == 3  # the test split of 12 clouds
        ds = OrientationDataset.from_ply_tree(f"{root}/r", 128, load_sidecars=True)
        cfg = preset("8dir_kl", num_points=128, batch_size=4, rotation_mode="none")
        t = Trainer(cfg, ds, device="cpu")
        save_torch_checkpoint(f"{root}/m.pth", **to_flax_variables(t.model), model=cfg.model)
        out = OrientationPredictor.from_torch_checkpoint(f"{root}/m.pth", num_points=128,
                                                         device="cpu")(ds.points[:2])
        assert out.shape == (2, 8) and np.isfinite(out).all()
        r = evaluate.evaluate(cfg, ds, torch_ckpt=f"{root}/m.pth", device="cpu")
        assert np.isfinite(r["loss"]) and r["loss"] == t.test().mean_loss
        h5 = os.path.join("tests", "data", "modelnet_h5")
        hd = OrientationDataset.from_hdf5(h5)
        assert hd.points.shape == (10, 2048, 3) and hd.points.dtype == np.float32
        assert len(hd.class_names) == 40 and hd.labels.dtype == np.int32
        classes = ",".join(sorted({hd.class_names[i] for i in hd.labels}))
        run.main(["--preset", "8dir_kl", "--data", f"hdf5:{h5}", "--epochs", "1",
                  "--num-points", "128", "--batch-size", "4", "--classes", classes,
                  "--device", "cpu", "--out", f"{root}/h5out"])
        assert os.path.exists(f"{root}/h5out/metrics.json")
        for name in ("jax", "flax", "h5py", "matplotlib", "pointcloud_orientation_tpu"):
            assert name not in sys.modules, name
        print("REAL DATA")
    """)
    r = _run(code, args=(str(tmp_path),))
    assert r.returncode == 0, r.stderr
    assert "REAL DATA" in r.stdout


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
