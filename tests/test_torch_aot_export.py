"""The port's ahead-of-time serving artifact (``utils/aot_export.py``,
``torch.export`` and ``.pt2``) against the live model and the JAX model on
the CPU, and the two small demos against the JAX package's. Mirrors
``tests/test_stablehlo_export.py``: the artifact holds its weights,
equals the eager eval forward (and the JAX model's) at a fixed and at a
symbolic batch, survives a save and load, is deterministic, exports under
the approximate kNN, and the CLI writes it from each checkpoint kind the
port reads; ``use_kernels=True`` and the JAX package's Orbax checkpoints
are refused.
"""

import contextlib
import io
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.ops import geometry as G
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.utils import (
    random_flax_variables,
    save_torch_checkpoint,
    to_flax_variables,
)
from pointcloud_orientation_tpu_torch.utils.aot_export import (
    build_model,
    export_orientation_model,
    load_artifact,
    main as export_main,
    save_artifact,
)
from pointcloud_orientation_tpu_torch.utils.quantize import (
    dequantize_params,
    load_quantized_checkpoint,
    map_leaves,
    save_quantized_checkpoint,
)

B, N = 2, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def eight_dir():
    """The 8-dir model's flax variables, the live CPU model, clouds, and
    its artifact with a symbolic batch (exported once)."""
    v = random_flax_variables(0)
    x = np.random.default_rng(0).normal(size=(B, N, 3)).astype(np.float32)
    exported = export_orientation_model("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                        batch_size=None, num_points=N)
    return v, build_model("pointnet_pp_8dir", v["params"], v["batch_stats"]), x, exported


def _eager(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_exported_matches_eager_and_jax(eight_dir):
    """The artifact's logits equal the eager eval forward's (the same plain
    operations) and lie within 1e-4 of the JAX model's, which the artifact
    of the JAX package also serves (first ``npoint`` centroids)."""
    v, model, x, exported = eight_dir
    got = exported.module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _eager(model, x))
    want = np.asarray(jax.jit(lambda c: JaxPointNetPP8Dir().apply(v, c))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fixed_batch_save_load_round_trip(eight_dir, tmp_path):
    """A fixed-batch artifact through ``save_artifact``/``load_artifact``:
    a ``.pt2`` file, the weights inside it (the program runs with no module
    of the port), equal to the eager forward; another batch size is
    refused."""
    v, model, x, _ = eight_dir
    exported = export_orientation_model("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                        batch_size=B, num_points=N)
    path = str(tmp_path / "model.pt2")
    save_artifact(path, exported)
    assert os.path.getsize(path) > 1_000_000  # the weights are in the file
    restored = load_artifact(path)
    assert len(restored.state_dict) > 0
    np.testing.assert_array_equal(restored.module()(torch.from_numpy(x)).numpy(),
                                  _eager(model, x))
    with pytest.raises(Exception):
        restored.module()(torch.zeros((B + 1, N, 3)))


def test_deterministic_without_a_generator(eight_dir):
    """Traced with no generator: the first ``npoint`` centroids, the same
    logits on every call."""
    _, _, x, exported = eight_dir
    program = exported.module()
    a = program(torch.from_numpy(x))
    assert torch.equal(a, program(torch.from_numpy(x)))


def test_shape_polymorphic_batch(eight_dir, tmp_path):
    """``batch_size=None``: one artifact serves batches 1, 2 and 5 after a
    save and load, each equal to the eager forward."""
    _, model, _, exported = eight_dir
    path = str(tmp_path / "poly.pt2")
    save_artifact(path, exported)
    program = load_artifact(path).module()
    for b in (1, 2, 5):
        xb = np.random.default_rng(b).normal(size=(b, N, 3)).astype(np.float32)
        np.testing.assert_array_equal(program(torch.from_numpy(xb)).numpy(), _eager(model, xb))


def test_load_artifact_moves_to_a_device(eight_dir, tmp_path):
    """``load_artifact(device=...)`` moves weights, constants and the
    devices written into the graph (checked on ``meta``, the card's path
    without a card)."""
    _, _, _, exported = eight_dir
    path = str(tmp_path / "m.pt2")
    save_artifact(path, exported)
    moved = load_artifact(path, device="meta")
    assert {t.device.type for t in moved.state_dict.values()} == {"meta"}
    assert moved.module()(torch.zeros((3, N, 3), device="meta")).shape == (3, 8)


def test_use_kernels_and_orbax_are_refused(eight_dir, tmp_path):
    v = eight_dir[0]
    with pytest.raises(NotImplementedError, match="ctypes"):
        export_orientation_model("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                 batch_size=B, num_points=N, use_kernels=True)
    with pytest.raises(NotImplementedError, match="Orbax"):
        export_main([str(tmp_path), str(tmp_path / "x.pt2")])


def test_export_under_approx_knn(eight_dir):
    """``set_knn_impl("approx")`` composes with export: sa1 traced through
    the approx path (``topk_min``'s plain version), equal to the eager
    forward under approx and, this cloud having no ties, to the exact
    artifact."""
    v, model, x, exported = eight_dir
    G.set_knn_impl("approx", approx_min_n=1)
    try:
        approx = export_orientation_model("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                          batch_size=B, num_points=N)
        got = approx.module()(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, _eager(model, x))
    finally:
        G.set_knn_impl("exact", approx_min_n=4096)
    assert any("topk" in str(n.target) or "sort" in str(n.target)
               for n in approx.graph.nodes if n.op == "call_function")
    np.testing.assert_allclose(got, exported.module()(torch.from_numpy(x)).numpy(), atol=1e-6)


def _sources(tmp_path):
    """A ``simple_pointnet`` checkpoint of each kind the CLI reads: the
    port's (after one epoch), a reference ``.pth`` and an int8 ``.npz`` of
    the same weights; and the weights each should give."""
    cfg = preset("simple_pointnet", epochs=1, batch_size=4, num_points=64)
    trainer = Trainer(cfg, OrientationDataset.synthetic(samples_per_class=8, num_points=64,
                                                        class_names=["chair"]), device="cpu")
    trainer.fit(log_every=0)
    ckpt = trainer.save_checkpoint(str(tmp_path / "ckpt"))
    trainer.load_best()
    tree = to_flax_variables(trainer.model)
    pth, npz = str(tmp_path / "w.pth"), str(tmp_path / "w.npz")
    save_torch_checkpoint(pth, tree["params"], tree["batch_stats"], model="simple_pointnet")
    save_quantized_checkpoint(npz, tree["params"], tree["batch_stats"])
    q, scales, stats = load_quantized_checkpoint(npz)
    deq = dequantize_params(map_leaves(q, lambda k, a: torch.from_numpy(np.asarray(a))),
                            {k: torch.from_numpy(s) for k, s in scales.items()})
    int8 = {"params": map_leaves(deq, lambda k, t: t.numpy()), "batch_stats": stats}
    return {"ckpt": (ckpt, tree), "pth": (pth, tree), "npz": (npz, int8)}


@pytest.mark.parametrize("batch", [0, 3])
def test_cli_from_each_checkpoint_kind(tmp_path, capsys, batch):
    """The CLI writes a ``.pt2`` from the port's checkpoint (its best-val
    weights), a reference ``.pth`` and an int8 ``.npz`` (dequantized), at
    a symbolic (0) and a fixed batch; each equals the model built from
    those weights."""
    x = np.random.default_rng(7).normal(size=(3, 64, 3)).astype(np.float32)
    for kind, (path, tree) in _sources(tmp_path).items():
        out = str(tmp_path / f"{kind}.pt2")
        export_main([path, out, "--model", "simple_pointnet", "--batch-size", str(batch),
                     "--num-points", "64"])
        assert f"wrote {out}: model=simple_pointnet" in capsys.readouterr().out
        got = load_artifact(out).module()(torch.from_numpy(x)).numpy()
        want = _eager(build_model("simple_pointnet", tree["params"], tree["batch_stats"]), x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=kind)


def _stdout(path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    return buf.getvalue()


def test_demos_print_what_the_jax_demos_print():
    """``demos/kl_vs_mse_torch.py`` prints the JAX demo's table line for
    line; ``demos/device_check_torch.py`` the JAX demo's three lines, for
    torch's devices: the backend, the devices, the count (one CPU; the
    JAX process may split its CPU into several devices)."""
    assert _stdout(os.path.join(REPO, "demos", "kl_vs_mse_torch.py")) == _stdout(
        os.path.join(REPO, "demos", "kl_vs_mse.py"))
    port = _stdout(os.path.join(REPO, "demos", "device_check_torch.py")).splitlines()
    jax_lines = _stdout(os.path.join(REPO, "demos", "device_check.py")).splitlines()
    assert port[0] == jax_lines[0] == "backend: cpu"
    assert port[1] == "devices: ['cpu']" and jax_lines[1].startswith("devices: ")
    assert port[2] == "device count: 1" and jax_lines[2].startswith("device count: ")
