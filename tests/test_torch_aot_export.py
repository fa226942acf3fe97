"""The port's ahead-of-time serving artifact (``utils/aot_export.py``,
``torch.export`` and ``.pt2``) against the live model and the JAX model on
the CPU, and the two small demos against the JAX package's. Mirrors
``tests/test_stablehlo_export.py``: the artifact holds its weights,
equals the eager eval forward (and the JAX model's) at a fixed and at a
symbolic batch, survives a save and load, is deterministic, exports under
the approximate kNN, and the CLI writes it from each checkpoint kind the
port reads, the JAX package's Orbax checkpoints among them. The kernel
artifact (``use_kernels=True``, ``--kernels``): one ``pcot.*`` node for each
kernel launch an eager request makes (the 8-dir model and the flash point
transformer), run on the CPU through the ops' plain versions, equal to the
portable artifact and the JAX artifact, through a save and load with a
symbolic batch; the default artifact holds no such node; the approximate
kNN composes. Under the grid kNN both artifacts hold its certificate as a
``torch.cond``, as the JAX export holds a ``lax.cond``: on a batch that
passes it and on one that falls back, equal to the eager grid model and the
JAX grid artifact, the kernel artifact's fallback branch holding
``pcot::knn``. Each ``pcot`` op against its plain version.
"""

import collections
import contextlib
import io
import os
import runpy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu.ops import geometry as jax_geometry
from pointcloud_orientation_tpu.utils.stablehlo_export import (
    export_orientation_model as jax_export_orientation_model,
)
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
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
    kernel_nodes,
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


def test_orbax_is_refused(tmp_path, capsys):
    """Once refused, now read: the CLI exports an Orbax checkpoint that
    orbax wrote in the JAX package's ``Trainer.save_checkpoint`` layout,
    read without orbax, equal to the model built from those weights."""
    import orbax.checkpoint as ocp
    import optax

    v = random_flax_variables(3, "simple_pointnet")
    tree = {"params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": jax.tree_util.tree_map(np.asarray, optax.chain(optax.adam(1e-3)).init(
                v["params"])), "step": np.asarray(0, np.int32)}
    path, out = str(tmp_path / "step_0"), str(tmp_path / "x.pt2")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, tree)
    export_main([path, out, "--model", "simple_pointnet", "--batch-size", "0",
                 "--num-points", "64"])
    assert f"wrote {out}: model=simple_pointnet" in capsys.readouterr().out
    x = np.random.default_rng(8).normal(size=(2, 64, 3)).astype(np.float32)
    got = load_artifact(out).module()(torch.from_numpy(x)).numpy()
    want = _eager(build_model("simple_pointnet", v["params"], v["batch_stats"]), x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def eight_dir_kernels(eight_dir):
    """The 8-dir model's kernel artifact with a symbolic batch, and the
    JAX package's portable artifact of the same weights (both once)."""
    v = eight_dir[0]
    exported = export_orientation_model("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                        batch_size=None, num_points=N, use_kernels=True)
    jax_exported = jax_export_orientation_model(
        "pointnet_pp_8dir", jax.tree_util.tree_map(jnp.asarray, v["params"]),
        jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), batch_size=None, num_points=N,
        platforms=("cpu",))
    return exported, jax_exported


def _wrapper_calls(model, x, names=("sa_group", "sa_mlp_max", "knn", "fps", "ball_query",
                                    "topk_min", "flash_attention_fwd")):
    """``pcot::<name>`` for each kernel wrapper call of an eager forward
    (each one launch on the card)."""
    calls = []
    with contextlib.ExitStack() as stack:
        for name in names:
            real = getattr(K, name)
            stack.enter_context(mock.patch.object(
                K, name, lambda *a, _real=real, _name=name, **k: calls.append(
                    f"pcot::{_name}") or _real(*a, **k)))
        _eager(model, x)
    return calls


def test_kernel_artifact_holds_a_node_per_launch(eight_dir, eight_dir_kernels):
    """The 8-dir kernel artifact's graph calls ``pcot::sa_group`` twice and
    ``pcot::sa_mlp_max`` three times, one node for each kernel launch of
    an eager request (``chip_smoke.py``'s request launches); the portable
    artifact calls none."""
    v, model, x, portable = eight_dir
    nodes = kernel_nodes(eight_dir_kernels[0])
    assert collections.Counter(nodes) == collections.Counter(_wrapper_calls(model, x)) == {
        "pcot::sa_group": 2, "pcot::sa_mlp_max": 3}
    assert kernel_nodes(portable) == []


def test_kernel_artifact_equals_portable_and_jax(eight_dir, eight_dir_kernels, tmp_path):
    """On the CPU every ``pcot`` node runs its plain version: the kernel
    artifact's logits equal the portable artifact's bit for bit and lie
    within 1e-4 of the JAX artifact's (``stablehlo_export``), at batches
    1, 2 and 5 after a save and load (a symbolic batch)."""
    _, _, _, portable = eight_dir
    exported, jax_exported = eight_dir_kernels
    path = str(tmp_path / "kernels.pt2")
    save_artifact(path, exported)
    restored = load_artifact(path)
    assert kernel_nodes(restored) == kernel_nodes(exported)
    program = restored.module()
    for b in (1, 2, 5):
        xb = np.random.default_rng(b + 10).normal(size=(b, N, 3)).astype(np.float32)
        got = program(torch.from_numpy(xb)).numpy()
        np.testing.assert_array_equal(got, portable.module()(torch.from_numpy(xb)).numpy())
        np.testing.assert_allclose(got, np.asarray(jax_exported.call(jnp.asarray(xb))),
                                   rtol=1e-4, atol=1e-4)


def test_kernel_artifact_of_the_flash_transformer():
    """The point transformer with flash attention: one
    ``pcot::flash_attention_fwd`` node for each of its eager forward's six
    launches; on the CPU equal to the portable artifact and the eager
    forward."""
    kw = {"attention_impl": "flash"}
    v = random_flax_variables(1, "point_transformer")
    x = np.random.default_rng(1).normal(size=(B, 128, 3)).astype(np.float32)
    model = build_model("point_transformer", v["params"], None, kw)
    kernels, portable = (export_orientation_model(
        "point_transformer", v["params"], None, batch_size=None, num_points=128,
        model_kwargs=kw, use_kernels=use) for use in (True, False))
    assert kernel_nodes(kernels) == _wrapper_calls(model, x) == [
        "pcot::flash_attention_fwd"] * 6
    assert kernel_nodes(portable) == []
    got = kernels.module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, portable.module()(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, _eager(model, x))


GRID_N = 4096  # the grid kNN's smallest stage (approx_min_n): sa1 takes it


def _grid_clouds(kind):
    """B=2 clouds of GRID_N points in [-1, 1]^3. ``"certified"``: the first
    512 points scaled into [-0.4, 0.4]^3, a dense core around sa1's 128
    centroids (sampling "first"), whose 32 nearest then lie inside their
    cell cubes; ``"fallback"``: uniform, where some centroid's do not."""
    x = np.random.default_rng(21).uniform(-1, 1, size=(B, GRID_N, 3)).astype(np.float32)
    if kind == "certified":
        x[:, :512] *= 0.4
    return x


@pytest.fixture(scope="module")
def grid_artifacts(eight_dir):
    """Under ``set_knn_impl("grid", approx_min_n=GRID_N)``: the portable and
    the kernel artifact (symbolic batch), the eager model's logits on both
    clouds, and the JAX package's portable artifact under its own grid kNN
    (the same weights, B=2) with its logits on both clouds."""
    v = eight_dir[0]
    G.set_knn_impl("grid", approx_min_n=GRID_N)
    jax_geometry.set_knn_impl("grid", approx_min_n=GRID_N)
    try:
        portable, kernels = (export_orientation_model(
            "pointnet_pp_8dir", v["params"], v["batch_stats"], batch_size=None,
            num_points=GRID_N, use_kernels=use) for use in (False, True))
        model = build_model("pointnet_pp_8dir", v["params"], v["batch_stats"])
        eager = {kind: _eager(model, _grid_clouds(kind)) for kind in ("certified", "fallback")}
        jax_exported = jax_export_orientation_model(
            "pointnet_pp_8dir", jax.tree_util.tree_map(jnp.asarray, v["params"]),
            jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), batch_size=B,
            num_points=GRID_N, platforms=("cpu",))
    finally:
        G.set_knn_impl("exact", approx_min_n=4096)
        jax_geometry.set_knn_impl("exact", approx_min_n=4096)
    jax_logits = {kind: np.asarray(jax_exported.call(jnp.asarray(_grid_clouds(kind))))
                  for kind in eager}
    return portable, kernels, eager, jax_logits


@pytest.mark.parametrize("kind", ["certified", "fallback"])
def test_grid_artifacts_take_the_certificate_branch(grid_artifacts, kind, tmp_path):
    """The grid kNN's certificate is a ``torch.cond`` in the exported
    program (the JAX export's ``lax.cond``): on a batch that passes it
    (``grid_pruned_core``'s ``ok``, sa1's centroids) and on one that fails
    it, the portable artifact equals the eager grid model bit for bit and
    the JAX grid artifact within 1e-4; the kernel artifact, through a save
    and load, equals the portable one (its ``pcot`` nodes run the plain
    versions on the CPU)."""
    portable, kernels, eager, jax_logits = grid_artifacts
    x = torch.from_numpy(_grid_clouds(kind))
    _, ok = G.grid_pruned_core(x[:, :128], x, 32)  # sa1: 128 centroids, K=32
    assert bool(ok) == (kind == "certified")
    got = portable.module()(x).numpy()
    np.testing.assert_array_equal(got, eager[kind])
    np.testing.assert_allclose(got, jax_logits[kind], rtol=1e-4, atol=1e-4)
    path = str(tmp_path / "grid_kernels.pt2")
    save_artifact(path, kernels)
    np.testing.assert_array_equal(load_artifact(path).module()(x).numpy(), got)


def test_kernels_under_grid_are_refused_and_approx_composes(eight_dir, grid_artifacts,
                                                             tmp_path):
    """The kernel export under grid is no longer refused: its graph calls
    ``pcot::topk_min`` (the pruned selection, before the branch),
    ``pcot::knn`` inside the ``cond``'s fallback branch and the grouping
    and MLP kernels of sa2 and sa3, and a move to another device carries
    the branches (no node left naming the CPU). Under the approximate kNN
    sa1 traces through ``pcot::topk_min`` and equals the portable approx
    artifact."""
    v, _, x, _ = eight_dir
    _, grid_kernels, _, _ = grid_artifacts
    assert collections.Counter(kernel_nodes(grid_kernels)) == {
        "pcot::topk_min": 1, "pcot::knn": 1, "pcot::sa_group": 1, "pcot::sa_mlp_max": 3}
    branches = {name: [n.target.name() for n in m.graph.nodes if n.op == "call_function"
                       and getattr(n.target, "namespace", None) == "pcot"]
                for name, m in grid_kernels.graph_module.named_children()
                if isinstance(m, torch.fx.GraphModule)}
    assert sorted(branches.values()) == [[], ["pcot::knn"]]
    path = str(tmp_path / "grid_kernels.pt2")
    save_artifact(path, grid_kernels)
    moved = load_artifact(path, device="meta")
    devices = {str(n.kwargs["device"]) for m in moved.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
               if "device" in n.kwargs}
    assert devices == {"meta"}
    G.set_knn_impl("approx", approx_min_n=N)
    try:
        kernels, portable = (export_orientation_model(
            "pointnet_pp_8dir", v["params"], v["batch_stats"], batch_size=B, num_points=N,
            use_kernels=use) for use in (True, False))
    finally:
        G.set_knn_impl("exact", approx_min_n=4096)
    assert collections.Counter(kernel_nodes(kernels)) == {
        "pcot::topk_min": 1, "pcot::sa_group": 1, "pcot::sa_mlp_max": 3}
    np.testing.assert_array_equal(kernels.module()(torch.from_numpy(x)).numpy(),
                                  portable.module()(torch.from_numpy(x)).numpy())


def test_cli_kernels_flag(eight_dir, tmp_path, capsys):
    """``--kernels`` writes the kernel artifact from a reference ``.pth``."""
    v, model, x, _ = eight_dir
    pth, out = str(tmp_path / "w.pth"), str(tmp_path / "k.pt2")
    save_torch_checkpoint(pth, v["params"], v["batch_stats"], model="pointnet_pp_8dir")
    export_main([pth, out, "--batch-size", "0", "--num-points", str(N), "--kernels"])
    assert "kernels=5" in capsys.readouterr().out
    restored = load_artifact(out)
    assert len(kernel_nodes(restored)) == 5
    np.testing.assert_allclose(restored.module()(torch.from_numpy(x)).numpy(), _eager(model, x),
                               rtol=1e-6, atol=1e-6)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    xyz = torch.randn(2, 256, 3, generator=g)
    feats = torch.randn(2, 256, 5, generator=g)
    cidx = torch.randint(0, 256, (2, 32), generator=g, dtype=torch.int32)
    layers = [(torch.randn(8, 16, generator=g), torch.rand(16, generator=g),
               torch.randn(16, generator=g)),
              (torch.randn(16, 32, generator=g), torch.rand(32, generator=g),
               torch.randn(32, generator=g))]
    grouped = torch.randn(2, 16, 32, 8, generator=g)
    d = torch.rand(2, 4, 50, generator=g)
    d[0, 0, 5:] = float("inf")
    q, k, v = (torch.randn(1, 2, 128, 16, generator=g) for _ in range(3))
    return {
        "sa_group": lambda: K.sa_group(xyz, feats, cidx, 16),
        "sa_group coords": lambda: K.sa_group(xyz, None, cidx, 16),
        "sa_mlp_max": lambda: K.sa_mlp_max(grouped, layers),
        "sa_mlp_max bf16": lambda: K.sa_mlp_max(grouped, layers, True),
        "knn": lambda: K.knn(xyz[:, :32], xyz, 8),
        "fps": lambda: K.fps(xyz, torch.tensor([0, 7], dtype=torch.int32), 16),
        "ball_query": lambda: K.ball_query(xyz[:, :32], xyz, 0.4, 8),
        "ball_query matmul": lambda: K.ball_query(xyz[:, :32], xyz, 0.4, 8, True),
        "topk_min": lambda: K.topk_min(d, 8),
        "flash_attention_fwd": lambda: K.flash_attention_fwd(q, k, v, 0.25),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_ops_on_the_cpu_are_the_plain_versions(case):
    """Each ``pcot`` op called on CPU tensors (``kernel_mode("ops")``) runs
    its plain version: the wrapper's outputs, bit for bit, in type and
    shape (the fake implementation's too)."""
    call = _op_cases()[case]
    want = call()
    with K.kernel_mode("ops"):
        got = call()
    with torch._subclasses.fake_tensor.FakeTensorMode(allow_non_fake_inputs=True), \
            K.kernel_mode("ops"):
        fake = call()
    want, got, fake = (o if isinstance(o, tuple) else (o,) for o in (want, got, fake))
    assert len(got) == len(want) == len(fake)
    for a, b, f in zip(got, want, fake):
        assert a.dtype == b.dtype == f.dtype and a.shape == b.shape == f.shape
        assert torch.equal(a, b)


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
