"""The port's grid-pruned exact kNN and its ``topk_min`` selection against the
JAX package's (``_grid_pruned_core``, ``topk_min_pallas`` in interpret
mode), the grid dispatch against the exact one as neighbour sets, the kNN
environment knobs, and the 8-dir model under the grid dispatch against the
JAX model under its own."""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu.ops import geometry as JG
from pointcloud_orientation_tpu.ops.pallas_kernels import topk_min_pallas
from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as G
from pointcloud_orientation_tpu_torch.utils import load_flax_variables, random_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_knn_impl():
    """Both packages keep the kNN formulation in module state: every test
    leaves the defaults behind it."""
    yield
    G.set_knn_impl("exact", recall_target=0.95, approx_min_n=4096)
    JG.set_knn_impl("exact", recall_target=0.95, approx_min_n=4096)


def _topk_case(rng, B, S, M, Kn):
    """Small integers (many ties), a row with 3 finite entries, an all-inf
    row and a row that is half inf."""
    d = rng.integers(0, 6, size=(B, S, M)).astype(np.float32)
    d[0, 0, 3:] = np.inf
    d[0, 1, :] = np.inf
    d[-1, -1, ::2] = np.inf
    return d


@pytest.mark.parametrize("M,Kn", [(40, 8), (32, 32), (100, 17), (70, 64)])
def test_topk_min_plain_equals_topk_min_pallas(M, Kn):
    """Bit-equal indices, ties to the lowest position, and position 0 once a
    row's finite entries are used up (the Pallas kernel's eviction)."""
    d = _topk_case(np.random.default_rng(M + Kn), 2, 6, M, Kn)
    want = np.asarray(topk_min_pallas(jnp.asarray(d), Kn, interpret=True))
    got = K.topk_min(torch.from_numpy(d), Kn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0, 3:].numpy(), 0)
    np.testing.assert_array_equal(got[0, 1].numpy(), 0)


def test_topk_min_refuses_what_the_kernel_does_not_take():
    d = torch.zeros((1, 2, 100))
    with pytest.raises(ValueError, match="nsample=65"):
        K.topk_min(d, 65)
    with pytest.raises(ValueError, match="nsample=8"):
        K.topk_min(torch.zeros((1, 2, 7)), 8)
    with pytest.raises(TypeError):
        K.topk_min(d.double(), 4)


def _clouds(kind: str, rng) -> np.ndarray:
    if kind == "uniform":  # the first 200 points inside [-0.5, 0.5]^3: those certify
        a = rng.uniform(-1, 1, size=(2, 6000, 3)).astype(np.float32)
        a[:, :200] *= 0.5
        return a
    if kind == "mixed":  # a cluster in a box: uneven cells, the certificate fails
        return np.concatenate([rng.normal(size=(2, 3000, 3)) * 0.2,
                               rng.uniform(-1, 1, size=(2, 3000, 3))], 1).astype(np.float32)
    # kind == "lattice": every coordinate a multiple of 1/8 in [-1, 1] with
    # a few points moved by one ulp, so many land on a cell boundary
    a = rng.integers(-8, 9, size=(2, 5000, 3)).astype(np.float32) / 8
    a[:, ::7] = np.nextafter(a[:, ::7], np.float32(2))
    return a


@pytest.mark.parametrize("kind", ["uniform", "mixed", "lattice"])
def test_grid_pruned_core_matches_jax(kind):
    """``idx`` and ``ok`` bit-equal to the JAX package's
    ``_grid_pruned_core`` (``lax.top_k`` on the CPU), on clouds where every
    centroid's cube holds at least K candidates (there ``lax.top_k`` and
    ``topk_min`` agree)."""
    rng = np.random.default_rng(0)
    x = _clouds(kind, rng)
    c = x[:, :96].copy()
    want_idx, want_ok = JG._grid_pruned_core(jnp.asarray(c), jnp.asarray(x), 32)
    got_idx, got_ok = G.grid_pruned_core(torch.from_numpy(c), torch.from_numpy(x), 32)
    t = torch.from_numpy(x)
    lo, h, _, pts_s, starts = G.grid_bins(t, G._KNN_GRID_G)
    total = G.grid_window(torch.from_numpy(c), lo, h, starts, pts_s, G._KNN_GRID_G,
                          G._KNN_GRID_R, 1024)[2]
    assert int(total.min()) >= 32
    assert bool(got_ok) == bool(want_ok) == (kind == "uniform")
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_grid_bins_cell_ids_match_xla_on_cell_boundaries():
    """The cell of every point, ``(x - lo) / h`` in f32 truncated to int32,
    and the stable sort by cell id, bit-equal to the same expressions of
    ``_grid_pruned_core`` compiled by XLA, on a lattice cloud with points on
    and one ulp off the cell boundaries."""
    g = G._KNN_GRID_G
    x = _clouds("lattice", np.random.default_rng(1))

    @jax.jit
    def xla_bins(x):
        lo = jnp.min(x, axis=1, keepdims=True) - 1e-6
        hi = jnp.max(x, axis=1, keepdims=True) + 1e-6
        h = (hi - lo) / g
        cell = jnp.clip((x - lo) / h, 0, g - 1).astype(jnp.int32)
        cid = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
        return cid, jnp.argsort(cid, axis=-1)

    want_cid, want_order = map(np.asarray, xla_bins(jnp.asarray(x)))
    t = torch.from_numpy(x)
    lo, h, order, pts_s, starts = G.grid_bins(t, g)
    cell = G._cells(t, lo, h, g)
    cid = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    np.testing.assert_array_equal(cid.numpy(), want_cid)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(pts_s.numpy(), np.take_along_axis(x, want_order[..., None], 1))
    assert int(starts[:, -1].min()) == x.shape[1]


def test_run_of_slot_equals_the_jax_comparison_sum():
    """``searchsorted(o, t, right=True)`` against JAX's ``sum(t >= o)`` over
    a ``(B, S, M, R2)`` comparison, on runs with empty ones among them."""
    rng = np.random.default_rng(2)
    lens = rng.integers(0, 40, size=(3, 17, 9))
    lens[rng.random(lens.shape) < 0.3] = 0
    o = np.cumsum(lens, -1)
    m = 300
    t = jnp.arange(m)
    want = np.asarray(jnp.sum(t[None, None, :, None] >= jnp.asarray(o)[:, :, None, :], axis=-1))
    got = G.run_of_slot(torch.from_numpy(o), m)
    np.testing.assert_array_equal(got.numpy(), want)


def _sets_equal(a, b):
    a, b = np.sort(np.asarray(a), -1), np.sort(np.asarray(b), -1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["certified", "mixed", "overflow", "adversarial"])
def test_grid_knn_equals_exact_knn_as_sets(monkeypatch, case):
    """The grid dispatch returns the exact kNN's neighbour sets: directly
    when the certificate holds (no fallback), through the full exact kNN
    when it fails (uneven cells, a window budget below K, a sparse cloud
    whose K-th neighbour lies outside the cell cube)."""
    rng = np.random.default_rng(3)
    Kn = 32
    if case == "certified":
        x = _clouds("uniform", rng)
    elif case == "mixed":
        x = _clouds("mixed", rng)
    elif case == "overflow":
        monkeypatch.setattr(G, "_KNN_GRID_M", 8)  # < K: the certificate must fail
        x = rng.normal(size=(2, 2048, 3)).astype(np.float32)
        Kn = 16
    else:
        x = rng.uniform(-100, 100, size=(1, 512, 3)).astype(np.float32)
        Kn = 12
    xyz = torch.from_numpy(x)
    new_xyz = xyz[:, :64].contiguous()
    exact = G.exact_full_knn(new_xyz, xyz, Kn)
    G.set_knn_impl("grid", approx_min_n=1)
    fallbacks = []
    full = G.exact_full_knn

    def recording(*args):
        fallbacks.append(args)
        return full(*args)

    with mock.patch.object(G, "exact_full_knn", recording):
        grid = G.knn_indices(new_xyz, xyz, Kn)
    assert len(fallbacks) == (0 if case == "certified" else 1)
    _sets_equal(grid, exact)


def test_sample_and_group_under_grid_skips_the_fused_grouping(monkeypatch):
    """A grid-eligible stage gathers apart (the fused grouping is never
    called, as JAX's ``sample_and_group`` skips it) and groups the exact
    path's neighbours; a smaller stage keeps the fused grouping."""
    x = torch.from_numpy(_clouds("uniform", np.random.default_rng(4)))
    nx_e, ge = G.sample_and_group(x, None, 64, 16, sampling="first")
    G.set_knn_impl("grid", approx_min_n=1024)

    def refuse(*args):
        raise AssertionError("the fused grouping ran on a grid stage")

    with mock.patch.object(K, "sa_group", refuse):
        nx_g, gg = G.sample_and_group(x, None, 64, 16, sampling="first")
    torch.testing.assert_close(nx_g, nx_e, rtol=0, atol=0)
    torch.testing.assert_close(torch.sort(gg, dim=2).values, torch.sort(ge, dim=2).values,
                               rtol=0, atol=0)
    small = x[:, :512].contiguous()
    with mock.patch.object(K, "sa_group", wraps=K.sa_group) as fused:
        G.sample_and_group(small, None, 64, 16, sampling="first")
    assert fused.call_count == 1


# One process, one import of torch: the port's geometry module is loaded
# afresh under each environment and its state or its error printed.
_ENV_PROBE = """
import importlib.util, json, os, sys
os.environ["PCOT_KNN"] = "Approx"
try:
    import pointcloud_orientation_tpu_torch
    print("imported")
except ValueError as e:
    print("package", type(e).__name__, e)
path = os.path.join("pointcloud_orientation_tpu_torch", "ops", "geometry.py")
for i, env in enumerate(json.loads(sys.argv[1])):
    for k in [k for k in os.environ if k.startswith("PCOT_KNN")]:
        del os.environ[k]
    os.environ.update(env)
    spec = importlib.util.spec_from_file_location(f"geometry_{i}", path)
    G = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(G)
        print(G._KNN_IMPL, G._KNN_APPROX_MIN_N, G._KNN_GRID_G, G._KNN_GRID_R, G._KNN_GRID_M,
              G.grid_eligible(10000), G.approx_eligible(10000), G._KNN_RECALL)
    except Exception as e:
        print(type(e).__name__, str(e).replace(chr(10), " "))
"""


def test_knn_env_knobs_are_read_and_validated_at_import():
    """The port reads PCOT_KNN, PCOT_KNN_RECALL, PCOT_KNN_APPROX_MIN_N and
    PCOT_KNN_GRID_{G,R,M} at import as the JAX package does: a typo fails
    (the package's import too), 'approx' is the dispatch with its recall
    target stored, ' grid ' (stripped) is the dispatch, and without the
    knobs the defaults stand."""
    envs = [{"PCOT_KNN": "Approx"}, {"PCOT_KNN": "approx", "PCOT_KNN_RECALL": "0.5"},
            {"PCOT_KNN": "grid", "PCOT_KNN_RECALL": "1.5"},
            {"PCOT_KNN": " grid ", "PCOT_KNN_APPROX_MIN_N": "2048", "PCOT_KNN_GRID_M": "512"},
            {}]
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PCOT_KNN") and k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _ENV_PROBE, json.dumps(envs)], cwd=REPO, env=base,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    package, typo, approx, recall, grid, default = r.stdout.splitlines()
    assert package == "package ValueError bad knn impl: Approx"
    assert typo == "ValueError bad knn impl: Approx"
    assert approx.split() == ["approx", "4096", "8", "1", "1024", "False", "True", "0.5"]
    assert recall == "ValueError bad recall_target: 1.5"
    assert grid.split() == ["grid", "2048", "8", "1", "512", "True", "False", "0.95"]
    assert default.split() == ["exact", "4096", "8", "1", "1024", "False", "False", "0.95"]


def test_set_knn_impl_validates_before_it_changes_anything():
    """A rejected call changes nothing (the JAX package's atomicity); an
    accepted 'approx' takes the dispatch and stores its recall target."""
    G.set_knn_impl("grid", approx_min_n=2000)
    for args, err in ((("grid",), {"approx_min_n": 0}), (("grid",), {"recall_target": 0.0}),
                      (("Grid",), {}), (("approx",), {"approx_min_n": 0}),
                      (("approx",), {"recall_target": 1.5})):
        with pytest.raises(ValueError):
            G.set_knn_impl(*args, **err)
        assert G._KNN_IMPL == "grid" and G._KNN_APPROX_MIN_N == 2000 and G._KNN_RECALL == 0.95
    assert G.grid_eligible(2000) and not G.grid_eligible(1999)
    G.set_knn_impl("approx", recall_target=0.9, approx_min_n=5)
    assert (G._KNN_IMPL, G._KNN_RECALL, G._KNN_APPROX_MIN_N) == ("approx", 0.9, 5)
    assert G.approx_eligible(5) and not G.grid_eligible(5) and not G.approx_eligible(4)


def test_pointnet_pp_8dir_under_grid_matches_jax_under_grid():
    """The 8-dir model with sa1 on the grid dispatch (approx_min_n lowered
    to 256, N=512; sa2's 128 points stay exact) against the JAX model under
    its own grid dispatch, the same flax variables: logits within 1e-4."""
    rng = np.random.default_rng(5)
    clouds = rng.uniform(-1, 1, size=(2, 512, 3)).astype(np.float32)
    v = random_flax_variables(5)
    JG.set_knn_impl("grid", approx_min_n=256)
    want = np.asarray(JaxPointNetPP8Dir(sampling="first").apply(v, jnp.asarray(clouds)))
    G.set_knn_impl("grid", approx_min_n=256)
    model = load_flax_variables(PointNetPP8Dir(sampling="first"), v).eval()
    with torch.no_grad(), mock.patch.object(K, "topk_min", wraps=K.topk_min) as sel:
        got = model(torch.from_numpy(clouds)).numpy()
    assert sel.call_count == 1  # sa1 only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
