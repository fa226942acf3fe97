"""The port's approximate kNN (``set_knn_impl("approx")``, ``PCOT_KNN=approx``)
against the JAX package's (``jax.lax.approx_min_k`` over the matmul-form
distances, an exact selection off the TPU) on the CPU: neighbour sets and
sorted distances equal, the grouping's geometry, the recall knob and its
validation, the size threshold, the environment knobs at import, the
8-dir model under both dispatches. Mirrors ``tests/test_approx_knn.py``.
The port selects through the ``topk_min`` wrapper (its plain version on
the CPU; the kernel on the card, ``chip_smoke.py`` ``approx_knn``).
"""

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
from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as G
from pointcloud_orientation_tpu_torch.utils import load_flax_variables, random_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_knn_impl():
    yield
    G.set_knn_impl("exact", recall_target=0.95, approx_min_n=4096)
    JG.set_knn_impl("exact", recall_target=0.95, approx_min_n=4096)


def _cloud(seed, b=2, n=512):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def _sorted_distances(new_xyz, xyz, idx):
    """Each centroid's neighbours' matmul-form distances, sorted (float32,
    the port's formula on both sides' indices)."""
    d = G.square_distance(torch.from_numpy(new_xyz), torch.from_numpy(xyz))
    return np.sort(torch.gather(d, 2, torch.from_numpy(np.asarray(idx, np.int64))).numpy(), -1)


def _recall(a, b):
    return float(np.mean([len(set(a[i, s]) & set(b[i, s])) / a.shape[-1]
                          for i in range(a.shape[0]) for s in range(a.shape[1])]))


@pytest.mark.parametrize("seed", [0, 1])
def test_approx_knn_equals_jax_approx_and_exact(seed):
    """On the same cloud the port's approx indices have the JAX approx
    path's neighbour sets and sorted distances, and the port's exact
    path's: recall 1.0 against both (the JAX test asks 0.9 of its own, to
    allow the TPU's approximate lowering)."""
    xyz = _cloud(seed)
    new_xyz = xyz[:, :64]
    JG.set_knn_impl("approx", approx_min_n=1)
    want = np.asarray(JG.knn_query(jnp.asarray(new_xyz), jnp.asarray(xyz), 16))
    exact = G.knn_indices(torch.from_numpy(new_xyz), torch.from_numpy(xyz), 16).numpy()
    G.set_knn_impl("approx", approx_min_n=1)
    with mock.patch.object(K, "topk_min", wraps=K.topk_min) as sel:
        got = G.knn_indices(torch.from_numpy(new_xyz), torch.from_numpy(xyz), 16).numpy()
    assert sel.call_count == 1 and got.dtype == np.int32 and got.shape == (2, 64, 16)
    assert _recall(want, got) == 1.0 and _recall(exact, got) == 1.0
    np.testing.assert_array_equal(_sorted_distances(new_xyz, xyz, got),
                                  _sorted_distances(new_xyz, xyz, want))
    assert np.all(np.diff(_sorted_distances(new_xyz, xyz, got), axis=-1) >= 0)


def test_approx_knn_first_occurrence_on_ties():
    """Points at equal distances (a cloud of repeated points): the port
    takes the lowest indices, nearest first (``topk_min``'s order); the JAX
    path's sets hold the same distances."""
    base = _cloud(2, b=1, n=32)
    xyz = np.concatenate([base] * 8, axis=1)  # every point 8 times
    new_xyz = xyz[:, :4]
    G.set_knn_impl("approx", approx_min_n=1)
    got = G.knn_indices(torch.from_numpy(new_xyz), torch.from_numpy(xyz), 8).numpy()
    d = G.square_distance(torch.from_numpy(new_xyz), torch.from_numpy(xyz)).numpy()
    want = np.argsort(d, axis=-1, kind="stable")[..., :8]
    np.testing.assert_array_equal(got, want)
    JG.set_knn_impl("approx", approx_min_n=1)
    jax_idx = np.asarray(JG.knn_query(jnp.asarray(new_xyz), jnp.asarray(xyz), 8))
    np.testing.assert_array_equal(_sorted_distances(new_xyz, xyz, got),
                                  _sorted_distances(new_xyz, xyz, jax_idx))


def test_approx_knn_recall_knob_validated_and_stored():
    """The JAX package's ``ValueError``s; an accepted recall target is
    stored (the port's selection is exact whatever it is)."""
    for args, kw in ((("sorta",), {}), (("approx",), {"recall_target": 0.0}),
                     (("approx",), {"recall_target": 1.5})):
        for mod in (G, JG):
            with pytest.raises(ValueError):
                mod.set_knn_impl(*args, **kw)
    G.set_knn_impl("approx", recall_target=0.5)
    JG.set_knn_impl("approx", recall_target=0.5)
    assert G._KNN_RECALL == JG._KNN_RECALL == 0.5 and G._KNN_IMPL == JG._KNN_IMPL == "approx"


def test_set_knn_impl_is_atomic_on_failure():
    """A rejected call leaves the state as it was, in both packages."""
    for mod in (G, JG):
        assert mod._KNN_IMPL == "exact"
        with pytest.raises(ValueError):
            mod.set_knn_impl("approx", recall_target=1.5)
        assert mod._KNN_IMPL == "exact" and mod._KNN_RECALL == 0.95
        with pytest.raises(ValueError):
            mod.set_knn_impl("approx", approx_min_n=0)
        assert mod._KNN_IMPL == "exact" and mod._KNN_APPROX_MIN_N == 4096


def test_approx_sample_and_group_matches_jax():
    """``sample_and_group`` under approx (the fused grouping skipped, as the
    JAX dispatch skips it): the centroids equal, each centroid's neighbour
    set and sorted distances the JAX path's, and every grouped row the
    cloud's point (and features) of the port's own indices, centred."""
    B, N, S, Kn, D = 2, 256, 32, 8, 5
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    JG.set_knn_impl("approx", approx_min_n=1)
    jnew, jgrouped = JG.sample_and_group(jnp.asarray(xyz), jnp.asarray(feats), S, Kn,
                                         sampling="first", grouping="knn")
    jidx = np.asarray(JG.knn_query(jnew, jnp.asarray(xyz), Kn))
    G.set_knn_impl("approx", approx_min_n=1)
    with mock.patch.object(K, "sa_group", wraps=K.sa_group) as fused:
        new, grouped = G.sample_and_group(torch.from_numpy(xyz), torch.from_numpy(feats), S, Kn,
                                          sampling="first")
    assert fused.call_count == 0
    assert grouped.shape == (B, S, Kn, 3 + D)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    idx = G.knn_indices(new, torch.from_numpy(xyz), Kn)
    assert _recall(jidx, idx.numpy()) == 1.0
    np.testing.assert_array_equal(_sorted_distances(new.numpy(), xyz, idx.numpy()),
                                  _sorted_distances(new.numpy(), xyz, jidx))
    want = G.index_points(torch.from_numpy(xyz), idx) - new[:, :, None, :]
    assert torch.equal(grouped[..., :3], want)
    assert torch.equal(grouped[..., 3:], G.index_points(torch.from_numpy(feats), idx))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(jgrouped), atol=1e-6)


def test_approx_threshold_keeps_small_stages_exact():
    """Stages with fewer than ``approx_min_n`` candidates take the exact
    path: the fused grouping, no ``topk_min``."""
    xyz = _cloud(4, b=1)
    G.set_knn_impl("approx", approx_min_n=4096)
    with mock.patch.object(K, "topk_min", wraps=K.topk_min) as sel, \
            mock.patch.object(K, "sa_group", wraps=K.sa_group) as fused:
        G.sample_and_group(torch.from_numpy(xyz), None, 32, 8, sampling="first")
    assert sel.call_count == 0 and fused.call_count == 1
    assert not G.approx_eligible(512) and G.approx_eligible(4096)


def test_exact_default_unchanged_by_knob_roundtrip():
    xyz = torch.from_numpy(_cloud(3, b=1, n=300))
    before = G.knn_indices(xyz[:, :16], xyz, 8)
    G.set_knn_impl("approx", approx_min_n=1)
    G.set_knn_impl("exact")
    assert torch.equal(G.knn_indices(xyz[:, :16], xyz, 8), before)


_ENV_PROBE = """
import importlib.util, json, os, sys
path = os.path.join("pointcloud_orientation_tpu_torch", "ops", "geometry.py")
for i, env in enumerate(json.loads(sys.argv[1])):
    for k in [k for k in os.environ if k.startswith("PCOT_KNN")]:
        del os.environ[k]
    os.environ.update(env)
    spec = importlib.util.spec_from_file_location(f"geometry_{i}", path)
    G = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(G)
        print(G._KNN_IMPL, G._KNN_RECALL)
    except ValueError as e:
        print(type(e).__name__, e)
"""


def test_env_knob_validated_at_import():
    """``PCOT_KNN=Approx`` fails the import, ``PCOT_KNN=approx`` with a bad
    ``PCOT_KNN_RECALL`` too, and a good one is the dispatch with its
    recall target (the module imported afresh for each, in one subprocess
    on one thread)."""
    envs = [{"PCOT_KNN": "Approx"}, {"PCOT_KNN": "approx", "PCOT_KNN_RECALL": "1.5"},
            {"PCOT_KNN": "approx", "PCOT_KNN_RECALL": "0.9"}]
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PCOT_KNN") and k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _ENV_PROBE, json.dumps(envs)], cwd=REPO,
                       env={**base, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == ["ValueError bad knn impl: Approx",
                                     "ValueError bad recall_target: 1.5", "approx 0.9"]


def test_pointnet_pp_8dir_under_approx_matches_jax_under_approx():
    """The 8-dir model with sa1 on the approx dispatch (approx_min_n lowered
    to 256, N=512; sa2's 128 points stay on the fused grouping) against the
    JAX model under its approx dispatch, the same flax variables: logits
    within 1e-4, one ``topk_min`` call a forward."""
    clouds = np.random.default_rng(5).uniform(-1, 1, size=(2, 512, 3)).astype(np.float32)
    v = random_flax_variables(5)
    JG.set_knn_impl("approx", approx_min_n=256)
    want = np.asarray(jax.jit(lambda c: JaxPointNetPP8Dir(sampling="first").apply(v, c))(
        jnp.asarray(clouds)))
    G.set_knn_impl("approx", approx_min_n=256)
    model = load_flax_variables(PointNetPP8Dir(sampling="first"), v).eval()
    with torch.no_grad(), mock.patch.object(K, "topk_min", wraps=K.topk_min) as sel:
        got = model(torch.from_numpy(clouds)).numpy()
    assert sel.call_count == 1  # sa1 only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
