"""The plain versions of the port's index kernels (FPS, ball query, kNN; CPU)
against the JAX package's Pallas kernels in interpret mode, bit for bit; the
port's grouping dispatch by cloud size; and the port's 8-dir model above
the fused grouping's size against the JAX model routed as on the TPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu.ops import geometry as JG
from pointcloud_orientation_tpu.ops import pallas_kernels as JP
from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as TG
from pointcloud_orientation_tpu_torch.utils import load_flax_variables, random_flax_variables


def _cloud(rng, B, N, tiled=False):
    """``(B, N, 3)`` points scaled into the unit ball; ``tiled``: a quarter
    of them cycled to N, so distances tie exactly."""
    n = max(1, N // 4) if tiled else N
    x = rng.normal(size=(B, n, 3))
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    return np.ascontiguousarray(np.tile(x, (1, -(-N // n), 1))[:, :N]).astype(np.float32)


def _centroids(rng, xyz, S):
    return np.stack([c[rng.permutation(len(c))[:S]] for c in xyz]).astype(np.float32)


def _counting(monkeypatch, names, calls):
    """Wrap the port's kernel wrappers so that each call is recorded."""
    for name in names:
        fn = getattr(K, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, wrapped)


@pytest.mark.parametrize("case", ["random", "tiled", "seeds", "npoint>N"])
def test_fps_plain_equals_fps_pallas(rng, case):
    """Exact indices: the classifier's sa1 shape (B=2, N=1024, npoint=512),
    on random and tiled clouds, from index 0 and from random start seeds;
    and more samples than points."""
    B, N, npoint = (2, 40, 48) if case == "npoint>N" else (2, 1024, 512)
    xyz = _cloud(rng, B, N, tiled=case == "tiled")
    seeds = (rng.integers(1, N, B) if case == "seeds" else np.zeros(B)).astype(np.int32)
    want = np.asarray(JP.fps_pallas(jnp.asarray(xyz), npoint, seeds=jnp.asarray(seeds),
                                    interpret=True))
    got = K.fps(torch.from_numpy(xyz), torch.from_numpy(seeds), npoint)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "random":  # the XLA formulation the TPU runs below 1,024 points agrees too
        JG.set_pallas_mode("never")
        try:
            xla = np.asarray(JG.farthest_point_sample(jnp.asarray(xyz), npoint))
        finally:
            JG.set_pallas_mode("auto")
        np.testing.assert_array_equal(got.numpy(), xla)


@pytest.mark.parametrize("case", ["random", "tiled", "empty", "few", "sa2", "K>N"])
def test_ball_query_plain_equals_ball_query_pallas(rng, case):
    """Exact indices at the classifier's sa1 (S=512, N=1024, K=32, r=0.2)
    and sa2 (S=128, N=512, K=64, r=0.4) shapes: random and tiled clouds,
    centroids with no point in the radius (N - 1 everywhere), a radius with
    fewer points than slots (padded with the first), more slots than
    points."""
    B, S, N, Kn, radius = {"sa2": (2, 128, 512, 64, 0.4), "K>N": (2, 7, 50, 80, 0.5),
                           "few": (2, 512, 1024, 32, 0.05)}.get(case, (2, 512, 1024, 32, 0.2))
    xyz = _cloud(rng, B, N, tiled=case == "tiled")
    new_xyz = _centroids(rng, xyz, S)
    if case == "empty":
        new_xyz[:, :5] = 3.0
    want = np.asarray(JP.ball_query_pallas(radius, Kn, jnp.asarray(xyz), jnp.asarray(new_xyz),
                                           interpret=True))
    got = K.ball_query(torch.from_numpy(new_xyz), torch.from_numpy(xyz), radius, Kn)
    assert got.dtype == torch.int32 and got.shape == (B, S, Kn)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty":
        assert (got[:, :5] == N - 1).all()
    if case in ("few", "K>N"):  # short rows end in copies of their first index
        assert (got[..., -1] == got[..., 0]).any()


@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
def test_knn_plain_equals_knn_pallas_above_the_fused_size(rng, tiled):
    """Exact indices just above the fused grouping's 10,240 points, where
    the JAX package runs ``knn_pallas`` on the TPU: difference-form
    distances, nearest first, ties to the lowest index."""
    B, S, N, Kn = 2, 64, 10_300, 32
    xyz = _cloud(rng, B, N, tiled=tiled)
    new_xyz = _centroids(rng, xyz, S)
    want = np.asarray(JP.knn_pallas(jnp.asarray(new_xyz), jnp.asarray(xyz), Kn, interpret=True))
    got = K.knn(torch.from_numpy(new_xyz), torch.from_numpy(xyz), Kn)
    assert got.dtype == torch.int32 and got.shape == (B, S, Kn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_index_wrappers_count_nothing_on_the_cpu_and_check_types(rng):
    K.reset_launch_counts()
    xyz = torch.from_numpy(_cloud(rng, 1, 64))
    K.fps(xyz, torch.zeros((1,), dtype=torch.int32), 8)
    K.ball_query(xyz[:, :8], xyz, 0.3, 4)
    K.knn(xyz[:, :8], xyz, 4)
    assert K.launch_counts() == {"sa_group": 0, "sa_mlp_max": 0, "sa_group_scatter": 0,
                                 "sa_mlp_max_bwd": 0, "knn": 0, "fps": 0, "ball_query": 0,
                                 "sa_mlp_max_bf16": 0, "sa_mlp_max_bwd_bf16": 0,
                                 "topk_min": 0}
    with pytest.raises(TypeError):
        K.fps(xyz.double(), torch.zeros((1,), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        K.knn(xyz[:, :8, :2], xyz, 4)
    with pytest.raises(ValueError):  # a device that is neither cpu nor cuda
        K.ball_query(xyz[:, :8].to("meta"), xyz.to("meta"), 0.3, 4)
    # the squared radius as JAX forms it: squared in double, compared in f32
    assert K.radius_sq_f32(0.2) == float(np.float32(0.2 ** 2))


@pytest.mark.parametrize("n,sampling,grouping,path", [
    (1024, "first", "knn", ["sa_group"]),
    (10_240, "first", "knn", ["sa_group"]),
    (10_241, "first", "knn", ["knn"]),
    (20_480, "first", "knn", ["knn"]),
    (20_481, "first", "knn", []),
    (1024, "fps", "ball", ["fps", "ball_query"]),
], ids=["1024", "10240", "10241", "20480", "20481-sort", "fps-ball"])
def test_sample_and_group_dispatches_by_cloud_size(monkeypatch, n, sampling, grouping, path):
    """kNN grouping as the JAX package dispatches it on the TPU: the fused
    grouping kernel up to 10,240 points, the kNN kernel and gathers up to
    20,480, a sort of the matmul-form distances above; FPS and the ball
    query through their kernels."""
    calls = []
    _counting(monkeypatch, ("sa_group", "knn", "fps", "ball_query"), calls)
    xyz = torch.randn((1, n, 3), generator=torch.Generator().manual_seed(n))
    new_xyz, grouped = TG.sample_and_group(xyz, None, 8, 4, sampling=sampling,
                                           grouping=grouping, radius=0.5, neighbor_major=True)
    assert calls == path
    assert new_xyz.shape == (1, 8, 3) and grouped.shape == (1, 4, 8, 3)
    # every centroid is its own nearest neighbour (and its own first in-radius
    # point is found no later than itself, at distance 0)
    if grouping == "knn":
        assert not grouped[:, 0].any()
    if sampling == "first" and n > TG.FUSED_GROUP_MAX_N:
        idx = TG.knn_query(new_xyz, xyz, 4) if n > TG.KNN_KERNEL_MAX_N \
            else K.knn_plain(new_xyz, xyz, 4)
        want = TG.index_points(xyz, idx) - new_xyz[:, :, None]
        torch.testing.assert_close(grouped.transpose(1, 2), want, rtol=0, atol=0)


def test_pointnet_pp_8dir_above_the_fused_size_matches_jax_routed_as_on_tpu(rng, monkeypatch):
    """N=12,288: the JAX model with the TPU's size rules for its kernels
    (sa1 through ``knn_pallas`` in interpret mode, sa2 through the fused
    grouping) against the port (sa1 through the kNN wrapper's plain
    version); logits within 1e-4 (the MLPs sum in another order)."""
    monkeypatch.setattr(JG, "_fused_group_eligible",
                        lambda n: 128 <= n <= JG._FUSED_GROUP_MAX_N)
    monkeypatch.setattr(JG, "_pallas_eligible", lambda n: 1024 <= n <= JG._PALLAS_KNN_MAX_N)
    jax_calls = []
    knn_pallas = JP.knn_pallas
    monkeypatch.setattr(JP, "knn_pallas",
                        lambda *a, **kw: (jax_calls.append(a[1].shape[1]), knn_pallas(*a, **kw))[1])
    v = random_flax_variables(3)
    x = rng.normal(size=(2, 12_288, 3)).astype(np.float32)
    want = np.asarray(JaxPointNetPP8Dir(sampling="first").apply(v, jnp.asarray(x), train=False))
    assert jax_calls == [12_288]
    calls = []
    _counting(monkeypatch, ("sa_group", "knn"), calls)
    model = load_flax_variables(PointNetPP8Dir(sampling="first"), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert calls == ["knn", "sa_group"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
