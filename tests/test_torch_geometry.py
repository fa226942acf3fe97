"""The port's geometry and grouping (plain versions, CPU) against the JAX
package: the fused grouping kernel in interpret mode and the XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops import dirs8 as jdirs8
from pointcloud_orientation_tpu.ops import geometry as JG
from pointcloud_orientation_tpu.ops.pallas_kernels import (
    sa_group_coords_pallas,
    sa_group_feats_pallas,
)
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import dirs8 as tdirs8
from pointcloud_orientation_tpu_torch.ops import geometry as TG

B, N, S, KN, D = 2, 256, 32, 16, 16


def _cloud(rng, tiled: bool) -> np.ndarray:
    """A random cloud, or one made as the predictor pads a short cloud:
    64 points cycled to N, so every distance is tied four ways."""
    if tiled:
        base = rng.normal(size=(B, 64, 3)).astype(np.float32)
        return np.ascontiguousarray(np.tile(base, (1, N // 64, 1)))
    return rng.normal(size=(B, N, 3)).astype(np.float32)


def _assert_same_neighbours(idx_port, idx_jax, grouped_port, grouped_jax, xyz, new_xyz,
                            exact: bool):
    """idx equal exactly, or (where not ``exact``) each differing slot picks a
    point at the same distance to 1e-6 relative; grouped equal to 1e-6
    wherever the indices agree. grouped is (B, S, K, C) here."""
    idx_port, idx_jax = np.asarray(idx_port), np.asarray(idx_jax)
    if exact:
        np.testing.assert_array_equal(idx_port, idx_jax)
    diff = idx_port != idx_jax
    if diff.any():
        x = xyz.astype(np.float64)
        c = np.asarray(new_xyz, np.float64)
        bb, ss, _ = np.nonzero(diff)
        d_port = np.sum((x[bb, idx_port[diff]] - c[bb, ss]) ** 2, -1)
        d_jax = np.sum((x[bb, idx_jax[diff]] - c[bb, ss]) ** 2, -1)
        np.testing.assert_allclose(d_port, d_jax, rtol=1e-6)
    same = ~diff
    np.testing.assert_allclose(np.asarray(grouped_port)[same], np.asarray(grouped_jax)[same],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("with_feats", [False, True], ids=["coords", "feats"])
def test_sa_group_matches_jax_fused_kernel(rng, tiled, with_feats):
    xyz = _cloud(rng, tiled)
    feats = rng.normal(size=(B, N, D)).astype(np.float32) if with_feats else None
    cidx = np.stack([rng.choice(N, S, replace=False) for _ in range(B)]).astype(np.int32)
    if with_feats:
        j_new, j_grouped, j_idx = sa_group_feats_pallas(
            jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(cidx), KN, True)
    else:
        j_new, j_grouped, j_idx = sa_group_coords_pallas(
            jnp.asarray(xyz), jnp.asarray(cidx), KN, interpret=True)
    t_new, t_grouped, t_idx = K.sa_group(
        torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats),
        torch.from_numpy(cidx), KN)
    assert t_grouped.shape == (B, KN, S, 3 + (D if with_feats else 0))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    _assert_same_neighbours(t_idx.numpy(), j_idx, t_grouped.transpose(1, 2).numpy(),
                            j_grouped, xyz, j_new, exact=tiled)


@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("with_feats", [False, True], ids=["coords", "feats"])
def test_sample_and_group_matches_jax_xla_path(rng, tiled, with_feats):
    """sampling='first' on both sides; the JAX side runs its XLA path
    (matmul-form distances + top_k) under the 'never' Pallas mode."""
    xyz = _cloud(rng, tiled)
    feats = rng.normal(size=(B, N, D)).astype(np.float32) if with_feats else None
    JG.set_pallas_mode("never")
    try:
        j_new, j_grouped = JG.sample_and_group(
            jnp.asarray(xyz), None if feats is None else jnp.asarray(feats), S, KN,
            sampling="first")
        j_idx = JG.knn_query(j_new, jnp.asarray(xyz), KN)
    finally:
        JG.set_pallas_mode("auto")
    t_new, t_grouped = TG.sample_and_group(
        torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats), S, KN,
        sampling="first")
    t_idx = TG.knn_query(t_new, torch.from_numpy(xyz), KN)
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    _assert_same_neighbours(t_idx.numpy(), j_idx, t_grouped.numpy(), j_grouped, xyz, j_new,
                            exact=tiled)
    _, t_nm = TG.sample_and_group(
        torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats), S, KN,
        sampling="first", neighbor_major=True)
    np.testing.assert_array_equal(t_nm.numpy(), t_grouped.transpose(1, 2).numpy())


def test_square_distance_matches_jax(rng):
    a = rng.normal(size=(2, 17, 3)).astype(np.float32)
    b = rng.normal(size=(2, 40, 3)).astype(np.float32)
    want = np.asarray(JG.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = TG.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_knn_query_is_nearest_first_with_lowest_index_ties():
    xyz = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 2, 0], [1, 0, 0]]])
    idx = TG.knn_query(xyz[:, :1], xyz, 4)
    assert idx.tolist() == [[[0, 1, 2, 4]]]


def test_index_points_matches_jax(rng):
    pts = rng.normal(size=(2, 30, 5)).astype(np.float32)
    for shape in ((2, 7), (2, 7, 4)):
        idx = rng.integers(0, 30, size=shape).astype(np.int32)
        want = np.asarray(JG.index_points(jnp.asarray(pts), jnp.asarray(idx)))
        got = TG.index_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got, want)


def test_topk_of_uniform_matches_lax_top_k(rng):
    # values on a coarse grid, so that rows hold many exact ties
    u = (rng.integers(0, 50, size=(3, 400)) / 64.0).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(u), 128)
    got = TG.topk_of_uniform(torch.from_numpy(u), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_sample_indices_are_distinct_and_seeded():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return TG.random_sample_indices(g, 3, 500, 128, "cpu")

    a = draw(7)
    assert a.shape == (3, 128)
    assert all(len(set(row.tolist())) == 128 for row in a)
    assert int(a.min()) >= 0 and int(a.max()) < 500
    assert torch.equal(a, draw(7))
    assert not torch.equal(a, draw(8))


def test_group_all_matches_jax(rng):
    xyz = rng.normal(size=(2, 12, 3)).astype(np.float32)
    pts = rng.normal(size=(2, 12, 6)).astype(np.float32)
    for p in (None, pts):
        j_new, j_g = JG.group_all(jnp.asarray(xyz), None if p is None else jnp.asarray(p))
        t_new, t_g = TG.group_all(torch.from_numpy(xyz), None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
        np.testing.assert_array_equal(t_g.numpy(), np.asarray(j_g))


@pytest.mark.parametrize("kwargs", [{"sampling": "grid"}, {"grouping": "radius"},
                                    {"sampling": "random"}])
def test_sample_and_group_refuses_what_is_not_ported(kwargs):
    """Modes the JAX package does not have either (FPS and the ball query
    are ported), and random sampling without a generator."""
    xyz = torch.zeros((1, 64, 3))
    with pytest.raises((NotImplementedError, ValueError)):
        TG.sample_and_group(xyz, None, 8, 4, **kwargs)  # random: no generator given


def test_forward_to_8dir_probs_matches_jax(rng):
    fwd = rng.normal(size=(10, 3)).astype(np.float32)
    fwd[0] = [0.0, 1.0, 0.0]  # straight up: no horizontal response, uniform
    want = np.asarray(jdirs8.forward_to_8dir_probs(jnp.asarray(fwd)))
    got = tdirs8.forward_to_8dir_probs(torch.from_numpy(fwd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tdirs8.DIRS_8.numpy(), np.asarray(jdirs8.DIRS_8))
