"""The FPS kernel's cluster merge on the CPU: csrc/fps.cu splits a cloud
over a thread-block cluster, takes each block's argmax over its slice and
merges the blocks' winner records, read in no fixed order, by the rule of
``key_greater`` (the larger distance, equal distances to the lower index).
Emulated here step by step in plain PyTorch, with the slices merged in a
shuffled order every step, and held index for index against ``fps_pallas``
in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops import pallas_kernels as JP

INT_MAX = 2 ** 31 - 1


def _cloud(rng, B, N, case, slices):
    """``(B, N, 3)`` points in the unit ball. "tiled": a quarter of them
    cycled to N (exact ties everywhere); "edges": random, but the first
    point of every slice repeats the last point of the slice before (ties
    across slice edges) and the last slice repeats the first point."""
    n = max(1, N // 4) if case == "tiled" else N
    x = rng.normal(size=(B, n, 3))
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    x = np.ascontiguousarray(np.tile(x, (1, -(-N // n), 1))[:, :N])
    if case == "edges":
        size = -(-N // slices)
        for lo in range(size, N, size):
            x[:, lo] = x[:, lo - 1]
        x[:, -1] = x[:, 0]
    return x.astype(np.float32)


def _key_greater(d, i, od, oi):
    return (d > od) | ((d == od) & (i < oi))


def _fps_cluster(xyz, seeds, npoint, slices, order_rng):
    """FPS as the cluster kernel runs it: the difference-form distances and
    running minima of ``fps_plain``; each step, every slice's winner (its
    largest running minimum, the lowest index among equal ones), merged in
    a shuffled order by ``_key_greater``. An empty slice offers (-inf,
    INT_MAX)."""
    B, N, _ = xyz.shape
    size = -(-N // slices)
    bounds = [(r * size, min(N, (r + 1) * size)) for r in range(slices)]
    batch = torch.arange(B)
    far = seeds.long().clamp(0, N - 1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32)
    out = torch.empty((B, npoint), dtype=torch.int64)
    for it in range(npoint):
        out[:, it] = far
        if it + 1 == npoint:
            break
        diff = xyz - xyz[batch, far][:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        dist = torch.minimum(dist, d)
        records = []
        for lo, hi in bounds:
            if hi <= lo:
                records.append((torch.full((B,), -np.inf), torch.full((B,), INT_MAX)))
                continue
            j = torch.argmax(dist[:, lo:hi], dim=-1)  # the first of equal maxima
            records.append((dist[batch, lo + j], lo + j))
        order = order_rng.permutation(slices)
        best_d, best_i = records[order[0]]
        for r in order[1:]:
            d_r, i_r = records[r]
            take = _key_greater(d_r, i_r, best_d, best_i)
            best_d, best_i = torch.where(take, d_r, best_d), torch.where(take, i_r, best_i)
        far = best_i
    return out.to(torch.int32)


@pytest.mark.parametrize("case", ["random", "tiled", "edges"])
@pytest.mark.parametrize("slices", [1, 2, 7, 16])
def test_fps_cluster_merge_equals_fps_pallas(rng, slices, case):
    """B=2, N=1,000 (ragged slices for 7 and 16), npoint=128, random start
    seeds: exact indices, ties included."""
    B, N, npoint = 2, 1000, 128
    xyz = _cloud(rng, B, N, case, slices)
    seeds = rng.integers(0, N, B).astype(np.int32)
    want = np.asarray(JP.fps_pallas(jnp.asarray(xyz), npoint, seeds=jnp.asarray(seeds),
                                    interpret=True))
    got = _fps_cluster(torch.from_numpy(xyz), torch.from_numpy(seeds), npoint, slices,
                       np.random.default_rng(slices))
    np.testing.assert_array_equal(got.numpy(), want)
