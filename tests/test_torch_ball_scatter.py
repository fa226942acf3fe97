"""The plain versions of the ball query and the grouping's scatter on the
edge inputs of their card kernels (CPU), against the JAX package.

The card kernels (``csrc/ball_query.cu``, ``csrc/sa_scatter.cu``) take
other paths at these edges: a cloud past one shared-memory tile (4,096
points), a scan split over a block's warps when the centroids are few, a
row past its 32-point group, a centroid whose radius is empty or holds every
point, more slots than points; rows with no slot or every slot, a row
stride above D and D off any multiple of 4 or 32. Each kernel is held
against its plain version on the card (``tests/test_torch_cuda.py``); here
the plain versions are held against JAX at the same inputs.

The ball query runs in the distance form the JAX package takes on the TPU
at that cloud size: ``ball_query_pallas`` (interpret mode) for 1024 <= N <=
20,480, bit for bit; its XLA path at every other N, with the port's cross
term rounded as XLA on the CPU rounds it (an FMA chain,
``test_torch_select_repairs.py``), so that the selection and the padding
are compared bit for bit and not the last bit of the cross term. On clouds
with points placed on the radius, XLA on the CPU also contracts some of the
interpret-mode kernel's multiply-adds, depending on how it fuses them (no
fixed rounding reproduces it at every size), so there every row where the
two differ must split on a point within a few eps of the radius; the card
kernels are held bit for bit to the plain versions on such clouds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops import geometry as JG
from pointcloud_orientation_tpu.ops import pallas_kernels as JP
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as TG


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _xla_cpu_square_distance(src, dst):
    """The matmul form as XLA on the CPU computes it: the cross term's
    products contracted into FMAs; the squared norms and the rest as
    ``geometry.square_distance``."""
    s, d = src[:, :, None, :], dst[:, None, :, :]
    cross = _fma(s[..., 2], d[..., 2], _fma(s[..., 1], d[..., 1], s[..., 0] * d[..., 0]))
    return (TG._sq_norm(src)[:, :, None] - 2.0 * cross) + TG._sq_norm(dst)[:, None, :]


def _cloud(rng, B, N, S, case, radius):
    """``(B, N, 3)`` points in the unit ball and ``(B, S, 3)`` centroids
    drawn from them; "empty": every centroid far from its cloud; "radius":
    a third of the points at ``radius * (1 + e)``, ``|e| <= 2e-6``, from a
    centroid, where the rounding decides whether they are inside."""
    x = rng.normal(size=(B, N, 3))
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    c = np.stack([p[rng.permutation(N)[:S]] for p in x])
    if case == "radius":
        n_near = N // 3
        owner = rng.integers(0, S, size=(B, n_near))
        u = rng.normal(size=(B, n_near, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        e = rng.uniform(-2e-6, 2e-6, size=(B, n_near, 1))
        at = rng.permutation(N)[:n_near]
        x[:, at] = np.take_along_axis(c, owner[..., None], axis=1) + radius * (1 + e) * u
    if case == "empty":
        c[:] = 3.0
    return x.astype(np.float32), np.ascontiguousarray(c).astype(np.float32)


# (B, S, N, K, radius, case): N past 32-point groups and past a tile, the
# split scan's few centroids over a large cloud and the staged path's many,
# every centroid empty, every point inside, points on the radius, more
# slots than points
BALL_EDGES = {
    "N=1000": (2, 64, 1000, 32, 0.2, "random"),
    "N=1056": (2, 64, 1056, 32, 0.2, "random"),
    "N=4097": (1, 16, 4097, 32, 0.1, "random"),
    "N=40000-split": (1, 16, 40_000, 32, 0.2, "random"),
    "N=65536-split": (1, 8, 65_536, 32, 0.1, "random"),
    "N=1024-staged": (4, 256, 1024, 32, 0.2, "random"),
    "empty-N=1024": (2, 32, 1024, 32, 0.2, "empty"),
    "empty-N=512": (2, 32, 512, 32, 0.2, "empty"),
    "empty-N=40000": (1, 8, 40_000, 32, 0.2, "empty"),
    "inside-N=2048": (2, 32, 2048, 32, 10.0, "random"),
    "inside-N=24576": (1, 16, 24_576, 64, 10.0, "random"),
    "radius-N=2048": (2, 64, 2048, 32, 0.2, "radius"),
    "radius-N=40000": (1, 16, 40_000, 32, 0.2, "radius"),
    "K>N-N=1024": (1, 4, 1024, 1100, 0.3, "random"),
}


def _split_readings(got, want, xyz, new_xyz, radius):
    """Per row where two ball queries differ, at the first slot that
    differs: the smaller of its two points' ``|d - r^2| / (eps * (|x|^2 +
    |c|^2))``, ``d`` the exact squared distance (a point that two roundings
    may put on either side reads a few units at most)."""
    x64, c64 = xyz.astype(np.float64), new_xyz.astype(np.float64)
    r2, eps = float(np.float32(radius)) ** 2, float(np.finfo(np.float32).eps)
    out = []
    for b, s in zip(*np.nonzero((got != want).any(-1))):
        j = int(np.argmax(got[b, s] != want[b, s]))
        out.append(min(abs(((x64[b, p] - c64[b, s]) ** 2).sum() - r2)
                       / (eps * ((x64[b, p] ** 2).sum() + (c64[b, s] ** 2).sum()))
                       for p in (got[b, s, j], want[b, s, j])))
    return out


@pytest.mark.parametrize("shape", list(BALL_EDGES.values()), ids=list(BALL_EDGES))
def test_ball_query_plain_equals_jax_on_the_kernel_edges(rng, monkeypatch, shape):
    B, S, N, Kn, radius, case = shape
    xyz, new_xyz = _cloud(rng, B, N, S, case, radius)
    tx, tn = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    matmul_form = TG.ball_query_matmul_form(N)
    if matmul_form:
        JG.set_pallas_mode("never")
        try:
            want = np.asarray(JG.ball_query(radius, Kn, jnp.asarray(xyz), jnp.asarray(new_xyz)))
        finally:
            JG.set_pallas_mode("auto")
        monkeypatch.setattr(TG, "square_distance", _xla_cpu_square_distance)
    else:
        want = np.asarray(JP.ball_query_pallas(radius, Kn, jnp.asarray(xyz),
                                               jnp.asarray(new_xyz), interpret=True))
    got = K.ball_query(tn, tx, radius, Kn, matmul_form)
    assert got.dtype == torch.int32 and got.shape == (B, S, Kn)
    if case == "radius":
        assert max(_split_readings(got.numpy(), want, xyz, new_xyz, radius), default=0.0) <= 4.0
        assert (got.numpy() != want).any(-1).mean() <= 0.05
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty":
        assert (got == N - 1).all()
    if radius >= 10.0:  # every point inside: the first Kn indices
        assert (got == torch.arange(Kn, dtype=torch.int32)).all()
    if Kn > N:  # the slots past the points hold copies of the first
        assert (got[..., N:] == got[..., :1]).all()


# (B, N, S, K, D, columns before the slice, case)
SCATTER_EDGES = {
    "rows-with-no-slot": (2, 64, 8, 8, 16, 0, "few"),
    "one-row-takes-every-slot": (2, 40, 8, 8, 20, 0, "one"),
    "row-stride>D": (2, 40, 8, 8, 64, 3, "random"),
    "D=7": (3, 13, 5, 7, 7, 0, "random"),
    "D=130-stride-133": (1, 37, 4, 16, 130, 3, "random"),
}


@pytest.mark.parametrize("shape", list(SCATTER_EDGES.values()), ids=list(SCATTER_EDGES))
def test_scatter_plain_matches_pallas_scatter_on_the_kernel_edges(rng, shape):
    """The cotangent read in place where it is a column slice; 1e-5, the
    Pallas contraction sums in another order. Rows with no slot are 0."""
    B, N, S, Kn, D, extra, case = shape
    if case == "one":
        idx = np.full((B, S, Kn), 5, dtype=np.int32)
    elif case == "few":
        idx = rng.integers(0, 3, size=(B, S, Kn)).astype(np.int32)
    else:
        idx = rng.integers(0, N, size=(B, S, Kn)).astype(np.int32)
    full = rng.normal(size=(B, Kn, S, extra + D)).astype(np.float32)
    dg = torch.from_numpy(full)[..., extra:]
    want = np.asarray(_pallas_scatter(idx, np.ascontiguousarray(full[..., extra:]), N))
    got = K.sa_group_scatter(torch.from_numpy(idx), dg, N)
    assert got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    untouched = np.setdiff1d(np.arange(N), idx)
    assert (got.numpy()[:, untouched] == 0).all()


def _pallas_scatter(idx, dg_kmajor, n):
    """The JAX package's scatter (interpret mode) on neighbour-major
    cotangents ``(B, K, S, D)``; it takes ``(B, S, K, D)``."""
    return JP._sa_scatter_call(jnp.asarray(idx), jnp.asarray(np.swapaxes(dg_kmajor, 1, 2)), n,
                               interpret=True)
