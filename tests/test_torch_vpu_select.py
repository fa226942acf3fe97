"""The selection micro-benchmarks' plain versions
(``pointcloud_orientation_tpu_torch.benchmarks.profile_vpu_select``) bit for
bit against the five Pallas kernels of the JAX package's
``benchmarks/profile_vpu_select.py``, run on the CPU in interpret mode.

The JAX file is loaded by path, unchanged; its kernels read the module
globals ``K`` (neighbours) and ``REPS`` (elementwise rounds), which the
tests set on the loaded copy. Shapes: B=2, S=8, N=256 (the count-and-emit
kernel emits in chunks of 256 lanes), K=6; and, for the two kernels whose
card designs change with N (``sel_mintie``, ``count_emit``), N from 1 to 512
(``sel_mintie`` also at N not a multiple of 32) with K=1 and K=N, on rows
with ``+inf`` runs, equal values, and -0.0 beside +0.0 and negative values.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, N, K = 2, 8, 256, 6
SELECT = {  # name: (port wrapper, the JAX kernel's name, its output rows)
    "sel_argmin": (PV.sel_argmin, "_sel_argmin_kernel", K),
    "sel_mintie": (PV.sel_mintie, "_sel_mintie_kernel", K),
    "radix_count": (PV.radix_count, "_radix_count_kernel", 1),
    "count_emit": (PV.count_emit, "_count_emit_kernel", K),
}
EW_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
             "int16": (jnp.int16, torch.int16)}


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_vpu_select", os.path.join(REPO, "benchmarks", "profile_vpu_select.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.K = K
    return mod


def _pallas_select(mod, kernel_name, rows, d: np.ndarray) -> np.ndarray:
    """The JAX file's selection kernel over d (B, S, N), as its ``sel``
    calls it, in interpret mode."""
    b, s, n = d.shape
    out = pl.pallas_call(
        getattr(mod, kernel_name), grid=(b,),
        in_specs=[pl.BlockSpec((None, s, n), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, rows, s), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, rows, s), jnp.int32),
        scratch_shapes=[pltpu.VMEM((s, n), jnp.float32)], interpret=True)(jnp.asarray(d))
    return np.asarray(out)


def _pallas_ew(mod, x: np.ndarray, dtype) -> np.ndarray:
    spec = pl.BlockSpec((None, S, N), lambda b: (b, 0, 0))
    out = pl.pallas_call(mod._ew_kernel, grid=(B,), in_specs=[spec], out_specs=spec,
                         out_shape=jax.ShapeDtypeStruct((B, S, N), dtype),
                         interpret=True)(jnp.asarray(x, dtype))
    return np.asarray(out.astype(jnp.float32) if dtype == jnp.bfloat16 else out)


def _distances(case: str, seed: int) -> np.ndarray:
    """Uniform distances in [0, 1) as the JAX file draws them; "ties": each
    row a quarter of its values cycled four times, as
    ``chip_smoke.unit_cloud(tiled=True)`` builds clouds, so every value
    occurs four times."""
    rng = np.random.default_rng(seed)
    if case == "ties":
        base = rng.uniform(size=(B, S, N // 4)).astype(np.float32)
        return np.tile(base, (1, 1, 4))
    return rng.uniform(size=(B, S, N)).astype(np.float32)


def _edge_rows(kind: str, n: int, seed: int) -> np.ndarray:
    """(B, S, n) rows of ``profile_vpu_select.ROW_KINDS``' kinds, drawn with
    numpy: "inf" runs of 7 +inf in every 21 entries, "equal" every entry
    0.5, "signed" uniform in (-1, 1) with a quarter -0.0 and a quarter
    +0.0, "ties" and "random" as ``_distances``."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        base = rng.uniform(size=(B, S, max(1, n // 4))).astype(np.float32)
        return np.tile(base, (1, 1, -(-n // base.shape[-1])))[..., :n].copy()
    if kind == "equal":
        return np.full((B, S, n), 0.5, np.float32)
    d = rng.uniform(size=(B, S, n)).astype(np.float32)
    if kind == "inf":
        d[..., np.arange(n) // 7 % 3 == 0] = np.inf
    elif kind == "signed":
        zero = rng.integers(0, 4, size=d.shape)
        d = np.where(zero == 0, np.float32(-0.0),
                     np.where(zero == 1, np.float32(0.0), 2 * d - 1)).astype(np.float32)
    return d


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("reps", [3, 32], ids=["reps3-finite", "reps32-overflow"])
@pytest.mark.parametrize("dtype", sorted(EW_DTYPES))
def test_ew_plain_bit_equal_to_pallas(jax_bench, monkeypatch, dtype, reps):
    jdt, tdt = EW_DTYPES[dtype]
    rng = np.random.default_rng(1)
    if dtype == "int16":
        x = rng.integers(-2 ** 15, 2 ** 15, size=(B, S, N)).astype(np.int16)
        xt = torch.from_numpy(x)
    else:
        x = rng.normal(size=(B, S, N)).astype(np.float32)
        xt = torch.from_numpy(x).to(tdt)
        if dtype == "bfloat16":
            x = xt.float().numpy()  # the same bf16 values on both sides
    monkeypatch.setattr(jax_bench, "REPS", reps)
    want = _pallas_ew(jax_bench, x, jdt)
    got = PV.ew(xt, reps)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, N)
    got = (got.float() if dtype == "bfloat16" else got).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    if dtype != "int16":  # 3 rounds stay finite; 32 overflow nearly every lane to inf
        finite = np.isfinite(want).mean()
        assert finite == 1.0 if reps == 3 else finite < 0.01
    else:  # 32 rounds wrap: the values are not the integers' squares
        assert reps == 3 or np.abs(want.astype(np.int64)).max() < 2 ** 15


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("name", sorted(SELECT))
def test_selection_plain_bit_equal_to_pallas(jax_bench, name, case):
    wrapper, kernel_name, rows = SELECT[name]
    d = _distances(case, seed=2)
    want = _pallas_select(jax_bench, kernel_name, rows, d)
    got = wrapper(torch.from_numpy(d.copy()), K)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, rows, S)
    assert np.array_equal(got.numpy(), want)


# (N, K) of the edge rows: K=1 and K=N; for sel_mintie N not a multiple of
# 32. The JAX file's count-and-emit kernel takes N in whole 256-lane chunks
# of its emission (or N=1), so its edge rows are those
EDGE_SHAPES = {"sel_mintie": {"N=1": (1, 1), "N=31-K=1": (31, 1), "N=31-K=N": (31, 31),
                              "N=33-K=1": (33, 1), "N=33-K=N": (33, 33), "N=70-K=6": (70, 6)},
               "count_emit": {"N=1": (1, 1), "N=256-K=1": (256, 1), "N=256-K=N": (256, 256),
                              "N=512-K=40": (512, 40)}}


@pytest.mark.parametrize("kind", ["random", "ties", "inf", "equal", "signed"])
@pytest.mark.parametrize("name,case", [(name, case) for name, cases in EDGE_SHAPES.items()
                                       for case in cases])
def test_edge_rows_plain_bit_equal_to_pallas(jax_bench, monkeypatch, name, case, kind):
    """The semantics the card's kernels reproduce: past the finite entries
    sel_mintie takes the lowest +inf lane again and -0.0 ties with +0.0;
    count_emit orders the int32 bit patterns, so -0.0 and negative values
    lie below every other entry."""
    wrapper, kernel_name, _ = SELECT[name]
    n, k = EDGE_SHAPES[name][case]
    monkeypatch.setattr(jax_bench, "K", k)
    d = _edge_rows(kind, n, seed=4)
    want = _pallas_select(jax_bench, kernel_name, k, d)
    got = wrapper(torch.from_numpy(d.copy()), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, k, S)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", PV.ROW_KINDS)
def test_select_rows_build_the_rows_the_card_checks_use(kind):
    """``select_rows``, which ``chip_smoke.py`` and the card tests draw
    their rows from, gives each kind's edge: +inf runs, one value, -0.0
    beside +0.0 and negatives, repeats."""
    d = PV.select_rows(kind, (2, 3, 50), torch.Generator().manual_seed(5))
    assert d.dtype == torch.float32 and tuple(d.shape) == (2, 3, 50) and d.is_contiguous()
    bits = d.view(torch.int32)
    has = {"inf": bool(torch.isinf(d).any()), "negative": bool((bits < 0).any()),
           "one value": bool((d == d[..., :1]).all()),
           "repeats": bool((d[..., :12] == d[..., 12:24]).all())}
    want = {"inf": kind == "inf", "negative": kind == "signed", "one value": kind == "equal",
            "repeats": kind in ("ties", "equal")}
    assert has == want
    if kind == "signed":  # -0.0 beside +0.0: equal floats, bit patterns apart
        assert bool((bits == -2 ** 31).any()) and bool((bits == 0).any())
    if kind == "inf":
        assert torch.isinf(d[..., :7]).all() and not torch.isinf(d[..., 7:21]).any()


@pytest.mark.parametrize("case", ["random", "ties"])
def test_selections_agree_with_sort_kthvalue_and_sets(case):
    """What each selection means: the K-pass kernels give the stable sort's
    first K (nearest first, lowest lane on ties), the radix count the K-th
    smallest value's bits, count-and-emit the same set in ascending lane
    order."""
    d = torch.from_numpy(_distances(case, seed=3))
    first_k = torch.sort(d, dim=-1, stable=True).indices[..., :K].transpose(1, 2).to(torch.int32)
    assert torch.equal(PV.sel_argmin(d, K), first_k)
    assert torch.equal(PV.sel_mintie(d, K), first_k)
    kth = torch.kthvalue(d, K, dim=-1).values.view(torch.int32)[:, None, :]
    assert torch.equal(PV.radix_count(d, K), kth)
    emitted = PV.count_emit(d, K)
    assert torch.equal(emitted, first_k.sort(dim=1).values)
    assert bool((emitted[:, 1:] > emitted[:, :-1]).all())


def test_k_pass_plains_pick_the_lowest_inf_lane_again_past_the_finite_entries():
    """The TPU kernels mask a winner with +inf, so once a row's finite
    entries are taken every pass picks its lowest +inf lane, already taken
    or not; the kernels on the card do the same."""
    d = torch.tensor([[[float("inf"), float("inf"), 1.0, 0.5]]])
    for fn in (PV.sel_argmin, PV.sel_mintie):
        assert fn(d, 4)[0, :, 0].tolist() == [3, 2, 0, 0]


def test_wrappers_take_the_plain_versions_on_cpu_and_count_no_launch():
    PV.reset_launch_counts()
    d = torch.rand((1, 2, 40))
    for wrapper, _, rows in SELECT.values():
        one_row = rows == 1  # radix_count: (B, 1, S) whatever K
        assert tuple(wrapper(d, 40).shape) == (1, 1 if one_row else 40, 2)  # K = N
        assert tuple(wrapper(d, 1).shape) == (1, 1, 2)
    PV.ew(torch.ones(3, dtype=torch.bfloat16))
    assert set(PV.launch_counts().values()) == {0}
    assert set(PV.launch_counts()) == {"ew", "sel_argmin", "sel_mintie", "radix_count",
                                       "count_emit"}


def test_wrappers_raise_on_what_they_do_not_take():
    d = torch.rand((1, 2, 40))
    with pytest.raises(TypeError):
        PV.sel_argmin(d.double(), 3)
    with pytest.raises(ValueError):
        PV.count_emit(d, 41)
    with pytest.raises(ValueError):
        PV.radix_count(d[0], 3)
    with pytest.raises(TypeError):
        PV.ew(torch.ones(3, dtype=torch.float16))


def test_cost_counts_bytes_once_and_the_ops_of_a_round():
    elems = 64 * 128 * 1024
    nbytes, ops = PV.cost("ew", 64, 128, 1024, dtype=torch.bfloat16)
    assert nbytes == 2 * 2 * elems and ops == {"bf16_vector_flops": 96 * elems}
    nbytes, ops = PV.cost("ew", 64, 128, 1024, dtype=torch.int16)
    assert nbytes == 2 * 2 * elems and ops == {"flops": 96 * elems}
    nbytes, ops = PV.cost("radix_count", 64, 128, 1024, 32)
    assert nbytes == 4 * (elems + 64 * 128) and ops == {"flops": elems}
    assert PV.bound("sel_argmin", 64, 128, 1024, 32)[1] == "bytes"
    # bf16 arithmetic at the card's non-tensor bf16 rate (twice f32's): the
    # bytes bound it, 33.5 MB at 3.35 TB/s
    b_ms, by = PV.bound("ew", 64, 128, 1024, dtype=torch.bfloat16)
    assert by == "bytes" and b_ms == pytest.approx(4 * elems / 3.35e12 * 1e3)
    assert PV.bound("ew", 64, 128, 1024, dtype=torch.int16)[1] == "operations"
