"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's on the CPU: the library function that the point transformer's
``attention_impl="flash"`` calls (``jax.experimental.pallas.ops.tpu.
flash_attention``: its forward with the row statistics ``l`` and ``m``,
and its VJP through the dK/dV and dQ kernels), run in interpret mode
(``pltpu.force_tpu_interpret_mode()``; nothing in the JAX package changes),
and ``_flash_attention_fn``'s layout and casts. On CPU tensors the kernel
wrappers run these plain versions; the CUDA kernels are held against them
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Tolerances, from the readings at these sizes (B=2, H=4, D=16): in f32 the
two sum in other orders and lay at most 5.4e-7 apart on outputs of order 1,
so 2e-6 (o, dq, dk, dv; l relative 1e-6, m 1e-6); in bf16 they lay one bf16
step apart at most (0.0039 below 1: at N=128 the library divides p by l
before rounding it to bf16, the tiled form after), so 8e-3, two steps of
values below 1 and one of values up to 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as LIB

from pointcloud_orientation_tpu.models.point_transformer import (
    _flash_attention_fn as jax_flash_attention_fn,
)
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import flash_attention as FA

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-6, "bf16": 8e-3}
STAT_TOL = 1e-6  # l relative, m absolute, in both types (f32 statistics)
B, H = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, n, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, n, d)).astype(np.float32) for _ in range(4)]


_JAX = {}


def _awaited(x):
    """``x`` once computed. The library's kernels run in interpret mode
    through callbacks that dispatch JAX operations; an eager call, or a
    call dispatched while another still runs, can deadlock with them, so
    every JAX call here is jitted and awaited before the next."""
    return jax.block_until_ready(x)


def _library(dt, n, d=16, seed=0):
    """The library's forward residuals (o, l, m) and its VJP (dq, dk, dv) on
    the seeded inputs, in interpret mode, as f32 numpy; cached."""
    key = (dt, n, d, seed)
    if key not in _JAX:
        q, k, v, do = (jnp.asarray(a, DTYPES[dt][0]) for a in _inputs(seed, n, d))
        scale = 1.0 / d ** 0.5
        blocks = LIB.BlockSizes.get_default(B, H, n, n, d)
        fwd = jax.jit(lambda q, k, v: LIB._flash_attention(q, k, v, None, None, True, False,
                                                            scale, blocks, False))
        bwd = jax.jit(lambda q, k, v, do: jax.vjp(
            lambda a, b, c: LIB.flash_attention(a, b, c, sm_scale=scale), q, k, v)[1](do))
        with pltpu.force_tpu_interpret_mode():  # jitted and awaited one by one (_awaited)
            res = [*_awaited(fwd(q, k, v)), *_awaited(bwd(q, k, v, do))]
        _JAX[key] = [np.asarray(jnp.asarray(a, jnp.float32)) for a in res]
    return _JAX[key]


def _torch(arrays, dt):
    return [torch.from_numpy(a).to(DTYPES[dt][1]) for a in arrays]


def _f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_library_with_row_statistics(dt, n):
    o, l, m = _library(dt, n)[:3]
    q, k, v, _ = _torch(_inputs(0, n), dt)
    got = FA.flash_attention_plain(q, k, v, 0.25)
    assert got[0].dtype == DTYPES[dt][1] and got[1].dtype == got[2].dtype == torch.float32
    assert np.abs(_f32(got[0]) - o).max() <= TOL[dt]
    assert np.abs(_f32(got[1]) / l - 1).max() <= STAT_TOL
    assert np.abs(_f32(got[2]) - m).max() <= STAT_TOL


@pytest.mark.parametrize("d", [8, 32])
def test_forward_matches_library_at_other_head_dims(d):
    o, l, m = _library("f32", 256, d)[:3]
    q, k, v, _ = _torch(_inputs(0, 256, d), "f32")
    got = FA.flash_attention_plain(q, k, v, 1.0 / d ** 0.5)
    assert np.abs(_f32(got[0]) - o).max() <= TOL["f32"]
    assert np.abs(_f32(got[1]) / l - 1).max() <= STAT_TOL


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_vjp_matches_library_dkv_and_dq(dt, n):
    """The autograd Function's backward (dK/dV, then dQ, on the forward's l
    and m and ``di = sum(o * dO)``) against ``jax.vjp`` of the library."""
    want = _library(dt, n)[3:]
    q, k, v, do = _torch(_inputs(0, n), dt)
    for t in (q, k, v):
        t.requires_grad_()
    o = FA.flash_attention(q, k, v, 0.25)
    o.backward(do)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == DTYPES[dt][1]
        assert np.abs(_f32(got) - w).max() <= TOL[dt]


def test_plain_versions_are_softmax_attention_and_its_gradient_in_float64():
    """In float64 the tiled forward and the backward's kernels' steps are
    exact softmax attention and its autograd gradient, to rounding."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(3, 384))
    o, l, m = FA.flash_attention_plain(q, k, v, 0.25)
    s = q @ k.transpose(-1, -2) * 0.25
    assert torch.allclose(o, torch.softmax(s, -1) @ v, rtol=0, atol=1e-12)
    assert torch.allclose(m, s.amax(-1), rtol=0, atol=1e-12)
    assert torch.allclose(l, torch.exp(s - m[..., None]).sum(-1), rtol=1e-12, atol=0)
    di = FA.row_di(o, do)
    dk, dv = FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, 0.25)
    dq = FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, 0.25)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.softmax(ref[0] @ ref[1].transpose(-1, -2) * 0.25, -1) @ ref[2]
    want = torch.autograd.grad(out, ref, do)
    for got, w in zip((dq, dk, dv), want):
        assert torch.allclose(got, w, rtol=0, atol=1e-11)


def test_plain_backward_chunks_give_the_unchunked_result(monkeypatch):
    """The plain backward takes queries in chunks when the score tensor is
    large; chunked and whole agree to f32 rounding of the dK/dV sums."""
    q, k, v, do = _torch(_inputs(4, 512), "f32")
    o, l, m = FA.flash_attention_plain(q, k, v, 0.25)
    di = FA.row_di(o, do)
    whole = [*FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, 0.25),
             FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, 0.25)]
    monkeypatch.setattr(FA, "_PLAIN_CHUNK_ENTRIES", B * H * 512 * 128)  # 4 chunks of 128
    chunked = [*FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, 0.25),
               FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, 0.25)]
    assert torch.equal(whole[2], chunked[2])
    for a, b in zip(whole[:2], chunked[:2]):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_fn_matches_jax_layout_and_casts(dt):
    """``flash_attention_fn`` on flax's (B, N, H, D) layout against the JAX
    package's ``_flash_attention_fn`` (inputs in f32, compute type ``dt``)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, 256, H, 16)).astype(np.float32) for _ in range(3))
    jdt, tdt = DTYPES[dt]
    fn = jax.jit(lambda q, k, v: jax_flash_attention_fn(
        q, k, v, dtype=None if dt == "f32" else jdt, deterministic=True))
    with pltpu.force_tpu_interpret_mode():
        want = _awaited(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = FA.flash_attention_fn(*(torch.from_numpy(a) for a in (q, k, v)),
                                dtype=None if dt == "f32" else tdt)
    assert got.shape == want.shape == (B, 256, H, 16)
    assert got.dtype == tdt
    assert np.abs(_f32(got) - np.asarray(jnp.asarray(want, jnp.float32))).max() <= TOL[dt]


@pytest.mark.parametrize("n", [64, 200, 129])
def test_sequence_lengths_the_library_refuses_raise_its_error(n):
    q, k, v, _ = _inputs(0, 128)
    q, k, v = (a[:, :, :1].repeat(n, axis=2) for a in (q, k, v))
    with pytest.raises(ValueError) as want, pltpu.force_tpu_interpret_mode():
        _awaited(LIB.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     sm_scale=0.25))
    for fn in (lambda *a: FA.flash_attention(*a, 0.25), lambda *a: FA.flash_attention_plain(
            *a, 0.25), lambda *a: K.flash_attention_fwd(*a, 0.25)):
        with pytest.raises(ValueError) as got:
            fn(*(torch.from_numpy(a) for a in (q, k, v)))
        assert str(got.value) == str(want.value)


def test_dropout_warning_is_the_jax_functions():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((1, 128, 2, 16)).astype(np.float32)
    fn = jax.jit(lambda q: jax_flash_attention_fn(q, q, q, dropout_rate=0.1,
                                                  deterministic=False))
    with pytest.warns(UserWarning) as want, pltpu.force_tpu_interpret_mode():
        _awaited(fn(jnp.asarray(q)))
    t = torch.from_numpy(q)
    with pytest.warns(UserWarning) as got:
        FA.flash_attention_fn(t, t, t, dropout_rate=0.1, deterministic=False)
    assert str(got[0].message) == str(want[0].message)


def test_wrappers_run_the_plain_versions_on_the_cpu_and_count_nothing():
    q, k, v, do = _torch(_inputs(7, 256), "f32")
    before = K.launch_counts()
    o, l, m = K.flash_attention_fwd(q, k, v, 0.25)
    di = FA.row_di(o, do)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, l, m, do, di, 0.25)
    dq = K.flash_attention_bwd_dq(q, k, v, l, m, do, di, 0.25)
    assert K.launch_counts() == before
    for got, want in zip((o, l, m), FA.flash_attention_plain(q, k, v, 0.25)):
        assert torch.equal(got, want)
    for got, want in zip((dk, dv, dq), (*FA.flash_attention_bwd_dkv_plain(
            q, k, v, l, m, do, di, 0.25), FA.flash_attention_bwd_dq_plain(
            q, k, v, l, m, do, di, 0.25))):
        assert torch.equal(got, want)


def test_key_bias_gradient_is_zero_in_exact_arithmetic():
    """The rule by which the card checks leave each attention's key bias out
    (``utils/grad_check.zero_gradient_leaves``): a shift of every key by
    one vector moves each query's scores alike, which the softmax removes;
    in float64 its gradient vanishes to rounding against the query's."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(8, 256))
    shift = torch.zeros(16, dtype=torch.float64, requires_grad=True)
    qb = torch.zeros(16, dtype=torch.float64, requires_grad=True)
    o = FA.flash_attention(q + qb, k + shift, v, 0.25)
    g_key, g_query = torch.autograd.grad((o * do).sum(), (shift, qb))
    assert float(g_key.norm()) <= 1e-12 * float(g_query.norm())
