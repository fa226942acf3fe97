"""The port's MoE feed-forward (``parallel/ep.py``) and MoE point transformer
(``models/moe_transformer.py``) against the JAX package's on the CPU, at a
small size (embed 16, FFN 32, 4 experts, depth 2, N <= 64): both
dispatches' outputs and aux losses on the same numpy inputs and weights,
the routing compared first (assignments equal token for token), the
capacity dispatch's rounding, drops and empty slots, the masked dispatch as
its ground truth at ``capacity_factor = n_experts``, bf16 promotion, and
the flax tree both ways. Mirrors the one-device cases of
``tests/test_moe_capacity.py``, ``tests/test_moe_transformer.py`` and
``tests/test_ep_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointcloud_orientation_tpu.models import MoEPointTransformer as JaxMoEPT
from pointcloud_orientation_tpu.parallel import ep as jax_ep
from pointcloud_orientation_tpu_torch.models import MULTI_OUTPUT_MODELS, MoEPointTransformer
from pointcloud_orientation_tpu_torch.parallel import ep
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)

E, F, K = 16, 32, 4
SMALL = dict(depth=2, embed_dim=E, num_heads=2, ffn_dim=F, n_experts=K)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ffn_params(seed):
    """A ``MoEFeedForward`` param tree in flax's layout, from numpy, with
    nonzero expert biases."""
    rng = np.random.default_rng(seed)
    return {"router": {"kernel": rng.normal(size=(E, K)).astype(np.float32) / np.sqrt(E)},
            "wi": rng.normal(size=(K, E, F)).astype(np.float32) / np.sqrt(E),
            "bi": 0.1 * rng.normal(size=(K, F)).astype(np.float32),
            "wo": rng.normal(size=(K, F, E)).astype(np.float32) / np.sqrt(F),
            "bo": 0.1 * rng.normal(size=(K, E)).astype(np.float32)}


def _port_ffn(p, dispatch="masked", capacity_factor=1.25):
    m = ep.MoEFeedForward(E, F, K, dispatch, capacity_factor)
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(p["router"]["kernel"].T.copy()))
        for leaf in ("wi", "bi", "wo", "bo"):
            getattr(m, leaf).copy_(torch.from_numpy(p[leaf]))
    return m


def _x(seed, b=4, n=24):
    return np.random.default_rng(seed + 100).normal(size=(b, n, E)).astype(np.float32)


def _jax_assign(p, x):
    return np.asarray(jnp.argmax(jax.nn.softmax(jnp.asarray(x) @ p["router"]["kernel"], -1), -1))


def _port_assign(m, x):
    with torch.no_grad():
        return torch.argmax(torch.softmax(m.router(torch.from_numpy(x)), -1), -1).numpy()


@pytest.mark.parametrize("dispatch,factor", [("masked", 1.25), ("capacity", 1.25),
                                             ("capacity", 1.0), ("capacity", 4.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ffn_matches_jax(dispatch, factor, seed):
    """The routing first (every token's expert equal), then ``y`` within
    2e-6 (outputs of order 1; readings at most 4.8e-7) and ``aux`` within
    1e-6 relative, at factors that drop tokens (1.0, 1.25) and that do not
    (4.0)."""
    p, x = _ffn_params(seed), _x(seed)
    mod = jax_ep.MoEFeedForward(embed_dim=E, ffn_dim=F, n_experts=K, dispatch=dispatch,
                                capacity_factor=factor)
    y_j, aux_j = mod.apply({"params": p}, jnp.asarray(x))
    m = _port_ffn(p, dispatch, factor)
    assert (_port_assign(m, x) != _jax_assign(p, x)).sum() == 0
    with torch.no_grad():
        y, aux = m(torch.from_numpy(x))
    assert np.abs(y.numpy() - np.asarray(y_j)).max() <= 2e-6
    assert abs(float(aux) - float(aux_j)) <= 1e-6 * abs(float(aux_j))


def test_expert_capacity_rounding():
    """``expert_capacity`` is the JAX package's: ceil(T/K * factor) up to a
    multiple of 8."""
    for args in ((96, 4, 1.0), (96, 4, 1.25), (96, 4, 4.0), (1, 4, 1.0), (16 * 1024, 4, 1.25),
                 (100, 3, 1.7), (7, 4, 0.5)):
        assert ep.expert_capacity(*args) == jax_ep.expert_capacity(*args), args
    assert ep.expert_capacity(96, 4, 1.25) == 32 and ep.expert_capacity(1, 4, 1.0) == 8


def test_capacity_matches_masked_when_no_drop():
    """At ``capacity_factor = n_experts`` no token drops: the capacity
    dispatch's output, aux and gradients (parameters and input) equal the
    masked dispatch's within 1e-6, as the JAX test holds them."""
    p, x = _ffn_params(0), _x(0)
    outs = []
    for dispatch, factor in (("masked", 1.25), ("capacity", 4.0)):
        m = _port_ffn(p, dispatch, factor)
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = m(xt)
        ((y ** 2).mean() + 0.01 * aux).backward()
        outs.append((y.detach(), aux.detach(), xt.grad,
                     {n: q.grad for n, q in m.named_parameters()}))
    (y_m, a_m, gx_m, g_m), (y_c, a_c, gx_c, g_c) = outs
    assert torch.allclose(y_c, y_m, atol=1e-6) and torch.allclose(a_c, a_m, rtol=1e-6)
    assert torch.allclose(gx_c, gx_m, atol=1e-6)
    for n in g_m:
        assert torch.allclose(g_c[n], g_m[n], atol=1e-6), n


def test_capacity_drop_is_exact_zero():
    """Every token routed to expert 0 with capacity 8 < T: the first 8
    tokens in the flattened order match the masked dispatch, the rest are
    exactly 0.0 despite expert 0's bias; the JAX function gives the same."""
    Kx, Ex, Fx, B, N = 4, 16, 32, 2, 12
    rng = np.random.default_rng(1)
    wi, bi = 0.1 * rng.normal(size=(Kx, Ex, Fx)), 0.1 * rng.normal(size=(Kx, Fx))
    wo, bo = 0.1 * rng.normal(size=(Kx, Fx, Ex)), np.zeros((Kx, Ex))
    bo[0] = 0.5
    x = rng.normal(size=(B, N, Ex))
    w = [np.asarray(a, np.float32) for a in (x, wi, bi, wo, bo)]
    t = [torch.from_numpy(a) for a in w]
    assign = torch.zeros((B, N), dtype=torch.long)
    y = ep.expert_compute_capacity(*t[:1], assign, *t[1:], 8).reshape(B * N, Ex)
    full = ep.expert_compute(t[0], torch.nn.functional.one_hot(assign, Kx), *t[1:])
    assert torch.allclose(y[:8], full.reshape(B * N, Ex)[:8], atol=1e-6)
    assert bool((y[8:] == 0.0).all())
    want = jax_ep._expert_compute_capacity(jnp.asarray(w[0]), jnp.zeros((B, N), jnp.int32),
                                           *map(jnp.asarray, w[1:]), 8)
    assert np.abs(y.numpy() - np.asarray(want).reshape(B * N, Ex)).max() <= 1e-6


def test_capacity_empty_expert_no_bias_leak():
    """Experts with no token contribute nothing despite nonzero biases (the
    empty slots' bias outputs land in the sentinel row): expert 0's output
    ``relu(0 + 1) @ 0 + 1 = 1`` for each of its 8 tokens."""
    wi, wo = torch.zeros((K, E, F)), torch.zeros((K, F, E))
    bi, bo = torch.ones((K, F)), torch.ones((K, E))
    y = ep.expert_compute_capacity(torch.zeros((1, 8, E)), torch.zeros((1, 8), dtype=torch.long),
                                   wi, bi, wo, bo, 16)
    assert torch.equal(y, torch.ones((1, 8, E)))


def test_slot_tokens_match_jax_layout():
    """The slot map: tokens in flattened router order, the sentinel ``T`` in
    empty slots, tokens past capacity in none; the JAX function's ``pos``
    and ``.at[...].set(mode="drop")`` give the same map."""
    rng = np.random.default_rng(3)
    assign = rng.integers(0, K, size=(3, 20))
    cap = 8
    slots = ep.slot_tokens(torch.from_numpy(assign), K, cap).numpy()
    T = assign.size
    a = jnp.asarray(assign.reshape(-1))
    onehot = jax.nn.one_hot(a, K, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    want = jnp.full((K, cap), T, jnp.int32).at[a, pos].set(jnp.arange(T, dtype=jnp.int32),
                                                           mode="drop")
    np.testing.assert_array_equal(slots, np.asarray(want))


def _model_out(v, x, dispatch, factor, dtype=None):
    kw = dict(dispatch=dispatch, capacity_factor=factor)
    j = JaxMoEPT(**SMALL, **kw, dtype=None if dtype is None else jnp.bfloat16)
    out_j, aux_j = j.apply({"params": v["params"]}, jnp.asarray(x))
    m = load_flax_variables(MoEPointTransformer(**model_kwargs("moe_point_transformer",
                                                               v["params"]),
                                                **kw, dtype=dtype), v).eval()
    with torch.no_grad():
        out, aux = m(torch.from_numpy(x))
    return out.numpy(), float(aux), np.asarray(out_j), float(aux_j)


@pytest.mark.parametrize("dispatch,factor", [("masked", 1.25), ("capacity", 1.25),
                                             ("capacity", 4.0)])
def test_model_matches_jax(dispatch, factor):
    """The whole model's eval ``(out, aux)`` on the same flax variables:
    out within 2e-6 (readings at most 1.2e-7), aux within 1e-6 relative;
    at factor 4.0 the capacity model equals the masked one."""
    v = random_flax_variables(0, "moe_point_transformer", **SMALL)
    x = np.random.default_rng(0).normal(size=(2, 64, 3)).astype(np.float32)
    out, aux, out_j, aux_j = _model_out(v, x, dispatch, factor)
    assert out.shape == (2, 3) and np.abs(out - out_j).max() <= 2e-6
    assert abs(aux - aux_j) <= 1e-6 * abs(aux_j) and aux >= 1.0 - 1e-5  # balance bound
    if factor == 4.0:
        masked, masked_aux, _, _ = _model_out(v, x, "masked", 1.25)
        assert np.abs(out - masked).max() <= 1e-6 and abs(aux - masked_aux) <= 1e-6


@pytest.mark.parametrize("dispatch", ["masked", "capacity"])
def test_bf16_model_matches_jax_bf16(dispatch):
    """``dtype="bfloat16"`` against ``dtype=jnp.bfloat16``: the MoE FFN
    promotes its bf16 input to the f32 parameters and the second LayerNorm
    rounds ``x + h`` (f32) to bf16, as flax does. Outputs within 1e-3
    (readings at most 6.7e-8), aux within 1e-5 relative (its expert shares
    rounded to bf16 as there); both within 0.05 of the f32 model."""
    v = random_flax_variables(1, "moe_point_transformer", **SMALL)
    x = np.random.default_rng(1).normal(size=(2, 64, 3)).astype(np.float32)
    out, aux, out_j, aux_j = _model_out(v, x, dispatch, 1.25, "bfloat16")
    f32, _, _, _ = _model_out(v, x, dispatch, 1.25)
    assert out.dtype == np.float32
    assert np.abs(out - out_j).max() <= 1e-3 and abs(aux - aux_j) <= 1e-5 * abs(aux_j)
    assert np.abs(out - f32).max() < 0.05 and np.abs(out_j - f32).max() < 0.05


def test_flax_tree_round_trip_and_sizes_from_the_tree():
    """``random_flax_variables`` has the JAX model's tree and shapes (the
    router without bias, the stacked experts); loading and reading back
    gives the same numbers, and the sizes are read from the tree."""
    kw = dict(embed_dim=32, num_heads=2, depth=3, ffn_dim=48, n_experts=3)
    v = random_flax_variables(2, "moe_point_transformer", **kw)
    init = jax.eval_shape(lambda: JaxMoEPT(**kw).init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 16, 3))))
    assert (jax.tree_util.tree_map(np.shape, init["params"])
            == jax.tree_util.tree_map(np.shape, v["params"]))
    assert model_kwargs("moe_point_transformer", v["params"]) == {"in_dim": 3, **kw}
    back = to_flax_variables(load_flax_variables(MoEPointTransformer(**kw), v))
    assert back["batch_stats"] == {}
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back["params"],
                                                         v["params"]))
    with pytest.raises(ValueError, match="router/kernel"):
        load_flax_variables(MoEPointTransformer(**{**kw, "n_experts": 4}), v)


def test_registry_and_multi_output_contract():
    """The registry key and ``MULTI_OUTPUT_MODELS`` are the JAX package's;
    an unknown dispatch raises the JAX module's ``ValueError``."""
    from pointcloud_orientation_tpu.models import MULTI_OUTPUT_MODELS as JAX_MULTI
    from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY

    assert MULTI_OUTPUT_MODELS == JAX_MULTI
    assert MODEL_REGISTRY["moe_point_transformer"] is MoEPointTransformer
    with pytest.raises(ValueError, match="unknown dispatch"):
        MoEPointTransformer(**SMALL, dispatch="sorted")
    with pytest.raises(ValueError, match="unknown dispatch"):
        jax.eval_shape(lambda: JaxMoEPT(**SMALL, dispatch="sorted").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 3))))


def test_routing_matches_jax_in_every_layer():
    """Each layer's top-1 assignment, read from its router (a forward hook
    in the port, ``nn.intercept_methods`` in flax), is the JAX model's
    token for token on the same input: routing is compared before any
    output, since one flipped token moves a whole FFN output."""
    v = random_flax_variables(3, "moe_point_transformer", **SMALL)
    x = np.random.default_rng(3).normal(size=(3, 48, 3)).astype(np.float32)
    want = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dense) and context.module.name == "router":
            want.append(np.asarray(jnp.argmax(jax.nn.softmax(out, -1), -1)))
        return out

    with nn.intercept_methods(record):
        JaxMoEPT(**SMALL).apply({"params": v["params"]}, jnp.asarray(x))
    m = load_flax_variables(MoEPointTransformer(**SMALL), v).eval()
    got = []
    for layer in m.layers:
        layer.moe.router.register_forward_hook(
            lambda mod, inp, out: got.append(torch.argmax(torch.softmax(out, -1), -1).numpy()))
    with torch.no_grad():
        m(torch.from_numpy(x))
    assert len(got) == len(want) == SMALL["depth"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
