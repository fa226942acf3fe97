"""Ring attention (``parallel/ring_attention.py``) and the sequence-parallel
transformer (``parallel/sp_transformer.py``) as gloo ranks at world size 2
and 4, against the JAX package's on its virtual mesh: the ring's output
(2e-5) and its gradients through the written-out backward (rtol 5e-4, atol
5e-5), the ``compute_dtype=bfloat16`` variant (2e-2), the
``RingPointTransformer``'s sharded forward (2e-5) and one SGD step (rtol
1e-4, atol 1e-6): the JAX tests' bounds. Its flax tree is carried both
ways, and off a mesh it is the plain module."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu.parallel.sp_transformer import RingPointTransformer as JaxRing
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                model_kwargs,
                                                                random_flax_variables,
                                                                to_flax_variables)
import torch_parallel_ranks as R

WORLDS = (2, 4)
RING_CASES = [(2, (1, 2)), (4, (2, 2)), (4, (1, 4))]


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("ring_sp", WORLDS)


def _blocks(a, n_data, sp, d, m):
    B, N = a.shape[0], a.shape[2]
    return a[d * B // n_data:(d + 1) * B // n_data, :, m * N // sp:(m + 1) * N // sp]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n, shape", RING_CASES)
def test_ring_attention_matches_jax(ranks, n, shape, bf16):
    n_data, sp = shape
    q, k, v, do = R.qkv_inputs()
    mesh = JP.make_mesh(("data", "model"), shape, jax.devices()[:n])
    ring = JP.make_ring_attention(mesh, compute_dtype=jnp.bfloat16 if bf16 else None)
    out, vjp = jax.vjp(jax.jit(ring), q, k, v)
    dq, dk, dv = vjp(jnp.asarray(do))
    got = ranks[n]["ring"][(n_data, sp, str(torch.bfloat16) if bf16 else "None")]
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)
    grad_tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=5e-4, atol=5e-5)
    for r in got:
        d, m = r["data"], r["model"]
        np.testing.assert_allclose(r["out"], _blocks(np.asarray(out), n_data, sp, d, m), **tol)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(r[name], _blocks(np.asarray(want), n_data, sp, d, m),
                                       err_msg=name, **grad_tol)


@pytest.mark.parametrize("n, shape", RING_CASES)
def test_sp_transformer_matches_jax(ranks, n, shape):
    n_data, sp = shape
    params, x, target = R.ring_model_inputs()
    ring = JaxRing(embed_dim=16, num_heads=2, depth=2, ffn_dim=32, axis_name="model")
    mesh = JP.make_mesh(("data", "model"), shape, jax.devices()[:n])
    fwd = jax.jit(shard_map(lambda p, a: ring.apply({"params": p}, a), mesh=mesh,
                            in_specs=(P(), P("data", "model")), out_specs=P("data")))
    want = np.asarray(fwd(params, x))
    got = ranks[n]["sp"][(n_data, sp)]
    b = len(x) // n_data
    for d, out in got["forward"]:
        np.testing.assert_allclose(out, want[d * b:(d + 1) * b], rtol=2e-5, atol=2e-5)
    tx = optax.sgd(R.SP_LR)
    step = JP.make_sp_train_step(ring, tx, mesh)
    new, _, loss = step(params, tx.init(params), x, target)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    for (p, a), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got["params"]),
                              jax.tree_util.tree_leaves_with_path(new)):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=str(p))


def test_ring_model_tree_both_ways_and_plain_forward():
    """``random_flax_variables(..., "ring_point_transformer")`` has the JAX
    model's tree (its defaults: depth 2, ffn_dim 256), it loads and comes
    back unchanged, and the plain module's forward is the JAX one's off a
    mesh."""
    jax_tree = jax.eval_shape(lambda: JaxRing(axis_name=None).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 3))))["params"]
    v = random_flax_variables(0, "ring_point_transformer")
    assert (jax.tree_util.tree_map(np.shape, v["params"])
            == jax.tree_util.tree_map(lambda a: a.shape, jax_tree))
    model = MODEL_REGISTRY["ring_point_transformer"](
        **model_kwargs("ring_point_transformer", v["params"]))
    load_flax_variables(model, v)
    back = to_flax_variables(model)["params"]
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(v["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    x = R.clouds(3, 2, 40)
    want = JaxRing(axis_name=None).apply({"params": v["params"]}, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
