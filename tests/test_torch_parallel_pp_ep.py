"""Pipeline (``parallel/pp.py``) and expert (``parallel/ep.py``)
parallelism as gloo ranks at world size 2 and 4, against the JAX package's
on its virtual mesh: the pipelined forward and one SGD step of the point
transformer on ``S`` stages with ``M`` microbatches, and with DP on a
``(data, stage)`` mesh (2e-6, the JAX tests' bound); the expert-sharded
MoE layer's output and auxiliary loss under both dispatches and an SGD
step through it (1e-6, the JAX tests' bound)."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu.models import PointTransformer as JaxPT
from pointcloud_orientation_tpu.models.moe_transformer import moe_ep_param_specs as jax_moe_specs
from pointcloud_orientation_tpu.parallel.ep import MoEFeedForward as JaxMoE
from pointcloud_orientation_tpu_torch.models.moe_transformer import moe_ep_param_specs
from pointcloud_orientation_tpu_torch.parallel import split_pipeline_params
from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables
import torch_parallel_ranks as R

WORLDS = (2, 4)
DEPTH = 4
PP_LAYOUTS = [(2, (None, 2, 2)), (2, (None, 2, 4)), (4, (None, 4, 2)), (4, (None, 4, 4)),
              (4, (2, 2, 2))]


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("pp_ep", WORLDS)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_split_pipeline_params_is_the_jax_split():
    params, _, _ = R.transformer_inputs(depth=DEPTH)
    stacked, rest = split_pipeline_params(params, DEPTH)
    j_stacked, j_rest = JP.split_pipeline_params(params, DEPTH)
    for (p, a), (q, b) in zip(_leaves((stacked, rest)), _leaves((j_stacked, j_rest))):
        assert p == q
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n, layout", PP_LAYOUTS)
def test_pp_forward_and_step_match_jax(ranks, n, layout):
    n_data, stages, microbatches = layout
    params, x, target = R.transformer_inputs(depth=DEPTH)
    model = JaxPT(depth=DEPTH, dropout=0.0, **R.T_SIZE)
    stacked, rest = JP.split_pipeline_params(jax.tree_util.tree_map(jnp.asarray, params), DEPTH)
    tx = optax.sgd(0.1)
    if n_data is None:
        mesh = JP.make_mesh(("stage",), (stages,), jax.devices()[:stages])
        xs, ts, data_axis = x, target, None
    else:
        mesh = JP.make_mesh(("data", "stage"), (n_data, stages), jax.devices()[:n])
        xs, ts = (jax.device_put(a, NamedSharding(mesh, P("data"))) for a in (x, target))
        data_axis = "data"
    placed = JP.place_pipeline_state(stacked, rest, mesh)
    got = ranks[n]["pp"][layout]
    if n_data is None:
        want = JP.make_pp_apply(model, mesh, microbatches)(*placed, x)
        np.testing.assert_allclose(got["apply"], np.asarray(want), atol=2e-6)
    else:  # each data shard's pipeline: the plain model on the rank's rows
        want = model.apply({"params": params}, x[:len(x) // n_data], train=False)
        np.testing.assert_allclose(got["apply"], np.asarray(want), atol=2e-6)
    step = JP.make_pp_train_step(model, tx, mesh, microbatches, data_axis=data_axis)
    (new_stacked, new_rest), _, loss = step(placed, tx.init(placed), xs, ts)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-6)
    per = DEPTH // stages
    for rank, tree in enumerate(got["stage"]):
        s = rank % stages
        for i in range(per):
            want_layer = jax.tree_util.tree_map(lambda a: np.asarray(a)[s * per + i], new_stacked)
            for (p, a), (_, b) in zip(_leaves(tree[f"TransformerEncoderLayer_{i}"]),
                                      _leaves(want_layer)):
                np.testing.assert_allclose(a, b, atol=2e-6, err_msg=f"stage {s} layer {i} {p}")
        for key in ("Dense_0", "Dense_1"):  # embedding and head, the same on every stage
            for (p, a), (_, b) in zip(_leaves(tree[key]), _leaves(new_rest[key])):
                np.testing.assert_allclose(a, np.asarray(b), atol=2e-6, err_msg=f"{key} {p}")


def _jax_moe(dispatch):
    return JaxMoE(embed_dim=16, ffn_dim=32, n_experts=4, dispatch=dispatch, capacity_factor=4.0)


@pytest.mark.parametrize("dispatch", ["masked", "capacity"])
@pytest.mark.parametrize("n", WORLDS)
def test_ep_matches_jax(ranks, n, dispatch):
    """The output and aux against the JAX ``make_ep_apply`` on n devices;
    the parameters after one SGD step on MSE(pooled) + 0.01 aux against the
    JAX dense step (``tests/test_ep_moe.py``'s), each rank's experts its
    block of the stacked leaves."""
    params, x, target = R.moe_inputs()
    mod = _jax_moe(dispatch)
    mesh = JP.make_mesh(("expert",), (n,), jax.devices()[:n])
    y, aux = JP.make_ep_apply(mod, mesh)(JP.place_ep_params(params, mesh), jnp.asarray(x))
    got = ranks[n]["ep"][dispatch]
    np.testing.assert_allclose(got["y"], np.asarray(y), atol=1e-6)
    assert got["aux"] == pytest.approx(float(aux), rel=1e-6)

    def dense_loss(p):
        y, aux = mod.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((jnp.mean(y, axis=1) - target) ** 2) + 0.01 * aux

    g = jax.grad(dense_loss)(params)
    ref = jax.tree_util.tree_map(lambda a, b: np.asarray(a - 0.1 * b), params, g)
    k = 4 // n
    for rank, new in enumerate(got["new"]):
        np.testing.assert_allclose(new["router"], ref["router"]["kernel"], atol=1e-6)
        for leaf in ("wi", "bi", "wo", "bo"):
            np.testing.assert_allclose(new[leaf], ref[leaf][rank * k:(rank + 1) * k], atol=1e-6,
                                       err_msg=f"rank {rank} {leaf}")


def test_moe_ep_param_specs_are_the_jax_ones():
    params = random_flax_variables(0, "moe_point_transformer", depth=2)["params"]
    want = jax.tree_util.tree_map(tuple, jax_moe_specs(params),
                                  is_leaf=lambda s: isinstance(s, P))
    assert moe_ep_param_specs(params) == want
