"""FSDP (``parallel/fsdp.py``) and tensor parallelism (``parallel/tp.py``)
as gloo ranks at world size 2 and 4, against the JAX package's on its
virtual mesh: the spec trees leaf by leaf, one SGD step of the point
transformer (loss rtol 1e-5, parameters atol 2e-5, the JAX tests' own
bounds; SGD, as there, so that the comparison stays linear in the
gradients), FSDP with remat, TP on a ``(data, model)`` mesh and with the
flash attention's plain version on each rank's heads, and an FSDP step of
the PointNet++ 8-dir model in train mode."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu.models import PointTransformer as JaxPT
from pointcloud_orientation_tpu_torch import parallel as TP
from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables
import torch_parallel_ranks as R

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("fsdp_tp", WORLDS)


def _specs(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda s: isinstance(s, P))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _jax_step(step, params, n_data, x, target, mesh):
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    ts = jax.device_put(target, NamedSharding(mesh, P("data")))
    return step(params, optax.sgd(0.1).init(params), xs, ts)


def _assert_params(got, want):
    want = _leaves(want)
    got = _leaves(got)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("min_size", [1, 1024])
@pytest.mark.parametrize("axis", [2, 4, 5])
@pytest.mark.parametrize("model", ["point_transformer", "pointnet_pp_8dir",
                                   "moe_point_transformer"])
def test_fsdp_specs_are_the_jax_ones(model, axis, min_size):
    params = random_flax_variables(0, model, depth=2)["params"] if "transformer" in model \
        else random_flax_variables(0, model)["params"]
    assert (TP.fsdp_param_specs(params, axis, min_weight_size=min_size)
            == _specs(JP.fsdp_param_specs(params, axis, min_weight_size=min_size)))


def test_tp_specs_and_fsdp_skip_are_the_jax_ones():
    params, _, _ = R.transformer_inputs()
    assert TP.tp_param_specs(params) == _specs(JP.tp_param_specs(params))
    skip_t, skip_j = TP.tp_param_specs(params), JP.tp_param_specs(params)
    assert (TP.fsdp_param_specs(params, 2, min_weight_size=1, skip=skip_t)
            == _specs(JP.fsdp_param_specs(params, 2, min_weight_size=1, skip=skip_j)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_fsdp_step_matches_jax(ranks, n, remat):
    params, x, target = R.transformer_inputs()
    model = JaxPT(depth=2, dropout=0.0, **R.T_SIZE)
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    fp = JP.shard_fsdp_params(jax.tree_util.tree_map(jnp.asarray, params), mesh,
                              min_weight_size=1)
    step = JP.make_fsdp_train_step(model, optax.sgd(0.1), mesh, remat=remat)
    p_want, _, loss = _jax_step(step, fp, n, x, target, mesh)
    got = ranks[n]["fsdp"][remat]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    _assert_params(got["params"], p_want)
    # the shards are 1/n of the leaves the specs split (min_weight_size 1)
    shapes = got["shard_shapes"]
    assert shapes["layers/0/ffn1/weight"] == (16, 32 // n)  # flax (16, 32) split on 32


@pytest.mark.parametrize("n", WORLDS)
def test_fsdp_train_mode_needs_a_generator(ranks, n):
    assert "requires step(..., generator=...)" in ranks[n]["fsdp_train_error"]


@pytest.mark.parametrize("n", WORLDS)
def test_fsdp_step_of_the_pointnet_pp_trunk(ranks, n):
    """FSDP over the 8-dir model in train mode (BatchNorm over the global
    batch) against the same step on one device's whole batch, both in
    float64 through the kernels' plain versions (in float32 the trunk's
    gradient routes through a max over neighbours at rounding level; the
    8-dir step tests compare in float64 for the same reason). The JAX FSDP
    step applies ``{"params": p}`` alone, which a BatchNorm model cannot
    (no ``batch_stats``), so the port's one-device step, held against JAX
    in the train-step tests, is the reference."""
    got, want = ranks[n]["fsdp_pp"]["fsdp"], ranks[n]["fsdp_pp"]["one_device"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
    for key in ("params", "batch_stats"):
        for (path, g), (_, w) in zip(_leaves(got[key]), _leaves(want[key])):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12, err_msg=str(path))


def _tp_cases():
    cases = [(2, (1, 2), "xla"), (2, (1, 2), "flash")]
    cases += [(4, shape, impl) for shape in ((1, 4), (2, 2)) for impl in ("xla", "flash")]
    return cases


@pytest.mark.parametrize("n, shape, impl", _tp_cases())
def test_tp_step_matches_jax(ranks, n, shape, impl):
    """The TP(+DP) step against the JAX one on the same mesh shape. With
    ``impl="flash"`` the port runs its flash attention (the plain version
    on the CPU) on each rank's heads at N=128, held against the JAX step
    with its default attention at the same bounds."""
    n_data, n_model = shape
    if impl == "flash":
        params, x, target = R.transformer_inputs(B=4, N=128)
    else:
        params, x, target = R.transformer_inputs()
    model = JaxPT(depth=2, dropout=0.0, **R.T_SIZE)
    mesh = JP.make_mesh(("data", "model"), shape, jax.devices()[:n])
    tp = JP.shard_tp_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    step = JP.make_tp_train_step(model, optax.sgd(0.1), mesh)
    p_want, _, loss = _jax_step(step, tp, n_data, x, target, mesh)
    got = ranks[n]["tp"][(n_data, n_model, impl)]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    _assert_params(got["params"], p_want)
