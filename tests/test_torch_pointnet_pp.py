"""The port's PointNetPP8Dir (eval, CPU plain versions) against the JAX
package's model on the same flax variables and the same clouds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPointNetPP8Dir
from pointcloud_orientation_tpu.ops.geometry import set_pallas_mode
from pointcloud_orientation_tpu_torch.models import (
    PointNet,
    PointNetCls,
    SimplePointNet,
    MODEL_REGISTRY,
    MoEPointTransformer,
    PointNetPP,
    PointNetPP8Dir,
    PointNetPPCls,
    PointNetPPFwd,
    PointNetPPMvM,
    PointNetPPVonMises,
    PointNetPPXYZ,
    PointNetPPXYZSchmidt,
    PointTransformer,
    SharedMLP,
)
from pointcloud_orientation_tpu_torch.parallel.sp_transformer import RingPointTransformer
from pointcloud_orientation_tpu_torch.utils import load_flax_variables, random_flax_variables


def _flax_variables(rng, n_points):
    """flax-initialised variables with random BatchNorm statistics, as numpy."""
    model = JaxPointNetPP8Dir(sampling="first")
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, n_points, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32), v["batch_stats"])
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if p[-1].key == "var" else x, v["batch_stats"])
    return v


@pytest.mark.parametrize("pallas_mode", ["auto", "always"])
def test_pointnet_pp_8dir_logits_match_jax(rng, pallas_mode):
    """'auto' runs the JAX model's XLA path on the CPU, 'always' its Pallas
    kernels in interpret mode (fused grouping + fused MLP+max)."""
    v = _flax_variables(rng, 256)
    clouds = rng.normal(size=(2, 256, 3)).astype(np.float32)
    set_pallas_mode(pallas_mode)
    try:
        want = np.asarray(JaxPointNetPP8Dir(sampling="first").apply(
            v, jnp.asarray(clouds), train=False))
    finally:
        set_pallas_mode("auto")
    model = load_flax_variables(PointNetPP8Dir(sampling="first"), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(clouds)).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_random_flax_variables_match_the_flax_tree():
    shapes = jax.eval_shape(lambda: JaxPointNetPP8Dir().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)), train=False))
    v = random_flax_variables(0)
    want = jax.tree_util.tree_map(lambda x: x.shape, shapes)
    got = jax.tree_util.tree_map(lambda x: x.shape, v)
    assert got == want
    var = np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(v["batch_stats"])
                          if x.ndim == 1])
    assert np.isfinite(var).all()
    assert not np.allclose(v["batch_stats"]["PointNetPPTrunk_0"]["BatchNorm_0"]["var"], 1.0)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(random_flax_variables(0))):
        np.testing.assert_array_equal(a, b)


def test_load_flax_variables_refuses_missing_and_misshapen_entries():
    v = random_flax_variables(1)
    bad = random_flax_variables(1)
    bad["params"]["Dense_0"]["kernel"] = np.zeros((256, 9), np.float32)
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        load_flax_variables(PointNetPP8Dir(), bad)
    del v["params"]["PointNetPPTrunk_0"]["SetAbstraction_1"]
    with pytest.raises(KeyError, match="SetAbstraction_1"):
        load_flax_variables(PointNetPP8Dir(), v)
    with pytest.raises(KeyError, match="batch_stats"):
        load_flax_variables(PointNetPP8Dir(), {"params": random_flax_variables(1)["params"]})


def test_shared_mlp_fold_matches_unfolded_batchnorm(rng):
    """The eval fold (scale = gamma*rsqrt(var+eps), shift = (bias-mean)*scale
    + beta) against Linear -> BatchNorm(eval) -> ReLU -> max, in torch."""
    torch.manual_seed(0)
    mlp = SharedMLP(5, (7, 9))
    for bn in mlp.bns:
        bn.running_mean.uniform_(-0.3, 0.3)
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.uniform_(-0.2, 0.2)
    mlp.eval()
    g = torch.from_numpy(rng.normal(size=(2, 6, 4, 5)).astype(np.float32))
    with torch.no_grad():
        x = g
        for lin, bn in zip(mlp.linears, mlp.bns):
            x = torch.relu(bn(lin(x).reshape(-1, lin.out_features)).reshape(*x.shape[:-1], -1))
        want = x.amax(dim=1)
        got = mlp(g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_mode_raises_until_the_training_slice():
    """The training slice is ported: a fresh module (train mode) runs, and
    it raises only where the JAX module would too, on a dropout without a
    random stream."""
    model = PointNetPP8Dir(sampling="first")  # a fresh module is in train mode
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros((2, 128, 3)))
    out = model(torch.randn((2, 128, 3), generator=torch.Generator().manual_seed(0)),
                torch.Generator().manual_seed(1))
    assert out.shape == (2, 8) and torch.isfinite(out).all() and out.requires_grad


@pytest.mark.parametrize("kwargs", [{"grouping": "radius"}, {"dtype": torch.float16},
                                    {"sampling": "grid"}])
def test_model_refuses_what_is_not_ported(kwargs):
    with pytest.raises(NotImplementedError):
        PointNetPP8Dir(**kwargs)


def test_registry_holds_the_ported_model():
    assert MODEL_REGISTRY == {"pointnet_pp_8dir": PointNetPP8Dir,
                              "pointnet_pp_fwd": PointNetPPFwd,
                              "pointnet_pp_von_mises": PointNetPPVonMises,
                              "pointnet_pp_mvm": PointNetPPMvM,
                              "pointnet_pp_cls": PointNetPPCls,
                              "pointnet_pp": PointNetPP,
                              "pointnet_pp_xyz": PointNetPPXYZ,
                              "pointnet_pp_xyz_schmidt": PointNetPPXYZSchmidt,
                              "point_transformer": PointTransformer,
                              "moe_point_transformer": MoEPointTransformer,
                              "simple_pointnet": SimplePointNet,
                              "pointnet": PointNet,
                              "pointnet_cls": PointNetCls,
                              "ring_point_transformer": RingPointTransformer}


def test_random_sampling_uses_the_generator(rng):
    model = load_flax_variables(PointNetPP8Dir(), random_flax_variables(2)).eval()
    x = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32))

    def run(seed):
        with torch.no_grad():
            return model(x, torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with torch.no_grad():  # no generator: the first points, like flax without a rng
        first = load_flax_variables(PointNetPP8Dir(sampling="first"),
                                    random_flax_variables(2)).eval()
        assert torch.equal(model(x), first(x))
