"""The port's PointNetPPCls (eval, CPU plain versions) against the JAX
package's classifier on the same flax variables and clouds, its weight
carrying, and its serving through the port's OrientationPredictor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import PointNetPPCls as JaxPointNetPPCls
from pointcloud_orientation_tpu.ops.geometry import set_pallas_mode
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import PointNetPPCls
from pointcloud_orientation_tpu_torch.utils import (
    cls_kwargs,
    load_flax_variables,
    random_flax_variables,
)


def _clouds(rng, b, n, channels):
    """xyz scaled into the unit ball, then unit normals when 6 channels."""
    xyz = rng.normal(size=(b, n, 3))
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    parts = [xyz]
    if channels == 6:
        nrm = rng.normal(size=(b, n, 3))
        parts.append(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    return np.concatenate(parts, axis=-1).astype(np.float32)


def _model(v):
    return load_flax_variables(PointNetPPCls(**cls_kwargs(v["params"])), v).eval()


@pytest.mark.parametrize("channels", [3, 6], ids=["xyz", "xyz+normals"])
def test_classifier_log_probs_match_jax(channels):
    """B=2, N=1024: the JAX model with every Pallas kernel in interpret mode
    (FPS, ball query, MLP+max) and no sampling rng, so FPS starts at index 0
    on both sides; log-probabilities within 1e-4 (the MLPs sum in another
    order)."""
    rng = np.random.default_rng(channels)
    x = _clouds(rng, 2, 1024, channels)
    v = random_flax_variables(channels, "pointnet_pp_cls", in_channels=channels)
    set_pallas_mode("always")
    try:
        want = np.asarray(JaxPointNetPPCls().apply(v, jnp.asarray(x), train=False))
    finally:
        set_pallas_mode("auto")
    with torch.no_grad():
        got = _model(v)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels,num_classes", [(3, 40), (6, 10)])
def test_random_flax_variables_match_the_classifier_tree(channels, num_classes):
    shapes = jax.eval_shape(lambda: JaxPointNetPPCls(num_classes=num_classes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, channels)), train=False))
    v = random_flax_variables(0, "pointnet_pp_cls", in_channels=channels,
                              num_classes=num_classes)
    want = jax.tree_util.tree_map(lambda x: x.shape, shapes)
    assert jax.tree_util.tree_map(np.shape, v) == want
    assert cls_kwargs(v["params"]) == {"in_channels": channels, "num_classes": num_classes}
    model = _model(v)
    assert model.in_channels == channels and model.fc3.out_features == num_classes
    with pytest.raises(NotImplementedError):
        random_flax_variables(0, "simple_pointnet")


def test_classifier_refuses_train_mode_wrong_widths_and_trees():
    """Train mode is ported (``tests/test_torch_cls_train.py``); the width
    and tree refusals stay."""
    v = random_flax_variables(1, "pointnet_pp_cls", in_channels=6)
    model = _model(v)
    with pytest.raises(ValueError):  # 3 channels into a model of 6
        model(torch.zeros((2, 64, 3)))
    with pytest.raises(ValueError, match="SetAbstraction_0"):  # a 6-channel tree, 3-channel model
        load_flax_variables(PointNetPPCls(in_channels=3), v)


def test_classifier_in_train_mode_draws_dropout_from_its_generator():
    """A fresh module is in train mode: it needs a generator for its
    dropout (and draws its FPS starts from it), gives finite
    log-probabilities and moves its FC BatchNorms' running statistics
    (flax momentum 0.9); the same generator state gives the same output."""
    model = PointNetPPCls(in_channels=6)
    x = torch.from_numpy(_clouds(np.random.default_rng(4), 2, 600, 6))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    before = model.bn1.running_var.clone()
    out = model(x, torch.Generator().manual_seed(1))
    assert out.shape == (2, 40) and torch.isfinite(out).all()
    assert not torch.equal(model.bn1.running_var, before)
    again = model(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(again, out, rtol=0, atol=0)


@pytest.fixture(scope="module", params=[3, 6], ids=["xyz", "xyz+normals"])
def predictor(request):
    v = random_flax_variables(request.param, "pointnet_pp_cls", in_channels=request.param)
    return OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                num_points=256, max_batch=4, seed=2, device="cpu")


@pytest.mark.parametrize("b,n", [(1, 256), (3, 100), (6, 300)],
                         ids=["exact", "tiled-points+batch-pad", "chunked+truncated"])
def test_classifier_predictor_serves_any_batch_and_cloud_size(predictor, rng, b, n):
    """Buckets, point padding and chunking above ``max_batch``: log-
    probabilities ``(b, 40)`` whose rows sum to 1, each chunk the model's
    output for the padded chunk under the same generator state."""
    c = predictor.channels
    x = _clouds(rng, b, n, c)
    predictor.generator.manual_seed(7)
    out = predictor(x)
    assert out.shape == (b, 40)
    np.testing.assert_allclose(np.exp(out).sum(-1), 1.0, rtol=1e-5)
    predictor.generator.manual_seed(7)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        want = np.concatenate([
            predictor.model(torch.from_numpy(predictor._pad(x[i:i + 4])), g)[:len(x[i:i + 4])]
            .numpy() for i in range(0, b, 4)])
    np.testing.assert_array_equal(out, want)
    fwd = predictor.forward_vectors(x)  # the JAX predictor's fall-through decode
    np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError):
        predictor(_clouds(rng, b, n, 9 - c))  # the other width


def test_classifier_predictor_draws_fps_starts_from_its_generator(predictor, rng):
    x = _clouds(rng, 2, 256, predictor.channels)
    predictor.generator.manual_seed(0)
    a1, a2 = predictor(x), predictor(x)
    predictor.generator.manual_seed(0)
    np.testing.assert_array_equal(predictor(x), a1)  # same state, same start points
    assert not np.array_equal(a1, a2)  # the generator moves on between requests
    with torch.no_grad():  # the model without a generator starts FPS at index 0
        first = predictor.model(torch.from_numpy(predictor._pad(x)))
    assert torch.isfinite(first).all()
