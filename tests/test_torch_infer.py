"""The port's OrientationPredictor (CPU plain versions) against the JAX
package's predictor: buckets, point and batch padding, chunking and
forward_vectors, on the same weights and clouds with sampling='first'."""

import jax
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.ops import DIRS_8
from pointcloud_orientation_tpu_torch.utils import random_flax_variables

NUM_POINTS, MAX_BATCH = 160, 4


@pytest.fixture(scope="module")
def predictors():
    v = random_flax_variables(11)
    kw = dict(num_points=NUM_POINTS, max_batch=MAX_BATCH, sampling="first")
    jax_pred = JaxPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)
    port = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                device="cpu", **kw)
    return jax_pred, port


@pytest.mark.parametrize("b,n", [(1, 160), (3, 100), (6, 200), (4, 37)],
                         ids=["exact", "tiled-points+batch-pad", "chunked+truncated",
                              "tiled-4x"])
def test_predictor_matches_jax_predictor(predictors, rng, b, n):
    jax_pred, port = predictors
    clouds = rng.normal(size=(b, n, 3)).astype(np.float32)
    want = np.asarray(jax_pred(clouds))
    got = port(clouds)
    assert got.shape == (b, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.forward_vectors(clouds), jax_pred.forward_vectors(clouds),
                               rtol=1e-5, atol=1e-5)


def test_buckets_and_padding_match_jax(predictors, rng):
    jax_pred, port = predictors
    for b in range(1, 2 * MAX_BATCH + 1):
        assert port._bucket(b) == jax_pred._bucket(b)
    clouds = rng.normal(size=(3, 70, 3)).astype(np.float32)
    padded = port._pad(clouds)
    assert padded.shape == (4, NUM_POINTS, 3)
    np.testing.assert_array_equal(padded[:3, :70], clouds)
    np.testing.assert_array_equal(padded[:3, 70:140], clouds)  # cycled, np.tile
    np.testing.assert_array_equal(padded[3], padded[0])  # batch pad: first cloud
    long = rng.normal(size=(4, 300, 3)).astype(np.float32)
    np.testing.assert_array_equal(port._pad(long), long[:, :NUM_POINTS])  # truncated


def test_forward_vectors_are_unit_and_follow_the_logits(predictors, rng):
    _, port = predictors
    clouds = rng.normal(size=(5, 160, 3)).astype(np.float32)
    fwd = port.forward_vectors(clouds)
    np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, rtol=1e-6)
    probs = jax.nn.softmax(port(clouds), axis=-1)
    want = np.asarray(probs) @ DIRS_8.numpy()
    np.testing.assert_allclose(fwd, want / np.linalg.norm(want, axis=-1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kwargs, error", [
    ({"model_name": "moe_point_transformer"}, ValueError),
    ({"tta_views": 3}, ValueError),
    ({"model_name": "pointnet_pp_cls", "tta_views": 2}, ValueError),
    ({"tta_views": 0}, ValueError),
    ({"model_name": "pointnet_pp_cls", "ensemble_size": 2}, ValueError),
    ({"quantize": "int4"}, ValueError),
    ({"mesh": object(), "tta_views": 2}, ValueError),
], ids=["other-model", "tta", "tta-head", "tta-zero", "ensemble", "int8", "mesh"])
def test_predictor_refuses_what_is_not_ported(kwargs, error):
    """The JAX predictor's own ``ValueError``s: a model that returns ``(out,
    aux)`` (the MoE transformer), an 8-dir TTA view count outside (2, 4,
    8), TTA on a head that is not yaw-equivariant, no views, an ensemble
    of a head with no combine, an unknown quantization mode, TTA with a
    mesh (raised before the mesh is read; sharded serving itself is held
    in ``tests/test_torch_parallel_dp.py``)."""
    v = random_flax_variables(0)
    args = dict(model_name="pointnet_pp_8dir", params=v["params"],
                batch_stats=v["batch_stats"], device="cpu")
    args.update(kwargs)
    if args["model_name"] == "pointnet_pp_cls":
        args.update(params=random_flax_variables(0, "pointnet_pp_cls")["params"])
    with pytest.raises(error):
        OrientationPredictor(**args)


def test_random_sampling_is_seeded(rng):
    v = random_flax_variables(4)
    clouds = rng.normal(size=(2, 300, 3)).astype(np.float32)

    def serve(seed):
        p = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                 num_points=256, max_batch=2, seed=seed, device="cpu")
        return p(clouds), p(clouds)

    a1, a2 = serve(0)
    b1, _ = serve(0)
    np.testing.assert_array_equal(a1, b1)  # same seed, same centroids
    assert not np.array_equal(a1, a2)  # the generator moves on between requests
    assert np.isfinite(a1).all()


def test_predictor_defaults_to_the_card():
    v = random_flax_variables(0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is exercised on the card")
    with pytest.raises((RuntimeError, AssertionError)):
        OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"])
