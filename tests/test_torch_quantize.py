"""Weight-only int8 serving in the port (``utils/quantize.py`` and
``OrientationPredictor(quantize="int8")``) against the JAX package's: the
int8 values and scales bit for bit, the ``.npz`` artifact read and written
both ways, and the int8 predictors on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.utils import quantize as jq
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.utils import quantize as tq
from pointcloud_orientation_tpu_torch.utils import random_flax_variables

N = 128
SMALL_PT = dict(embed_dim=32, num_heads=4, depth=2, ffn_dim=64)
MODELS = {"pointnet_pp_8dir": {}, "point_transformer": SMALL_PT, "pointnet_cls": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("model", list(MODELS))
def test_quantize_params_int8_matches_jax_bit_for_bit(model):
    """Dense kernels (and the attention's 3-d kernels, scaled over every
    axis but the last) to int8 with their scales, an all-zero channel
    included (scale 1); the other leaves pass through; dequantizing and
    the byte count as JAX's."""
    params = random_flax_variables(5, model, **MODELS[model])["params"]
    first = next(k for k in tq._leaves(params) if k[0].endswith("kernel"))[0].split("/")
    node = params
    for key in first:
        node = node[key]
    node[..., 0] = 0.0
    got_q, got_s = tq.quantize_params_int8(params)
    want_q, want_s = jq.quantize_params_int8(params)
    _equal_trees(got_q, want_q)
    assert got_s.keys() == want_s.keys() and len(got_s) > 0
    for k in want_s:
        assert got_s[k].dtype == np.float32 and got_s[k].shape == want_s[k].shape
        np.testing.assert_array_equal(got_s[k], want_s[k])
    assert got_s["/".join(first)][..., 0] == 1.0
    kernels = [k for k, a in tq._leaves(params) if k.endswith("kernel")]
    assert sorted(got_s) == sorted(kernels)
    deq = tq.dequantize_params(jax.tree_util.tree_map(torch.from_numpy, got_q),
                               {k: torch.from_numpy(v) for k, v in got_s.items()})
    jdeq = jq.dequantize_params(jax.tree_util.tree_map(jnp.asarray, want_q),
                                {k: jnp.asarray(v) for k, v in want_s.items()})
    _equal_trees(jax.tree_util.tree_map(lambda t: t.numpy(), deq), jdeq)
    assert tq.param_bytes(got_q) == jq.param_bytes(want_q)
    assert tq.param_bytes(params) == jq.param_bytes(params)
    assert tq.param_bytes(params) / tq.param_bytes(got_q) > 3.0


def test_npz_artifact_loads_in_either_package(tmp_path):
    v = random_flax_variables(6)
    for writer, reader in ((tq, jq), (jq, tq)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.npz")
        writer.save_quantized_checkpoint(path, v["params"], v["batch_stats"])
        got = reader.load_quantized_checkpoint(path)
        want = tq.load_quantized_checkpoint(path)
        want_q, want_s = jq.quantize_params_int8(v["params"])
        _equal_trees(got[0], want_q)
        assert got[1].keys() == want_s.keys()
        for k in want_s:
            np.testing.assert_array_equal(got[1][k], want_s[k])
        _equal_trees(got[2], v["batch_stats"])
        _equal_trees(want[0], got[0])
    path = str(tmp_path / "no_stats.npz")
    tq.save_quantized_checkpoint(path, v["params"])
    assert tq.load_quantized_checkpoint(path)[2] is None


def _clouds(b=3):
    ds = OrientationDataset.synthetic(samples_per_class=1, num_points=N)
    return np.asarray(ds.points[:b], np.float32)


@pytest.mark.parametrize("model", ["pointnet_pp_8dir", "point_transformer"])
def test_int8_predictor_matches_the_jax_int8_predictor(model, tmp_path):
    """The same weights quantized in memory, and the artifact the JAX
    package writes served with ``from_quantized_checkpoint``: the same
    outputs as JAX's int8 predictor within 1e-5; the module holds no f32
    copy of a quantized kernel, and the weights on the device shrink."""
    v = random_flax_variables(8, model, **MODELS[model])
    stats = v["batch_stats"] or None
    kw = dict(num_points=N, max_batch=4)
    jkw = dict(kw, **(MODELS[model] or {"sampling": "first"}))
    pkw = dict(kw, device="cpu", **({} if MODELS[model] else {"sampling": "first"}))
    clouds = _clouds()
    want = np.asarray(JaxPredictor(model, v["params"], stats, quantize="int8", **jkw)(clouds))
    port = OrientationPredictor(model, v["params"], stats, quantize="int8", **pkw)
    np.testing.assert_allclose(port(clouds), want, rtol=1e-5, atol=1e-5)
    path = str(tmp_path / "jax.npz")
    jq.save_quantized_checkpoint(path, v["params"], stats)
    served = OrientationPredictor.from_quantized_checkpoint(path, model, **pkw)
    np.testing.assert_array_equal(served(clouds), port(clouds))
    f32 = OrientationPredictor(model, v["params"], stats, **pkw)
    assert not np.array_equal(f32(clouds), port(clouds))
    kernels = {name for name, _ in port._int8.values()}
    assert kernels and all(p.numel() == 0 for n, p in port.model.named_parameters()
                           if n in kernels)
    assert all(t.dtype == torch.int8 for t in port._quantized.values())
    b8, b32 = port.param_bytes(), f32.param_bytes()
    assert b8["int8"] * 4 == b32["module"] - b8["module"]  # every kernel byte, at a quarter
    assert sum(b8.values()) < 0.4 * b32["module"]


def test_int8_predictor_stays_near_f32():
    """``tests/test_quantize.py``'s envelope on the port: per-direction
    probabilities within 0.01 of the f32 predictor's and the decoded
    forward vectors within 2.5 degrees, on synthetic clouds."""
    v = random_flax_variables(9)
    clouds = _clouds(6)
    kw = dict(num_points=N, seed=0, device="cpu", sampling="first")
    p32 = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)
    p8 = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                              quantize="int8", **kw)
    probs32 = torch.softmax(torch.from_numpy(p32(clouds)), -1).numpy()
    probs8 = torch.softmax(torch.from_numpy(p8(clouds)), -1).numpy()
    assert float(np.abs(probs32 - probs8).max()) < 0.01
    cos = np.clip(np.sum(p32.forward_vectors(clouds) * p8.forward_vectors(clouds), -1), -1, 1)
    assert float(np.degrees(np.arccos(cos)).max()) < 2.5


def test_int8_refusals_and_tta_together(rng):
    """An unknown mode raises as in JAX; ``scales=`` wants int8 kernels;
    int8 and TTA compose (JAX dequantizes, then votes)."""
    v = random_flax_variables(10)
    args = ("pointnet_pp_8dir", v["params"], v["batch_stats"])
    with pytest.raises(ValueError):
        OrientationPredictor(*args, quantize="fp8", device="cpu")
    _, scales = tq.quantize_params_int8(v["params"])
    with pytest.raises(ValueError):
        OrientationPredictor(*args, scales=scales, device="cpu")
    clouds = rng.normal(size=(2, N, 3)).astype(np.float32)
    kw = dict(num_points=N, max_batch=2, sampling="first", tta_views=4, quantize="int8")
    want = np.asarray(JaxPredictor(*args, **kw)(clouds))
    got = OrientationPredictor(*args, device="cpu", **kw)(clouds)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
