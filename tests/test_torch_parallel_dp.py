"""Data parallelism in the port's ``Trainer`` and predictor (``mesh=``) as
gloo ranks at world size 2 and 4.

The JAX trainer's DP is global-batch arithmetic, so a DP epoch equals the
one-device epoch at every mesh size (``tests/test_resume_and_parallel.py``,
params within 2e-5 and the loss within 1e-5, with SGD). The port's is held
the same way against its own one-device epoch (which the train-step tests
hold against the JAX step): on ``simple_pointnet`` (BatchNorm in every
layer, 11 train clouds at B=8, so the last batch is partial) at those
bounds, and on the PointNet++ 8-dir preset in both train configurations
more loosely (below). Its global BatchNorm statistics are held against the
JAX model's train forward on the virtual mesh, and sharded serving
against the JAX predictor on the mesh and the port's own meshless
predictor. At world size 1 the DP path is bit-equal to one device.
"""

from typing import Optional

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from flax import linen as nn
from jax.sharding import NamedSharding, PartitionSpec as P

from pointcloud_orientation_tpu import data as jax_data
from pointcloud_orientation_tpu import models as jax_models
from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.models import PointNetPP8Dir as JaxPP8Dir
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import preset as jax_preset
from pointcloud_orientation_tpu_torch import parallel as TP
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables
import torch_parallel_ranks as R

WORLDS = (2, 4)
# The 8-dir trunk's gradient passes a max over 32 neighbours: which neighbour
# takes a channel's maximum follows values that the two summation orders of the
# same global batch (BatchNorm's moments, the gradient sum) round differently,
# so near-ties route some gradient through other rows. In float64 the DP epoch
# agrees with the one-device epoch to 4e-16 on the weights and 1.2e-13 on the
# first step's gradient at world size 4 (``python -m
# pointcloud_orientation_tpu_torch.parallel.dp_gap --device cpu --dtype float64
# --world 4 --num-points 128 --batch-size 8 --classes chair sofa``, seeds 0-2),
# so the float32 gap is that rounding. One SGD epoch at lr 1e-3 read 7.2e-5 on
# the weights and 1.5e-5 relative on the loss at world size 4, 1.5e-6 at 2; the
# bounds leave room for that.
PP_PARAM_ATOL, PP_LOSS_RTOL = 2e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("dp", WORLDS)


@pytest.fixture(scope="module")
def one_device():
    return {name: R.dp_epoch(name) for name in R.DP_CONFIGS}


@pytest.mark.parametrize("name", list(R.DP_CONFIGS))
@pytest.mark.parametrize("n", WORLDS)
def test_dp_epoch_equals_one_device(ranks, one_device, n, name):
    got, want = ranks[n]["epochs"][name], one_device[name]
    atol, rtol = (2e-5, 1e-5) if name == "simple_pointnet" else (PP_PARAM_ATOL, PP_LOSS_RTOL)
    assert set(got["state"]) == set(want["state"])
    for key in want["state"]:
        np.testing.assert_allclose(got["state"][key], want["state"][key], atol=atol,
                                   err_msg=key)
    assert got["history"]["train"][0] == pytest.approx(want["history"]["train"][0], rel=rtol)
    assert got["history"]["val"][0] == pytest.approx(want["history"]["val"][0], rel=rtol)


def test_dp_at_world_size_one_is_bit_equal(one_device):
    """A one-rank mesh runs every collective of the DP path and changes no
    bit: the draws, the statistics, the loss, the gradients, the history."""
    mesh = TP.make_mesh(("data",), device="cpu")
    try:
        for name in ("simple_pointnet", "8dir_kl_fused"):
            got, want = R.dp_epoch(name, mesh), one_device[name]
            for key in want["state"]:
                np.testing.assert_array_equal(got["state"][key], want["state"][key])
            assert got["history"] == want["history"]
    finally:
        dist.destroy_process_group()


class _NoDropPP8Dir(nn.Module):
    """PointNetPP8Dir's tree with dropout off and first-point sampling (the
    fields the JAX Trainer reads off the model it builds)."""

    sampling: str = "first"
    grouping: str = "knn"
    bn_axis_name: Optional[str] = None
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, xyz, train: bool = False):
        return nn.Dense(8)(JaxTrunk(p_drop=0.0, sampling="first")(xyz, train=train))


@pytest.mark.parametrize("n", WORLDS)
def test_global_batch_norm_matches_jax_on_the_mesh(ranks, n):
    """The train forward on the ranks' rows, with BatchNorm's moments
    all-reduced, against the JAX model's train forward on the batch
    sharded over n devices (XLA's global statistics): the logits and the
    updated running statistics."""
    v = random_flax_variables(5)
    x = R.clouds(11, 8, 128)
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    apply = jax.jit(lambda variables, pts: _NoDropPP8Dir().apply(
        variables, pts, train=True, mutable=["batch_stats"]))
    logits, mut = jax.block_until_ready(apply(v, xs))
    got = ranks[n]["train_forward"]
    np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=1e-4, atol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(mut["batch_stats"])
    have = jax.tree_util.tree_leaves_with_path(got["batch_stats"])
    assert [p for p, _ in want] == [p for p, _ in have]
    for (path, w), (_, h) in zip(want, have):
        np.testing.assert_allclose(h, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=str(path))


def _jax_dp_step(n, monkeypatch):
    """The JAX Trainer's epoch of ``R.JAX_STEP_CFG`` (one step) on n virtual
    devices, on the deterministic model, from the port's shared weights, in
    float64."""
    monkeypatch.setitem(jax_models.MODEL_REGISTRY, "pointnet_pp_8dir", _NoDropPP8Dir)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               random_flax_variables(R.JAX_STEP_WEIGHTS))
    real = JaxTrainer._init_state

    def init(self):
        state = real(self)
        params, stats = (jax.tree_util.tree_map(jnp.asarray, v[k])
                         for k in ("params", "batch_stats"))
        return JP.replicate(state.replace(params=params, batch_stats=stats,
                                          opt_state=self.tx.init(params)), self.mesh)

    monkeypatch.setattr(JaxTrainer, "_init_state", init)
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    with jax.enable_x64(True):
        tr = JaxTrainer(jax_preset("8dir_kl").replace(**R.JAX_STEP_CFG),
                        R.jax_step_dataset(jax_data), mesh=mesh)
        tr.fit(epochs=1, log_every=0)
        after = jax.tree_util.tree_map(np.asarray, (tr.state.params, tr.state.batch_stats))
    assert after[0]["Dense_0"]["kernel"].dtype == np.float64
    grads = jax.tree_util.tree_map(lambda p0, p1: (p0 - p1) / R.JAX_STEP_CFG["lr"],
                                   v["params"], after[0])
    return tr, grads, after[1]


@pytest.mark.parametrize("n", WORLDS)
def test_dp_step_matches_the_jax_trainer_on_the_mesh(ranks, n, monkeypatch):
    """One step of the DP Trainer on n gloo ranks against the JAX Trainer's
    step on n devices of the virtual mesh, both from the same weights on
    the same deterministic model (``R.JAX_STEP_CFG``): 7 train clouds at
    B=8, so the batch is partial (one padded row, on the last rank) and
    the valid count is global. The step's loss, its gradient (the JAX one
    read back from the SGD update at lr 1) and BatchNorm's running
    statistics after it (the global batch's moments), at the JAX DP test's
    bounds. Both in float64: in float32 the two frameworks' steps part by
    rounding carried through the max over neighbours (4.1e-3 on a
    BatchNorm bias's gradient at n=2, read in this comparison), as two
    summation orders of the port's own step do
    (``parallel/dp_gap.py``)."""
    tr, grads, stats = _jax_dp_step(n, monkeypatch)
    got = ranks[n]["jax_step"]
    assert got["steps"] == int(tr.state.step) == 1
    assert got["history"]["train"][0] == pytest.approx(tr.history["train"][0], rel=1e-5)
    for name, want, have in (("grads", grads, got["grads"]), ("batch_stats", stats,
                                                               got["batch_stats"])):
        want_l = jax.tree_util.tree_leaves_with_path(want)
        have_l = jax.tree_util.tree_leaves_with_path(have)
        assert [p for p, _ in want_l] == [p for p, _ in have_l], name
        for (path, w), (_, h) in zip(want_l, have_l):
            assert h.dtype == np.float64, (name, path)
            np.testing.assert_allclose(h, w, atol=2e-5, err_msg=f"{name} {path}")


def test_bn_sync_axis_raises_in_both():
    """The JAX model with ``bn_axis_name="data"`` (what the JAX Trainer
    builds for ``bn_sync_axis``) fails under a jitted train step, mesh or
    not (the axis is unbound); the port's Trainer refuses the field."""
    v = random_flax_variables(0)
    mesh = JP.make_mesh(("data",), (2,), jax.devices()[:2])
    x = jax.device_put(R.clouds(1, 4, 128), NamedSharding(mesh, P("data")))
    with pytest.raises(NameError):
        jax.jit(lambda variables, pts: JaxPP8Dir(bn_axis_name="data").apply(
            variables, pts, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}))(v, x)
    with pytest.raises(ValueError, match="global batch"):
        Trainer(preset("8dir_kl", bn_sync_axis="data"), R.small_dataset(), device="cpu")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_serving(ranks, n):
    """Every rank returns the whole request: with first-point sampling the
    JAX predictor's on the mesh; with random centroids (drawn at the whole
    bucket's shape) the meshless predictor's, bit for bit; above
    ``max_batch`` in chunks; TTA with a mesh raises the JAX ValueError."""
    v = random_flax_variables(3)
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    jax_pred = JaxPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], num_points=256,
                            max_batch=8, seed=1, mesh=mesh, sampling="first")
    req, big = R.clouds(12, 5, 300), R.clouds(13, 13, 300)
    np.testing.assert_allclose(ranks[n]["serve"]["first"], np.asarray(jax_pred(req)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ranks[n]["serve_chunks"], np.asarray(jax_pred(big)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ranks[n]["serve"]["random"],
                                  R.serving_predictor(None, "random")(req))
    with pytest.raises(ValueError) as e:
        JaxPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], mesh=mesh, tta_views=2)
    assert ranks[n]["serve_tta_error"] == str(e.value)


def test_bucket_rounds_up_to_the_axis_as_the_jax_one():
    """Buckets are multiples of the axis size and the clamp too (JAX
    ``_bucket``), read through a stand-in of the axis size."""
    from pointcloud_orientation_tpu_torch.infer import OrientationPredictor

    pred = R.serving_predictor(None, "first")
    v = random_flax_variables(3)
    for axis, max_batch in ((1, 8), (2, 8), (4, 6), (4, 24), (8, 5)):
        mesh = JP.make_mesh(("data",), (axis,), jax.devices()[:axis])
        jax_pred = JaxPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                max_batch=max_batch, mesh=mesh)
        pred._axis_size, pred.max_batch = axis, max_batch
        for b in (1, 3, 5, 8, 9):
            assert OrientationPredictor._bucket(pred, b) == jax_pred._bucket(b), (axis, b)


def _cli(tmp, *extra):
    return ["--preset", "simple_pointnet", "--device", "cpu", "--epochs", "1", "--num-points",
            "128", "--batch-size", "4", "--out", str(tmp), *extra]


def test_cli_mesh_starts_the_ranks_itself(tmp_path):
    """``--mesh data:2`` launched alone starts two gloo ranks of the same
    command; rank 0 alone reports and writes the run's artifacts, whose
    history follows the meshless run's. The CLI trains the preset's Adam,
    whose early steps are near ``lr * sign(g)``: summation-order noise in a
    near-zero gradient moves a weight by up to the rate, so the epoch is
    held at 1e-2 here (the DP epoch tests use SGD, as the JAX ones, for
    the 2e-5 bound)."""
    import json
    import os
    import subprocess
    import sys

    from pointcloud_orientation_tpu_torch.train import run

    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": R.ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run([sys.executable, "-m", "pointcloud_orientation_tpu_torch.train.run",
                           *_cli(tmp_path / "dp", "--mesh", "data:2")], env=env, cwd=R.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert done.stdout.count("test loss") == 1  # rank 0 alone reports
    run.main(_cli(tmp_path / "one"))
    got, want = (json.loads((tmp_path / d / "metrics.json").read_text())["history"]
                 for d in ("dp", "one"))
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2)


def test_cli_mesh_above_the_card_count_raises():
    from pointcloud_orientation_tpu_torch.train import run

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="needs 2 cards, this machine has 0: NCCL"):
        run.main(["--preset", "8dir_kl", "--mesh", "data:2", "--epochs", "1"])
    with pytest.raises(SystemExit, match="'data:N'"):
        run.main(["--preset", "8dir_kl", "--mesh", "model:2", "--device", "cpu"])
