"""The port's lockstep protocols (``train/ensemble.py``
``run_per_label_vmapped``, ``train/multiseed.py`` ``run_multi_seed``) and
their checkpoints (``train/protocol_ckpt.py``) against the JAX package's,
on the CPU (the port alone: ``tests/test_torch_protocols_lockstep.py``).

One label (L=1) and one seed (S=1) over one epoch against the JAX
protocols, to the bounds of ``tests/test_ensemble.py`` (1e-5 relative on
best val and the histories, 1e-4 on the test loss), at its sizes (8dir_kl,
128 points, batch 8, 10 chairs: 7 train clouds, one step). Both frameworks
then run the same function: ``rotation_mode="none"`` on clouds of exactly
128 points (no subsample, no rotation draw), the trunk without dropout and
with ``sampling="first"``, the JAX model's initial weights loaded into the
port's, and SGD. One step, because from the second on the JAX float32
step's own error carries over: its gradients lie up to 6e-2 in a leaf's
norm from the float64 step's, the port's up to 1.1e-2
(``tests/test_torch_train_step.py``), and the two trainings' second-step
losses part by about 1e-4 relative (SGD; a train split of 14 clouds at
seed 7). SGD, because Adam turns the rounding noise in the gradients of
the Dense biases that a train BatchNorm normalises, zero in exact
arithmetic, into updates of up to the learning rate: one step then moves
the val loss by about 1e-4 relative under any change of rounding
(``tests/test_torch_train_step.py`` holds those leaves apart). The
artifact files and their JSON keys against the JAX package's; the
checkpoint helpers against the JAX ones; the protocols' errors.
"""

import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pointcloud_orientation_tpu import models as jax_models
from pointcloud_orientation_tpu.data import OrientationDataset as JaxDataset
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import preset as jax_preset
from pointcloud_orientation_tpu.train import protocol_ckpt as jax_pc
from pointcloud_orientation_tpu.train.ensemble import run_per_label_vmapped as jax_per_label
from pointcloud_orientation_tpu.train.multiseed import run_multi_seed as jax_multi_seed
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import protocol_ckpt as PC
from pointcloud_orientation_tpu_torch.train import trainer as TR
from pointcloud_orientation_tpu_torch.train.config import UNPORTED_DEFAULTS
from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed
from pointcloud_orientation_tpu_torch.utils import load_flax_variables

N, B = 128, 8
DETERMINISTIC = dict(sampling="first", p_drop=0.0)  # the port's side of the JAX stand-in


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_per_label.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoDrop8Dir(fnn.Module):
    """PointNetPP8Dir's variable tree with the trunk's dropout off and its
    centroids the first points: the JAX side of a deterministic run."""

    sampling: str = "first"
    grouping: str = "knn"
    bn_axis_name: Optional[str] = None
    dtype: Optional[jnp.dtype] = None

    @fnn.compact
    def __call__(self, xyz, train: bool = False):
        return fnn.Dense(8)(JaxTrunk(p_drop=0.0, sampling="first")(xyz, train=train))


@pytest.fixture
def same_function(monkeypatch):
    """Run the JAX protocols on the deterministic 8-dir model and hand the
    port's trainers the JAX trainer's initial weights (recorded from its
    ``_init_state``, in the order the JAX trainers are built)."""
    monkeypatch.setitem(jax_models.MODEL_REGISTRY, "pointnet_pp_8dir", _NoDrop8Dir)
    inits = []
    real = JaxTrainer._init_state

    def record(self):
        state = real(self)
        inits.append({"params": jax.tree_util.tree_map(np.asarray, state.params),
                      "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})
        return state

    monkeypatch.setattr(JaxTrainer, "_init_state", record)
    queue = []

    def load(model, generator):
        load_flax_variables(model, queue.pop(0))

    monkeypatch.setattr(TR, "flax_dense_init_", load)
    return inits, queue


def _cfg(pkg_preset, **kw):
    return dict(num_points=N, batch_size=B, epochs=1, rotation_mode="none", optimizer="sgd", **kw)


def _close(got, want, rtol_test=1e-4):
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=1e-5)
    assert got["best_val_epoch"] == want["best_val_epoch"]
    for k in ("train", "val"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=rtol_test)


def _json_keys(path):
    with open(path) as f:
        m = json.load(f)
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in m.items()}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _config_keys_match(port_keys, jax_keys):
    assert set(port_keys) == set(jax_keys) - set(UNPORTED_DEFAULTS)


def test_one_label_matches_the_jax_protocol(same_function, tmp_path):
    """L=1 over one epoch against JAX ``run_per_label_vmapped``; the port's
    ``summary.txt`` and ``<label>/metrics.json`` have the JAX files' keys."""
    inits, queue = same_function
    cfg = _cfg("8dir_kl")
    want = jax_per_label(jax_preset("8dir_kl").replace(**cfg),
                         JaxDataset.synthetic(samples_per_class=10, num_points=N),
                         out_dir=str(tmp_path / "jax"), labels=["chair"], log_every=0)
    queue.extend(inits)
    got = run_per_label_vmapped(preset("8dir_kl", **cfg),
                                OrientationDataset.synthetic(samples_per_class=10, num_points=N),
                                out_dir=str(tmp_path / "port"), labels=["chair"], log_every=0,
                                device="cpu", **DETERMINISTIC)
    assert set(got) == {"chair"} and set(got["chair"]) == set(want["chair"])
    _close(got["chair"], want["chair"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == ["chair/metrics.json",
                                                                      "summary.txt"]
    pk, jk = (_json_keys(tmp_path / p / "chair" / "metrics.json") for p in ("port", "jax"))
    _config_keys_match(pk.pop("config"), jk.pop("config"))
    assert pk == jk
    rows = [(tmp_path / p / "summary.txt").read_text().split("\t")[0] for p in ("port", "jax")]
    assert rows == ["chair", "chair"]


def test_one_seed_matches_the_jax_protocol(same_function, tmp_path):
    """S=1 over one epoch against JAX ``run_multi_seed``; the port's
    ``seed_<s>/metrics.json`` and ``seeds_summary.json`` have the JAX keys;
    ``return_params`` gives the best-val weights as a flax tree of the JAX
    tree's layout."""
    inits, queue = same_function
    cfg = _cfg("8dir_kl")
    kw = dict(samples_per_class=10, num_points=N, class_names=["chair"])
    want = jax_multi_seed(jax_preset("8dir_kl").replace(**cfg), JaxDataset.synthetic(**kw),
                          seeds=[7], out_dir=str(tmp_path / "jax"), log_every=0,
                          return_params=True)
    queue.extend(inits)
    got = run_multi_seed(preset("8dir_kl", **cfg), OrientationDataset.synthetic(**kw), seeds=[7],
                         out_dir=str(tmp_path / "port"), log_every=0, return_params=True,
                         device="cpu", **DETERMINISTIC)
    assert set(got) == {7} and set(got[7]) == set(want[7])
    _close(got[7], want[7])
    for tree in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(want[7][tree])[0]
        ours = dict(jax.tree_util.tree_flatten_with_path(got[7][tree])[0])
        assert {jax.tree_util.keystr(p) for p, _ in flat} == {
            jax.tree_util.keystr(p) for p in ours}
        for path, leaf in flat:
            assert ours[path].shape == leaf.shape
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    pk, jk = (_json_keys(tmp_path / p / "seed_7" / "metrics.json") for p in ("port", "jax"))
    _config_keys_match(pk.pop("config"), jk.pop("config"))
    assert pk == jk
    ps, js = (json.loads((tmp_path / p / "seeds_summary.json").read_text())
              for p in ("port", "jax"))
    assert set(ps) == set(js) and ps["seeds"] == js["seeds"] == [7]
    assert {k: set(v) for k, v in ps["aggregate"].items()} == {
        k: set(v) for k, v in js["aggregate"].items()}


def _small_ds():
    return OrientationDataset.synthetic(samples_per_class=7, num_points=N,
                                        class_names=["chair", "bottle"])


def test_checkpoint_helpers_match_the_jax_ones(tmp_path, capsys):
    class Guard:
        requested = True

    saved = []
    for pc in (PC, jax_pc):
        fake = lambda d, e, c, h, k: saved.append((pc.__name__, e))  # noqa: E731
        orig = pc.save_protocol_checkpoint
        pc.save_protocol_checkpoint = fake
        try:
            for epoch, guard, ckpt_dir in [(4, None, "d"), (5, None, "d"), (10, None, "d"),
                                           (3, Guard(), "d"), (10, Guard(), "d"),
                                           (3, Guard(), None)]:
                stop = pc.checkpoint_and_maybe_stop(epoch, 10, None, {}, [], ckpt_dir, 2, guard)
                saved.append((pc.__name__, "stop", epoch, stop))
        finally:
            pc.save_protocol_checkpoint = orig
    ours = [s[1:] for s in saved if s[0] == PC.__name__]
    theirs = [s[1:] for s in saved if s[0] == jax_pc.__name__]
    assert ours == theirs


def test_jax_orbax_carry_is_refused(tmp_path):
    """Once refused, now read: a carry that the JAX package's
    ``save_protocol_checkpoint`` wrote (one member, its Adam chain after an
    update) restores into the port's trainer: weights, Adam moments in the
    torch layout, best-val snapshot, history and epoch."""
    import optax

    from pointcloud_orientation_tpu_torch.utils import random_flax_variables, to_flax_variables

    v, best = random_flax_variables(4), random_flax_variables(5)
    tx = optax.chain(optax.adam(1e-3))
    grads = jax.tree_util.tree_map(lambda a: np.full(np.shape(a), 0.5, np.float32), v["params"])
    opt = jax.tree_util.tree_map(np.asarray, tx.update(grads, tx.init(v["params"]),
                                                       v["params"])[1])
    one = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a)[None], t)  # noqa: E731

    class State:
        step, params, batch_stats, opt_state = (np.ones(1, np.int32), one(v["params"]),
                                                one(v["batch_stats"]), one(opt))

    carry = (State, np.asarray([0.5], np.float32), one(best["params"]),
             one(best["batch_stats"]), np.asarray([3], np.int32))
    hist = {"1": {"train": [1.0, 0.8, 0.7], "val": [0.9, 0.6, 0.5], "train_ang": [1.0] * 3,
                  "val_ang": [2.0] * 3}}
    step = jax_pc.save_protocol_checkpoint(str(tmp_path), 3, carry, hist, ["1"])
    t = Trainer(preset("8dir_kl", num_points=N, batch_size=4), _small_ds(), device="cpu")
    _, history, epoch = PC.restore_protocol_checkpoint(step, [t], [1])
    assert epoch == 3 and t.epoch == 3 and t.step == 1 and history[1] == hist["1"]
    assert t.history["val"] == [0.9, 0.6, 0.5]
    assert (t.best_val, t.best_val_epoch) == (0.5, 3)
    got = to_flax_variables(t.model)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
            {"params": v["params"], "batch_stats": v["batch_stats"]})):
        np.testing.assert_array_equal(a, b)
    mu = opt[0][0].mu["Dense_0"]["kernel"]  # the head: (256, 8), torch (8, 256)
    head = next(m for m in t.model.modules() if isinstance(m, torch.nn.Linear)
                and m.weight.shape == (8, 256))
    np.testing.assert_array_equal(t.optimizer.state[head.weight]["exp_avg"].numpy(), mu.T)
    assert float(t.optimizer.state[head.weight]["step"]) == 1.0


def test_protocol_errors_match_the_jax_ones():
    ds = _small_ds()
    cfg = preset("8dir_kl", num_points=N, batch_size=4, epochs=1)
    with pytest.raises(ValueError, match="duplicate"):
        run_multi_seed(cfg, ds, seeds=[1, 1], device="cpu")
    with pytest.raises(ValueError):
        run_multi_seed(preset("axes_all_labels", num_points=N, batch_size=4), ds, seeds=[1],
                       device="cpu")
    # a member count that does not divide over the mesh's first axis: the JAX message
    # (the stand-in has a two-rank axis; the check runs before any collective)
    with pytest.raises(ValueError, match="seed count 1 must divide over mesh axis 'data' of "
                                         "size 2"):
        run_multi_seed(cfg, ds, seeds=[1], mesh=_TwoRankMesh(), device="cpu")
    with pytest.raises(ValueError, match="label count 1 must divide over mesh axis 'data' of "
                                         "size 2"):
        run_per_label_vmapped(cfg, ds, labels=["chair"], mesh=_TwoRankMesh(), device="cpu")


class _TwoRankMesh:
    """The ``DeviceMesh`` surface ``member_rows`` reads, for an axis of two."""

    mesh_dim_names = ("data",)

    def __getitem__(self, name):
        return self

    def size(self):
        return 2


