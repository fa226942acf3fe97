"""Deep-ensemble serving in the port's OrientationPredictor against the JAX
package's ``OrientationPredictor(ensemble_size=S)``, on the CPU.

Every head family with a combine is served by both predictors from the same
S flax trees (``random_flax_variables`` with S seeds, through
``from_seed_sweep``) on the same clouds, ``sampling="first"`` on the trunk
heads (both frameworks then pick the same centroids), alone and with
yaw-voting TTA (the joint S * V combine). Tolerances are those of
``tests/test_torch_tta.py``: 1e-5 relative and absolute on logits,
vectors, weights and kappas; the vM head's moment-matched kappa 1e-4
relative and its mu 1e-4 absolute. The MvM mixture's S * V * K components
are checked one by one against the single members' outputs, member-major
then view, as the JAX ``moveaxis`` orders them. Then
``from_protocol_checkpoint`` on the port's own multi-seed checkpoint, its
label-key rejection and its exclusion of a member whose val loss never
improved, and the ``ValueError``\\ s of both predictors.
"""

import pickle
import warnings

import jax
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.train import preset
from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed
from pointcloud_orientation_tpu_torch.utils import random_flax_variables

B, N = 3, 128  # bucket 4: one padded cloud goes through the members too
VEC_TOL = 1e-5
KAPPA_RTOL = 1e-4
MU_ATOL = 1e-4
SMALL_PT = dict(embed_dim=32, num_heads=4, depth=2, ffn_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _members(model, seeds, kw):
    out = []
    for s in seeds:
        v = random_flax_variables(s, model, **kw)
        out.append({"params": v["params"], "batch_stats": v["batch_stats"] or None})
    return out


def _opts(model, kw, views):
    jkw = dict(num_points=N, max_batch=4, tta_views=views)
    if model.startswith("pointnet_pp"):
        jkw["sampling"] = "first"
    if model == "pointnet_pp_von_mises":
        jkw.update(kw)
    if model == "point_transformer":
        jkw.update({k: kw[k] for k in ("embed_dim", "num_heads", "depth", "ffn_dim")})
    port = {k: a for k, a in jkw.items() if k not in SMALL_PT and k != "mu_parameterization"}
    return jkw, dict(port, device="cpu")


# (model, members, views, random_flax_variables options)
FAMILIES = [
    ("pointnet_pp_8dir", 3, 1, {}), ("pointnet_pp_8dir", 2, 4, {}),
    ("pointnet_pp_fwd", 3, 1, {}), ("simple_pointnet", 2, 3, {}),
    ("point_transformer", 2, 2, SMALL_PT), ("pointnet_pp_xyz_schmidt", 2, 2, {}),
    ("pointnet_pp_von_mises", 3, 1, {}),
    ("pointnet_pp_von_mises", 2, 3, {"mu_parameterization": "atan2"}),
    ("pointnet_pp_mvm", 3, 1, {}), ("pointnet_pp_mvm", 2, 3, {}),
]


@pytest.mark.parametrize("model, S, views, kw", FAMILIES,
                         ids=[f"{m}-S{s}-V{v}" for m, s, v, _ in FAMILIES])
def test_ensemble_matches_the_jax_predictor(model, S, views, kw, rng):
    clouds = rng.normal(size=(B, N, 3)).astype(np.float32)
    members = _members(model, range(11, 11 + S), kw)
    jkw, pkw = _opts(model, kw, views)
    jax_pred = JaxPredictor.from_seed_sweep(model, members, **jkw)
    port = OrientationPredictor.from_seed_sweep(model, members, **pkw)
    assert port.ensemble_size == jax_pred.ensemble_size == S and len(port.members) == S
    got, want = port(clouds), jax.tree_util.tree_map(np.asarray, jax_pred(clouds))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.shape for g in got] == [w.shape for w in want]
    if model == "pointnet_pp_von_mises":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=MU_ATOL)
        np.testing.assert_allclose(got[1], want[1], rtol=KAPPA_RTOL, atol=1e-7)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=VEC_TOL, atol=VEC_TOL)
    np.testing.assert_allclose(port.forward_vectors(clouds), jax_pred.forward_vectors(clouds),
                               rtol=1e-4, atol=MU_ATOL)


def test_mvm_components_are_member_major_then_view():
    """S=2 members by V=3 views of K components: output component ``(s * V
    + v) * K + k`` is member s's component k on view v (its mu shifted by
    the view's angle and wrapped), its weight divided by S * V."""
    S, V = 2, 3
    clouds = np.random.default_rng(5).normal(size=(B, N, 3)).astype(np.float32)
    members = _members("pointnet_pp_mvm", (21, 22), {})
    kw = dict(num_points=N, max_batch=4, sampling="first", device="cpu")
    mu, kappa, w = OrientationPredictor.from_seed_sweep("pointnet_pp_mvm", members,
                                                        tta_views=V, **kw)(clouds)
    K = mu.shape[1] // (S * V)
    for s, m in enumerate(members):
        single = OrientationPredictor("pointnet_pp_mvm", m["params"], m["batch_stats"], **kw)
        for v in range(V):
            t = np.float32(v * 2 * np.pi / V)
            c, si = np.cos(t), np.sin(t)
            rot = np.asarray([[c, 0, si], [0, 1, 0], [-si, 0, c]], np.float32)
            m_mu, m_kappa, m_w = single(clouds @ rot.T)
            cols = slice((s * V + v) * K, (s * V + v + 1) * K)
            d = np.mod(mu[:, cols] - (m_mu + t) + np.pi, 2 * np.pi) - np.pi
            assert np.abs(d).max() <= 1e-4, (s, v)
            np.testing.assert_allclose(kappa[:, cols], m_kappa, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(w[:, cols], m_w / (S * V), rtol=1e-4, atol=1e-6)


def test_members_share_the_sampling_draws():
    """With random centroids every member draws from the same generator
    state, as the JAX predictor passes one ``rng`` to every member: an
    ensemble of S copies of one member equals that member's own predictor
    (the 8-dir combine of equal members is the log of its probabilities),
    request after request."""
    m = _members("pointnet_pp_8dir", (4,), {})[0]
    kw = dict(num_points=N, max_batch=4, seed=9, device="cpu")
    ens = OrientationPredictor.from_seed_sweep("pointnet_pp_8dir", [m] * 3, **kw)
    one = OrientationPredictor("pointnet_pp_8dir", m["params"], m["batch_stats"], **kw)
    clouds = np.random.default_rng(6).normal(size=(B, N, 3)).astype(np.float32)
    for _ in range(2):
        got = ens(clouds)
        want = torch.log_softmax(torch.from_numpy(one(clouds)), -1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model, kwargs", [
    ("pointnet_pp_cls", {}), ("pointnet", {}), ("pointnet_cls", {}),
    ("pointnet_pp_8dir", {"quantize": "int8"}), ("pointnet_pp_8dir", {"ensemble_size": 0}),
], ids=["cls", "pointnet", "pointnet_cls", "int8", "zero"])
def test_ensembles_refuse_as_the_jax_predictor_does(model, kwargs):
    """A head with no combine, int8 weights and a count below 1 raise
    ``ValueError`` in both predictors; the port also refuses weights without
    the leading member axis, and a mesh (not ported)."""
    v = random_flax_variables(0, model)
    stacked = jax.tree_util.tree_map(lambda a: np.stack([a, a]), v)
    kw = {"ensemble_size": 2, **kwargs}
    for cls, extra in ((JaxPredictor, {}), (OrientationPredictor, {"device": "cpu"})):
        with pytest.raises(ValueError):
            cls(model, stacked["params"], stacked["batch_stats"] or None, **kw, **extra)
    with pytest.raises(ValueError, match="member axis"):
        OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], ensemble_size=2,
                             device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        OrientationPredictor.from_seed_sweep("pointnet_pp_8dir", [])
    with pytest.raises(NotImplementedError):
        OrientationPredictor.from_seed_sweep("pointnet_pp_8dir", [v, v], mesh=object(),
                                             device="cpu")


class _Fire:
    requested = True


def _protocol_ckpt(tmp_path, seeds=(1, 2)):
    """A one-epoch multi-seed run preempted on its only block: it completes
    and saves ``step_1``; returns the run's results with each seed's
    best-val weights."""
    cfg = preset("8dir_kl", num_points=N, batch_size=4, epochs=1, classes=("chair",))
    ds = OrientationDataset.synthetic(samples_per_class=7, num_points=N, class_names=["chair"])
    res = run_multi_seed(cfg, ds, seeds=list(seeds), log_every=0, device="cpu",
                         checkpoint_dir=str(tmp_path), preemption_guard=_Fire(),
                         return_params=True)
    return res, str(tmp_path / "step_1")


def test_from_protocol_checkpoint_serves_the_sweep(tmp_path):
    """The multi-seed checkpoint's members serve as the ensemble: equal to
    ``from_seed_sweep`` over the run's returned best-val weights, bit for
    bit; ``members=[1]`` equals the single predictor of seed 2."""
    res, step = _protocol_ckpt(tmp_path)
    kw = dict(num_points=N, max_batch=4, sampling="first", device="cpu")
    clouds = np.random.default_rng(7).normal(size=(B, N, 3)).astype(np.float32)
    got = OrientationPredictor.from_protocol_checkpoint(step, "pointnet_pp_8dir", **kw)
    want = OrientationPredictor.from_seed_sweep("pointnet_pp_8dir", [res[1], res[2]], **kw)
    assert got.ensemble_size == 2
    np.testing.assert_array_equal(got(clouds), want(clouds))
    one = OrientationPredictor.from_protocol_checkpoint(step, "pointnet_pp_8dir", members=[1],
                                                        **kw)
    single = OrientationPredictor("pointnet_pp_8dir", res[2]["params"], res[2]["batch_stats"],
                                  **kw)
    assert one.ensemble_size == 1
    np.testing.assert_array_equal(one(clouds), single(clouds))
    with pytest.raises(ValueError):
        OrientationPredictor.from_protocol_checkpoint(step, "pointnet_pp_fwd", **kw)


def test_from_protocol_checkpoint_drops_a_diverged_member_and_refuses_labels(tmp_path):
    """A member whose saved best val is not finite is left out, with a
    warning (all of them: ``ValueError``); a per-label checkpoint's keys are
    refused unless ``allow_label_keys=True``."""
    res, step = _protocol_ckpt(tmp_path / "s")
    with open(f"{step}/carry.pt", "rb") as f:
        carry = torch.load(f, weights_only=False)
    carry["members"][0]["best_val"] = float("inf")
    torch.save(carry, f"{step}/carry.pt", pickle_protocol=pickle.HIGHEST_PROTOCOL)
    kw = dict(num_points=N, max_batch=4, sampling="first", device="cpu")
    clouds = np.random.default_rng(8).normal(size=(B, N, 3)).astype(np.float32)
    with pytest.warns(UserWarning, match="excluding"):
        pred = OrientationPredictor.from_protocol_checkpoint(step, "pointnet_pp_8dir", **kw)
    single = OrientationPredictor("pointnet_pp_8dir", res[2]["params"], res[2]["batch_stats"],
                                  **kw)
    np.testing.assert_array_equal(pred(clouds), single(clouds))
    carry["members"][1]["best_val"] = float("nan")
    torch.save(carry, f"{step}/carry.pt")
    with warnings.catch_warnings(), pytest.raises(ValueError, match="no usable"):
        warnings.simplefilter("ignore")
        OrientationPredictor.from_protocol_checkpoint(step, "pointnet_pp_8dir", **kw)

    cfg = preset("8dir_kl", num_points=N, batch_size=4, epochs=1)
    ds = OrientationDataset.synthetic(samples_per_class=7, num_points=N,
                                      class_names=["chair", "sofa"])
    run_per_label_vmapped(cfg, ds, log_every=0, device="cpu", checkpoint_dir=str(tmp_path / "l"),
                          preemption_guard=_Fire())
    labels = str(tmp_path / "l" / "step_1")
    with pytest.raises(ValueError, match="per-LABEL"):
        OrientationPredictor.from_protocol_checkpoint(labels, "pointnet_pp_8dir", **kw)
    pred = OrientationPredictor.from_protocol_checkpoint(labels, "pointnet_pp_8dir",
                                                         allow_label_keys=True, **kw)
    assert pred.ensemble_size == 2
