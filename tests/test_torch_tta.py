"""Yaw-voting test-time augmentation in the port's OrientationPredictor, and
the von Mises moment matching it needs, against the JAX package.

Every family the JAX predictor votes for is served by both predictors on
the same weights (``random_flax_variables``) and clouds with
``sampling="first"`` (the trunk heads then pick the same centroids in both
frameworks): 8-dir at V in (2, 4, 8), the vector heads
(``pointnet_pp_fwd``, ``simple_pointnet``, ``point_transformer``; the
combine is the same for ``pointnet_pp``), the two-axis head with
Gram-Schmidt (the same combine as ``pointnet_pp_xyz``), von Mises (tanh and
atan2) and MvM. Tolerances: 1e-5
relative (and absolute, for entries near 0) on logits, vectors, weights
and kappas of the heads; the vM head's moment-matched kappa 1e-4 relative,
from the four Newton steps; its mu 1e-4 absolute, as ``atan2`` of the
views' mean resultant, which is short where the views disagree (random
weights are not yaw-equivariant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.ops import von_mises as jvm
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.ops import von_mises as tvm
from pointcloud_orientation_tpu_torch.utils import random_flax_variables

B, N = 3, 128  # bucket 4: one padded cloud goes through the views too
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


def _r_grid():
    """Mean resultants from 0 to A(500) (kappa 0 to 500), a few past it and
    the clip's edge."""
    kappa = np.concatenate([[0.0], np.geomspace(1e-4, 500.0, 200)]).astype(np.float32)
    r = np.asarray(jvm.bessel_ratio(jnp.asarray(kappa)))
    return np.concatenate([r, np.asarray([0.9995, 0.99999, 1.0 - 1e-6, 1.0], np.float32)])


def test_inv_bessel_ratio_matches_jax():
    """Kappa within 1e-4 relative up to 250 and 2.5e-4 above: the inverse
    amplifies a relative change of r by about 2 kappa, and the two
    frameworks' ``i0e``/``i1e`` differ by up to 3.1e-7 relative in A
    (JAX's own float32 inverse lies 1.8e-4 from the kappa it inverts at
    500); A of the two answers agrees within 2^-21 of r everywhere."""
    r = _r_grid()
    for iters in (4, 0, 1, 8):
        want = np.asarray(jvm.inv_bessel_ratio(jnp.asarray(r), iters))
        got = tvm.inv_bessel_ratio(torch.from_numpy(r), iters).numpy()
        assert got[0] == 0.0
        rtol = np.where(want > 250, 2.5e-4, KAPPA_RTOL)
        err = np.abs(got - want)
        assert np.all(err <= rtol * want + 1e-6), (iters, np.max(err / np.maximum(want, 1e-6)))
        if iters == 4:
            a_got = np.asarray(jvm.bessel_ratio(jnp.asarray(got)))
            a_want = np.asarray(jvm.bessel_ratio(jnp.asarray(want)))
            np.testing.assert_allclose(a_got, a_want, rtol=0, atol=2.0 ** -21)


@pytest.mark.parametrize("weighted", [False, True], ids=["equal", "weighted"])
def test_moment_match_and_mixture_pdf_match_jax(rng, weighted):
    """Mixtures of 1 to 8 components with kappa in [0, 500] (both ends
    included) along the first axis, equal or given weights; then the
    mixture density on a grid."""
    mu = rng.uniform(-np.pi, np.pi, size=(8, 16)).astype(np.float32)
    kappa = np.concatenate([[0.0, 500.0], rng.uniform(0, 500, 126)]).reshape(8, 16)
    kappa = kappa.astype(np.float32)
    kappa[:, :4] = rng.uniform(0, 2, size=(8, 4))  # near-uniform components
    w = rng.dirichlet(np.ones(8), size=16).T.astype(np.float32) if weighted else None
    args = [mu, kappa] + ([w] if weighted else [])
    want = jvm.vm_mixture_moment_match(*map(jnp.asarray, args), axis=0)
    got = tvm.vm_mixture_moment_match(*map(torch.from_numpy, args), dim=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=MU_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=KAPPA_RTOL, atol=1e-6)
    theta = np.linspace(0, 2 * np.pi, 73)[:-1].astype(np.float32)
    wk = w if weighted else np.full_like(mu, 1 / 8)
    want = jvm.mixture_von_mises_pdf(jnp.asarray(theta), jnp.asarray(mu.T),
                                     jnp.asarray(np.minimum(kappa, 80).T), jnp.asarray(wk.T))
    got = tvm.mixture_von_mises_pdf(torch.from_numpy(theta), torch.from_numpy(mu.T),
                                    torch.from_numpy(np.minimum(kappa, 80).T),
                                    torch.from_numpy(wk.T))
    assert got.shape == (16, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# (model, views, random_flax_variables / predictor options)
FAMILIES = [
    ("pointnet_pp_8dir", 2, {}), ("pointnet_pp_8dir", 4, {}), ("pointnet_pp_8dir", 8, {}),
    ("pointnet_pp_fwd", 4, {}), ("simple_pointnet", 5, {}),
    ("point_transformer", 3, SMALL_PT), ("pointnet_pp_xyz_schmidt", 4, {}),
    ("pointnet_pp_von_mises", 4, {}),
    ("pointnet_pp_von_mises", 3, {"mu_parameterization": "atan2"}),
    ("pointnet_pp_mvm", 3, {}),
]


def _serve(model, views, kw, clouds, seed=7):
    v = random_flax_variables(seed, model, **kw)
    jkw = dict(num_points=N, max_batch=4, tta_views=views)
    if model.startswith("pointnet_pp"):
        jkw["sampling"] = "first"
    if model == "pointnet_pp_von_mises":
        jkw.update(kw)
    if model == "point_transformer":
        jkw.update({k: kw[k] for k in ("embed_dim", "num_heads", "depth", "ffn_dim")})
    jax_pred = JaxPredictor(model, v["params"], v["batch_stats"] or None, **jkw)
    want = jax.tree_util.tree_map(np.asarray, jax_pred(clouds))
    port = OrientationPredictor(model, v["params"], v["batch_stats"] or None, device="cpu",
                                **{k: a for k, a in jkw.items() if k not in SMALL_PT
                                   and k != "mu_parameterization"})
    return port, jax_pred, port(clouds), want


@pytest.mark.parametrize("model, views, kw", FAMILIES,
                         ids=[f"{m}-V{v}{'-atan2' if kw.get('mu_parameterization') else ''}"
                              for m, v, kw in FAMILIES])
def test_tta_matches_the_jax_predictor(model, views, kw, rng):
    clouds = rng.normal(size=(B, N, 3)).astype(np.float32)
    port, jax_pred, got, want = _serve(model, views, kw, clouds)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.shape for g in got] == [w.shape for w in want]
    if model == "pointnet_pp_von_mises":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=MU_ATOL)
        np.testing.assert_allclose(got[1], want[1], rtol=KAPPA_RTOL, atol=1e-7)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=VEC_TOL, atol=VEC_TOL)
    if model == "pointnet_pp_mvm":
        k = random_flax_variables(7, model)["params"]["head_pi"]["kernel"].shape[1]
        assert got[0].shape == (B, views * k)
        np.testing.assert_allclose(got[2].sum(-1), 1.0, rtol=1e-6)
        theta = np.linspace(0, 2 * np.pi, 91)[:-1].astype(np.float32)
        dens = tvm.mixture_von_mises_pdf(torch.from_numpy(theta), *map(torch.from_numpy, got))
        jdens = jvm.mixture_von_mises_pdf(jnp.asarray(theta), *map(jnp.asarray, want))
        np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.forward_vectors(clouds), jax_pred.forward_vectors(clouds),
                               rtol=1e-4, atol=MU_ATOL)


def test_eight_dir_views_vote_by_slot_shift(rng):
    """An 8-dir request's voted log-probabilities are the mean of its views'
    softmax rolled back by 8/V slots a view: the single-view predictor on
    each rotated cloud, combined by hand, gives the same numbers."""
    v = random_flax_variables(3)
    clouds = rng.normal(size=(4, N, 3)).astype(np.float32)
    kw = dict(num_points=N, max_batch=4, sampling="first", device="cpu")
    tta = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], tta_views=4,
                               **kw)(clouds)
    one = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)
    probs = []
    for i in range(4):
        t = np.float32(i * 2 * np.pi / 4)
        c, s = np.cos(t), np.sin(t)
        rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        p = torch.softmax(torch.from_numpy(one(clouds @ rot.T)), -1).numpy()
        probs.append(np.roll(p, 2 * i, axis=-1))
    np.testing.assert_allclose(tta, np.log(np.mean(probs, 0) + 1e-12), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model, views", [("pointnet_pp_8dir", 3), ("pointnet_pp_8dir", 16),
                                          ("pointnet_pp_cls", 2), ("pointnet", 2),
                                          ("pointnet_cls", 4), ("pointnet_pp_8dir", 0)])
def test_tta_refuses_as_the_jax_predictor_does(model, views):
    v = random_flax_variables(0, model)
    for cls, kw in ((JaxPredictor, {}), (OrientationPredictor, {"device": "cpu"})):
        with pytest.raises(ValueError):
            cls(model, v["params"], v["batch_stats"], tta_views=views, **kw)
