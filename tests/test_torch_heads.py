"""The port's yaw-distribution heads against the JAX package's: von Mises
math, the small assignment and the matched MvM loss, the vM and MvM targets,
the losses, ``forward_to_mu``, the three models (``PointNetPPFwd``,
``PointNetPPVonMises``, ``PointNetPPMvM``) from the same flax variables, the
weight interchange, and the predictor's tuple outputs and decode."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pointcloud_orientation_tpu import losses as JL
from pointcloud_orientation_tpu.data import gt as jax_gt
from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.ops import matching as jax_matching
from pointcloud_orientation_tpu.ops import rotations as jax_rot
from pointcloud_orientation_tpu.ops import von_mises as jax_vm
from pointcloud_orientation_tpu_torch import losses as TL
from pointcloud_orientation_tpu_torch.data import gt
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.ops import matching, rotations, von_mises
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)

T = torch.from_numpy


def _angles_and_kappas(rng, n):
    """Angles over several turns, and kappas from 0 (symmetric categories)
    through the reference's clamp (500) to far beyond it."""
    mu = rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32)
    kappa = np.concatenate([[0.0, 1e-7, 1e-3, 0.5, 8.0, 80.0, 499.0, 600.0, 1e4],
                            rng.exponential(10.0, n - 9)]).astype(np.float32)
    return mu, kappa


def test_von_mises_math_matches_jax(rng):
    """f32, the same formulas through scaled Bessels (torch.special vs
    jax.scipy.special, which evaluate them differently): within 1e-5
    relative and 1e-5 absolute."""
    mu_p, kp = _angles_and_kappas(rng, 64)
    mu_q, kq = _angles_and_kappas(rng, 64)
    kq = rng.permutation(kq)
    tol = dict(rtol=1e-5, atol=1e-5)
    for ours, theirs, args in (
            (von_mises.log_i0, jax_vm.log_i0, (kp,)),
            (von_mises.bessel_ratio, jax_vm.bessel_ratio, (kp,)),
            (von_mises.wrap_angle, jax_vm.wrap_angle, (mu_p - mu_q,)),
            (von_mises.kl_von_mises, jax_vm.kl_von_mises, (mu_p, kp, mu_q, kq)),
            (von_mises.von_mises_pdf, jax_vm.von_mises_pdf, (mu_q, mu_p, kp))):
        got = ours(*map(T, args)).numpy()
        want = np.asarray(theirs(*map(jnp.asarray, args)))
        assert np.isfinite(got).all(), ours.__name__
        np.testing.assert_allclose(got, want, err_msg=ours.__name__, **tol)


def test_forward_to_mu_matches_jax(rng):
    f = rng.normal(size=(64, 3)).astype(np.float32)
    f[:4, [0, 2]] = 0.0  # vertical: degenerate, mu = 0
    f[4] = [0.0, 0.0, -1.0]
    np.testing.assert_allclose(rotations.forward_to_mu(T(f)).numpy(),
                               np.asarray(jax_rot.forward_to_mu(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)


def test_hungarian_small_is_optimal_against_scipy(rng):
    """Random costs, every block size 0..4: the total equals
    ``linear_sum_assignment``'s optimum (within f32 rounding of the sums),
    the columns form a permutation of the block, rows beyond it map to
    themselves."""
    B, K = 200, 4
    cost = rng.normal(size=(B, K, K)).astype(np.float32)
    k = rng.integers(0, K + 1, size=B).astype(np.int32)
    col, total = matching.hungarian_small(T(cost), T(k))
    col, total = col.numpy(), total.numpy()
    for b in range(B):
        n = k[b]
        if n == 0:
            assert total[b] == 0.0
        else:
            r, c = linear_sum_assignment(cost[b, :n, :n])
            np.testing.assert_allclose(total[b], cost[b, r, c].sum(), rtol=1e-6, atol=1e-6)
            assert sorted(col[b, :n]) == list(range(n))
            np.testing.assert_allclose(cost[b, np.arange(n), col[b, :n]].sum(), total[b],
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(col[b, n:], np.arange(n, K))


def test_hungarian_small_breaks_ties_as_jax(rng):
    """Small integer costs tie often: equal totals go to the first
    permutation in ``itertools.permutations`` order, as JAX's argmin
    takes them; columns and totals equal exactly."""
    B, K = 300, 4
    cost = rng.integers(0, 3, size=(B, K, K)).astype(np.float32)
    k = rng.integers(0, K + 1, size=B).astype(np.int32)
    col, total = matching.hungarian_small(T(cost), T(k))
    jcol, jtotal = jax_matching.hungarian_small(jnp.asarray(cost), jnp.asarray(k))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    assert list(itertools.permutations(range(K)))[0] == (0, 1, 2, 3)
    assert (col.numpy()[k == 4] == [0, 1, 2, 3]).all(-1).any()  # the all-tie rows


def _mvm_case(rng, B=48, K=4):
    """Predictions and targets as the MvM task makes them: k in 1..4 with
    k = 1 symmetric categories (kappa_gt = 0), zero-padded beyond k."""
    side = rng.normal(size=(B, 3)).astype(np.float32)
    fwd = rng.normal(size=(B, 3)).astype(np.float32)
    k_spec = rng.choice([0, 1, 2, 4], size=B).astype(np.int32)
    mu_gt, kappa_gt, w_gt, k = (np.array(a) for a in jax_gt.mvm_gt(
        jnp.asarray(side), jnp.asarray(fwd), jnp.asarray(k_spec)))
    mu = rng.uniform(-np.pi, np.pi, (B, K)).astype(np.float32)
    kappa = rng.uniform(0.1, 50.0, (B, K)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    return (mu, kappa, w, mu_gt, kappa_gt, k), (side, fwd, k_spec, w_gt)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
def test_matched_mvm_loss_and_its_gradient_match_jax(rng, penalty):
    """Per-sample loss within 1e-5 (relative) and the gradient in mu, kappa
    and the weights within 1e-4 relative and 1e-5 of the largest gradient
    entry (the matching detached on both sides), on a batch with symmetric
    categories (kappa_gt = 0, whose KL is finite through the clamp). The
    weights' gradient ``(cost_i - loss) / sum w`` cancels costs of up to
    ~50 that the two libraries' Bessel functions round differently (about
    1e-6 relative), so its error scales with the largest entry."""
    (mu, kappa, w, mu_gt, kappa_gt, k), _ = _mvm_case(rng)
    assert (kappa_gt[k == 1] == 0).any()

    def jax_loss(mu, kappa, w):
        return jnp.sum(jax_matching.matched_mvm_loss(
            mu, kappa, w, jnp.asarray(mu_gt), jnp.asarray(kappa_gt), jnp.asarray(k),
            unmatched_penalty=penalty))

    want = np.asarray(jax_matching.matched_mvm_loss(
        *map(jnp.asarray, (mu, kappa, w, mu_gt, kappa_gt, k)), unmatched_penalty=penalty))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (mu, kappa, w)))
    leaves = [T(a).requires_grad_() for a in (mu, kappa, w)]
    got = matching.matched_mvm_loss(*leaves, T(mu_gt), T(kappa_gt), T(k),
                                    unmatched_penalty=penalty)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    got.sum().backward()
    for leaf, g in zip(leaves, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(g).max()))


def test_targets_match_jax(rng):
    """``single_peak_gt`` and ``mvm_gt`` (k_spec 0, 1, 2 and 4; max_k 4 and
    2) equal the JAX functions' within f32 rounding of ``atan2``."""
    (_, _, _, _, _, _), (side, fwd, k_spec, _) = _mvm_case(rng)
    symm = rng.random(len(fwd)) < 0.3
    mu, kappa = gt.single_peak_gt(T(fwd), T(symm), 8.0)
    jmu, jkappa = jax_gt.single_peak_gt(jnp.asarray(fwd), jnp.asarray(symm), 8.0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(kappa.numpy(), np.asarray(jkappa))
    for max_k in (4, 2):
        got = gt.mvm_gt(T(side), T(fwd), T(k_spec), 8.0, max_k)
        want = jax_gt.mvm_gt(jnp.asarray(side), jnp.asarray(fwd), jnp.asarray(k_spec), 8.0,
                             max_k)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        assert got[3].dtype == torch.int32


def test_losses_match_jax(rng):
    """The three new objectives, scalar and per sample, within 1e-5."""
    (mu, kappa, w, mu_gt, kappa_gt, k), (_, fwd, _, _) = _mvm_case(rng)
    probs = rng.dirichlet(np.ones(8), size=len(fwd)).astype(np.float32)
    cases = (
        (TL.projected_probs_mse_loss, JL.projected_probs_mse_loss, (fwd, probs), {}),
        (TL.single_peak_vm_kl_loss, JL.single_peak_vm_kl_loss,
         (mu[:, 0], kappa[:, 0], mu_gt[:, 0], kappa_gt[:, 0]), {}),
        (TL.mvm_matched_loss, JL.mvm_matched_loss, (mu, kappa, w, mu_gt, kappa_gt, k),
         {"unmatched_penalty": 0.5}),
    )
    for ours, theirs, args, kw in cases:
        got = ours(*map(T, args), **kw)
        want = theirs(*map(jnp.asarray, args), **kw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                       err_msg=ours.__name__)


# (port model, its kwargs, random_flax_variables kwargs, zero the MvM heads' kernels)
_HEADS = {
    "fwd": ("pointnet_pp_fwd", {}, {}, False),
    "vm-tanh": ("pointnet_pp_von_mises", {"mu_parameterization": "tanh"}, {}, False),
    "vm-atan2": ("pointnet_pp_von_mises", {"mu_parameterization": "atan2"},
                 {"mu_parameterization": "atan2"}, False),
    "mvm-zero": ("pointnet_pp_mvm", {"mu_init": "zero"}, {}, True),
    "mvm-spread": ("pointnet_pp_mvm", {"mu_init": "spread"}, {"mu_init": "spread"}, True),
    "mvm-floor": ("pointnet_pp_mvm", {"weight_floor": 0.1}, {}, False),
}


def _variables(case, seed=7):
    name, _, vkw, zero_heads = _HEADS[case]
    v = random_flax_variables(seed, name, **vkw)
    if zero_heads:  # the flax init of head_pi and head_mu: zero kernels
        for head in ("head_pi", "head_mu"):
            v["params"][head]["kernel"][:] = 0.0
            if head == "head_pi":
                v["params"][head]["bias"][:] = 0.0
        if vkw.get("mu_init") != "spread":
            v["params"]["head_mu"]["bias"][:] = 0.0
    return v


@pytest.mark.parametrize("case", list(_HEADS))
def test_head_outputs_match_jax(rng, case):
    """Each head in eval (CPU plain versions, ``sampling="first"``) against
    the JAX model on the same flax variables and clouds (B=2, N=256):
    outputs within 1e-4, as the 8-dir logits. The zero-init MvM heads take
    the degenerate angle (mu = 0) and uniform weights on both sides."""
    name, kw, _, zero_heads = _HEADS[case]
    v = _variables(case)
    clouds = rng.normal(size=(2, 256, 3)).astype(np.float32)
    want = JAX_MODELS[name](sampling="first", **kw).apply(v, jnp.asarray(clouds))
    want = tuple(np.asarray(x) for x in (want if isinstance(want, tuple) else (want,)))
    model = load_flax_variables(MODEL_REGISTRY[name](sampling="first", **kw), v).eval()
    with torch.no_grad():
        got = model(T(clouds))
    got = tuple(x.numpy() for x in (got if isinstance(got, tuple) else (got,)))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    if case == "fwd":
        np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0, rtol=1e-6)
    if name == "pointnet_pp_mvm":
        np.testing.assert_allclose(got[2].sum(-1), 1.0, rtol=1e-6)
        assert (got[1] > 0).all() and (got[1] <= 80.0).all()
        if case == "mvm-zero":
            np.testing.assert_array_equal(got[0], 0.0)
            np.testing.assert_allclose(got[2], 0.25, rtol=1e-6)


@pytest.mark.parametrize("case", list(_HEADS))
def test_flax_variables_round_trip_and_match_the_flax_tree(case):
    """``random_flax_variables`` has the JAX model's tree (names, shapes;
    the LayerNorm funnel without batch statistics), and ``to_flax_variables``
    of a model loaded from it gives it back exactly."""
    name, kw, vkw, _ = _HEADS[case]
    shapes = jax.eval_shape(lambda: JAX_MODELS[name](**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)), train=False))
    v = random_flax_variables(3, name, **vkw)
    assert jax.tree_util.tree_map(lambda x: x.shape, v) == \
        jax.tree_util.tree_map(lambda x: x.shape, shapes)
    assert model_kwargs(name, v["params"]) == {
        "pointnet_pp_von_mises": {"mu_parameterization": kw.get("mu_parameterization", "tanh")},
        "pointnet_pp_mvm": {"max_K": 4}}.get(name, {})
    model = load_flax_variables(MODEL_REGISTRY[name](**kw), v)
    back = to_flax_variables(model)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(v)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    if vkw.get("mu_init") == "spread":
        np.testing.assert_allclose(v["params"]["head_mu"]["bias"],
                                   [1, 0, 0, 1, -1, 0, 0, -1], atol=1e-7)


@pytest.fixture(scope="module")
def head_predictors():
    kw = dict(num_points=160, max_batch=4, sampling="first")
    out = {}
    for case in ("vm-atan2", "mvm-spread", "fwd"):
        name, model_kw, _, _ = _HEADS[case]
        v = _variables(case, seed=11)
        # the JAX predictor takes the head's options as they are; the port
        # reads what the tree fixes (the vM head's width) from it
        out[case] = (JaxPredictor(name, v["params"], v["batch_stats"], **kw, **model_kw),
                     OrientationPredictor(name, v["params"], v["batch_stats"], device="cpu",
                                          **kw))
    return out


@pytest.mark.parametrize("case", ["vm-atan2", "mvm-spread", "fwd"])
def test_predictor_tuple_outputs_and_decode_match_jax(head_predictors, rng, case):
    """B=6 (two chunks of max_batch 4, the second padded) of 100-point
    clouds (cycled to 160): the native outputs (a tuple of numpy arrays for
    vM and MvM) within 1e-4, and ``forward_vectors`` within 1e-4 and of unit
    length."""
    jax_pred, port = head_predictors[case]
    clouds = rng.normal(size=(6, 100, 3)).astype(np.float32)
    want, got = jax_pred(clouds), port(clouds)
    assert isinstance(got, tuple) == isinstance(want, tuple) == (case != "fwd")
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert isinstance(g, np.ndarray) and g.shape == np.shape(w) and g.shape[0] == 6
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    fwd = port.forward_vectors(clouds)
    np.testing.assert_allclose(fwd, jax_pred.forward_vectors(clouds), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, rtol=1e-6)
