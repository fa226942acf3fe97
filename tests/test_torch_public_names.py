"""The port's public names held against the JAX package: the four functions
added to the port (``losses.mse``, ``forward_mse_loss``, ``axes_orth_loss``
and ``ops.mvm_density_on_grid``) against the JAX functions in float64 on
seeded inputs, and every name of a JAX ``__all__`` resolving in the port's
counterpart package, but for the names that stay JAX-only (ROADMAP.md
says why)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu import losses as jax_losses
from pointcloud_orientation_tpu import ops as jax_ops
from pointcloud_orientation_tpu_torch import losses, ops

TOL = 1e-12  # float64 on both sides, the same formulas in another order

# JAX machinery with no counterpart in the port (ROADMAP.md, recorded limits)
JAX_ONLY = {
    "ops": {"set_pallas_mode"},
    "train": {"TrainState"},
    "data": {"make_augment_fn"},
}
PACKAGES = ("ops", "utils", "train", "data", "losses", "models", "parallel", "viz")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_regression_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    b = 5 + seed
    pred, target = rng.normal(size=(b, 3)), rng.normal(size=(b, 3))
    vy, vz, gy, gz = (rng.normal(size=(b, 3)) for _ in range(4))
    lam = float(rng.uniform(0.01, 1.0))
    with jax.enable_x64(True):
        j = jnp.asarray
        want_mse = jax_losses.mse(j(pred), j(target))
        want_fwd = jax_losses.forward_mse_loss(j(pred), j(target))
        want_axes = jax_losses.axes_orth_loss(j(vy), j(vz), j(gy), j(gz), lam)
        want_3d = jax_losses.forward_mse_loss(j(pred.reshape(b, 3, 1)), j(target.reshape(b, 3, 1)))
    _close(losses.mse(_t(pred), _t(target)), want_mse)
    for got, want in ((losses.forward_mse_loss(_t(pred), _t(target)), want_fwd),
                      (losses.axes_orth_loss(_t(vy), _t(vz), _t(gy), _t(gz), lam), want_axes),
                      (losses.forward_mse_loss(_t(pred.reshape(b, 3, 1)),
                                               _t(target.reshape(b, 3, 1))), want_3d)):
        assert got[1].shape == (b,)
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("num", [360, 73])
def test_mvm_density_on_grid_matches_jax(num):
    rng = np.random.default_rng(num)
    mu = rng.uniform(-np.pi, np.pi, size=(4, 3))
    kappa = np.concatenate([rng.uniform(0.0, 50.0, size=(4, 2)), np.zeros((4, 1))], axis=1)
    w = rng.dirichlet(np.ones(3), size=4)
    with jax.enable_x64(True):
        theta_j, p_j = jax_ops.mvm_density_on_grid(jnp.asarray(mu), jnp.asarray(kappa),
                                                   jnp.asarray(w), num)
    theta, p = ops.mvm_density_on_grid(_t(mu), _t(kappa), _t(w), num)
    assert theta.dtype == p.dtype == torch.float64 and p.shape == (4, num - 1)
    _close(theta, theta_j)
    _close(p, p_j)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=0, atol=1e-7)  # the 1e-8 guard


@pytest.mark.parametrize("package", PACKAGES)
def test_jax_public_names_resolve_in_the_port(package):
    jax_mod = importlib.import_module(f"pointcloud_orientation_tpu.{package}")
    port_mod = importlib.import_module(f"pointcloud_orientation_tpu_torch.{package}")
    only = JAX_ONLY.get(package, set())
    assert only <= set(jax_mod.__all__)
    missing = [n for n in jax_mod.__all__ if n not in only and not hasattr(port_mod, n)]
    assert not missing, f"{package}: {missing}"
    unlisted = [n for n in jax_mod.__all__ if n not in only and n not in port_mod.__all__]
    assert not unlisted, f"{package}.__all__ lacks {unlisted}"
    for name in only:
        assert not hasattr(port_mod, name), f"{package}.{name} now exists: drop it from JAX_ONLY"
