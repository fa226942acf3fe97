"""The port's SharedMLP in train mode against the JAX package's flax
SharedMLP: the unfused default (``fuse_max=False``, then the max over
neighbours) and the fused ghost-statistics path (``fuse_max=True``, the
configuration ``PCOT_FUSED_MLP=1`` selects; its Pallas kernels in interpret
mode). Pooled output, running statistics after one call, and parameter
gradients of a random linear functional of the pooled output."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models.layers import SharedMLP as FlaxSharedMLP
from pointcloud_orientation_tpu_torch.models import SharedMLP
from pointcloud_orientation_tpu_torch.models.layers import dropout

# (K, S, in width, MLP widths) of the three set abstractions of the trunk
SA = {
    "sa1": (32, 128, 3, (64, 64, 128)),
    "sa2": (32, 32, 131, (128, 128, 256)),
    "sa3": (32, 1, 259, (256, 512, 1024)),
}


def _load(mlp: SharedMLP, params, stats) -> None:
    with torch.no_grad():
        for j, (lin, bn) in enumerate(zip(mlp.linears, mlp.bns)):
            for dst, src in ((lin.weight, np.asarray(params[f"Dense_{j}"]["kernel"]).T),
                             (lin.bias, params[f"Dense_{j}"]["bias"]),
                             (bn.weight, params[f"BatchNorm_{j}"]["scale"]),
                             (bn.bias, params[f"BatchNorm_{j}"]["bias"]),
                             (bn.running_mean, stats[f"BatchNorm_{j}"]["mean"]),
                             (bn.running_var, stats[f"BatchNorm_{j}"]["var"])):
                dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _random_variables(rng, model, x):
    """flax init, then random BatchNorm scale/bias and running statistics."""
    v = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(x))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if p[-1].key == "scale" else
        ((0.1 * rng.normal(size=a.shape)).astype(np.float32) if p[-1].key == "bias" else a),
        v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if p[-1].key == "var" else (0.1 * rng.normal(size=a.shape)).astype(np.float32),
        v["batch_stats"])
    return params, stats


def _train_call(rng, stage, fused, dtype):
    """One train-mode call of the flax SharedMLP and of the port's on the
    same numpy inputs and variables, in ``dtype``; returns both sides'
    pooled output, running statistics and parameter gradients of
    ``sum(pooled * w)``."""
    kn, s, cin, widths = SA[stage]
    B = 2
    g = rng.normal(size=(B, kn, s, cin)).astype(dtype)  # neighbour-major
    w = rng.normal(size=(B, s, widths[-1])).astype(dtype)
    fmlp = FlaxSharedMLP(widths, fuse_max=fused)
    x_jax = g if fused else np.swapaxes(g, 1, 2)  # the unfused module takes (B,S,K,C)
    params, stats = _random_variables(rng, fmlp, jnp.asarray(x_jax, jnp.float32))
    params, stats = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), (params, stats))

    def loss(p):
        out, mut = fmlp.apply({"params": p, "batch_stats": stats}, jnp.asarray(x_jax),
                              train=True, mutable=["batch_stats"])
        pooled = out if fused else jnp.max(out, axis=2)
        return jnp.sum(pooled * w), (pooled, mut["batch_stats"])

    with jax.enable_x64(dtype == np.float64):
        (_, (want_pooled, want_stats)), want_grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        want = jax.tree_util.tree_map(np.asarray, (want_pooled, want_stats, want_grads))
    mlp = SharedMLP(cin, widths, fused_mlp_train=fused).to(torch.from_numpy(g).dtype).train()
    _load(mlp, params, stats)
    pooled = mlp(torch.from_numpy(g))
    (pooled * torch.from_numpy(w)).sum().backward()
    return mlp, pooled.detach().numpy(), want


def _check(mlp, pooled, want, tol_out, tol_stats, rtol_grad, atol_grad):
    want_pooled, want_stats, want_grads = want
    np.testing.assert_allclose(pooled, want_pooled, rtol=tol_out, atol=tol_out)
    for j, (lin, bn) in enumerate(zip(mlp.linears, mlp.bns)):
        st = want_stats[f"BatchNorm_{j}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], rtol=tol_stats,
                                   atol=tol_stats)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], rtol=tol_stats,
                                   atol=tol_stats)
        if rtol_grad is None:
            continue
        pairs = (("kernel", lin.weight.grad.T, want_grads[f"Dense_{j}"]["kernel"]),
                 ("bias", lin.bias.grad, want_grads[f"Dense_{j}"]["bias"]),
                 ("scale", bn.weight.grad, want_grads[f"BatchNorm_{j}"]["scale"]),
                 ("bn bias", bn.bias.grad, want_grads[f"BatchNorm_{j}"]["bias"]))
        layer_scale = max(float(np.abs(w).max()) for _, _, w in pairs)
        for name, got, w in pairs:
            np.testing.assert_allclose(got.numpy(), w, rtol=rtol_grad,
                                       atol=atol_grad * layer_scale, err_msg=f"layer {j} {name}")


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused-ghost"])
@pytest.mark.parametrize("stage", sorted(SA))
def test_shared_mlp_train_matches_flax(rng, monkeypatch, stage, fused):
    """Pooled output, running statistics and gradients.

    The default path (plain PyTorch ops) is compared in float64 on both
    sides, at 1e-9: in float32 the two frameworks round a few of the
    millions of pre-activations to opposite sides of zero (a ReLU decision
    flip: one at sa2 with this seed, -1.5e-8 here against +1.5e-7 in JAX),
    which moves a whole column of a kernel gradient by O(1); the float32
    forward is checked in the next test. The fused path runs float32
    kernels (the JAX side casts to float32 too): pooled 1e-5, statistics
    1e-6, gradients rtol 1e-4 and atol 1e-5 times the layer's largest
    gradient (the functional sums B*S*C_out outputs, so gradients reach the
    hundreds; a Dense bias that feeds a train-mode BatchNorm has gradient
    zero in exact arithmetic and holds rounding noise on both sides)."""
    monkeypatch.setenv("PCOT_FUSED_MLP", "1")  # the JAX switch for the fused train path
    if fused:
        _check(*_train_call(rng, stage, True, np.float32), 1e-5, 1e-6, 1e-4, 1e-5)
    else:
        _check(*_train_call(rng, stage, False, np.float64), 1e-9, 1e-9, 1e-7, 1e-9)


@pytest.mark.parametrize("stage", sorted(SA))
def test_shared_mlp_train_forward_matches_flax_in_f32(rng, stage):
    """The default path in float32: pooled output 1e-5 and running
    statistics 1e-6 (summation order only)."""
    _check(*_train_call(rng, stage, False, np.float32), 1e-5, 1e-6, None, None)


def test_running_stats_use_flax_momentum_and_the_biased_variance(rng):
    mlp = SharedMLP(4, (5,)).train()
    with torch.no_grad():
        mlp.bns[0].running_mean.fill_(1.0)
        mlp.bns[0].running_var.fill_(2.0)
    g = torch.from_numpy(rng.normal(size=(3, 6, 7, 4)).astype(np.float32))
    mlp(g)
    with torch.no_grad():
        z = mlp.linears[0](g).reshape(-1, 5)
    np.testing.assert_allclose(mlp.bns[0].running_mean.numpy(),
                               (0.9 * 1.0 + 0.1 * z.mean(0)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mlp.bns[0].running_var.numpy(),
                               (0.9 * 2.0 + 0.1 * z.var(0, unbiased=False)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dropout_keeps_one_minus_p_and_scales_by_its_inverse():
    x = torch.ones((400, 500))
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert abs(kept.float().mean().item() - 0.5) < 0.01  # 200k draws: 4.5 sigma is 0.005
    y2 = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert torch.equal(dropout(x, 0.0, None), x)
    y3 = dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert math.isclose(float(y3[y3 != 0][0]), 1 / 0.75, rel_tol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)
