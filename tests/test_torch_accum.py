"""Gradient accumulation (``train/accum.py``) against the JAX package's
``accumulated_value_and_grad`` and ``make_accum_train_step``, on the
point transformer (LayerNorm, no BatchNorm) of ``tests/test_accum.py``'s
size (depth 2, width 16, 4 heads, B=8 clouds of 24 points), its weights
the JAX model's, loaded into the port's: loss and gradients over 1, 2, 4
and 8 microbatches against JAX's and against the port's whole-batch
gradient, to the bounds of ``tests/test_accum.py`` (loss 1e-6 relative,
gradients 1e-6 absolute); one accumulated SGD step against the JAX step,
and on the flash backend against its own whole-batch step (N=128, the
flash kernels' tile); the ``ValueError``\\ s."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_orientation_tpu.models import PointTransformer as JaxPT
from pointcloud_orientation_tpu.train.accum import accumulated_value_and_grad as jax_vag
from pointcloud_orientation_tpu.train.accum import make_accum_train_step as jax_step
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.train.accum import (
    accumulated_value_and_grad,
    make_accum_train_step,
)
from pointcloud_orientation_tpu_torch.utils import grad_check as GC
from pointcloud_orientation_tpu_torch.utils import load_flax_variables, to_flax_variables

B, N = 8, 24
SIZE = dict(depth=2, embed_dim=16, num_heads=4, ffn_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n=N):
    """The JAX model's weights and a batch, as in ``tests/test_accum.py``."""
    model = JaxPT(dropout=0.0, **SIZE)
    kx, kp, kt = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(kx, (B, n, 3), jnp.float32)
    target = jax.random.normal(kt, (B, 3), jnp.float32)
    params = model.init({"params": kp}, x, train=False)["params"]
    return model, params, np.array(x), np.array(target)  # writable copies for torch


def _port(params, **kw):
    m = MODEL_REGISTRY["point_transformer"](dropout=0.0, **SIZE, **kw)
    load_flax_variables(m, {"params": jax.tree_util.tree_map(np.asarray, params)})
    return m.eval()


def _loss_fn(module):
    def loss_fn(p, mb):
        x, t = mb
        out = torch.func.functional_call(module, p, (x,))
        return torch.mean((out - t) ** 2)

    return loss_fn


def _as_flax(module, grads):
    for name, p in module.named_parameters():
        p.grad = grads[name]
    return to_flax_variables(module, grads=True)["params"]


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_accumulated_grads_match_jax_and_the_whole_batch(n_micro):
    model, params, x, target = _inputs()

    def jax_loss(p, mb):
        xx, t = mb
        return jnp.mean((model.apply({"params": p}, xx, train=False) - t) ** 2)

    want_loss, want = jax.jit(jax_vag(jax_loss, n_micro))(params, (x, target))
    module = _port(params)
    p = dict(module.named_parameters())
    loss, grads = accumulated_value_and_grad(_loss_fn(module), n_micro)(
        p, (torch.from_numpy(x), torch.from_numpy(target)))
    whole_loss, whole = accumulated_value_and_grad(_loss_fn(module), 1)(
        p, (torch.from_numpy(x), torch.from_numpy(target)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(whole_loss), rtol=1e-6)
    got = _as_flax(module, grads)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
                                     np.asarray, want))):
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    for name in grads:
        np.testing.assert_allclose(grads[name].numpy(), whole[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_accum_train_step_matches_the_jax_step():
    """One accumulated SGD(0.1) step over 4 microbatches: the loss and the
    parameters after it against JAX ``make_accum_train_step``; the gradient
    it leaves in ``.grad`` against the whole batch's."""
    model, params, x, target = _inputs()
    tx = optax.sgd(0.1)
    p_jax, _, loss_jax = jax_step(model, tx, n_micro=4)(params, tx.init(params), x, target)
    module = _port(params)
    step = make_accum_train_step(module, torch.optim.SGD(module.parameters(), lr=0.1), 4)
    loss = step(torch.from_numpy(x), torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-6)
    got = to_flax_variables(module)["params"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(p_jax)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, err_msg=jax.tree_util.keystr(path))
    assert not module.training  # train=False, and the mode is restored


def test_flash_backend_accumulates_to_the_whole_batch_gradient():
    """The flash backend (its plain versions on the CPU) at N=128: the
    gradient of 4 accumulated microbatches equals the whole batch's within
    1e-5 relative in norm, leaf by leaf (``chip_smoke.py`` holds the card's
    kernels to the same), but for the attention key biases, whose gradient
    is zero in exact arithmetic (``utils/grad_check.zero_gradient_leaves``):
    both sides hold rounding noise there, 1e-9 here."""
    _, params, x, target = _inputs(n=128)
    module = _port(params, attention_impl="flash")
    grads = {}
    for n_micro in (1, 4):
        opt = torch.optim.SGD(module.parameters(), lr=0.0)
        make_accum_train_step(module, opt, n_micro)(torch.from_numpy(x), torch.from_numpy(target))
        grads[n_micro] = {n: p.grad.clone() for n, p in module.named_parameters()}
    skip = GC.zero_gradient_leaves(module)
    assert skip and all(".key.bias" in n for n in skip)
    for name, g in grads[4].items():
        w = grads[1][name]
        if name in skip:
            assert float((g - w).abs().max()) <= 1e-6, name
            continue
        assert float((g - w).norm()) <= 1e-5 * max(float(w.norm()), 1e-12), name


def test_errors():
    with pytest.raises(ValueError):
        accumulated_value_and_grad(lambda p, b: 0.0, 0)
    module = _port(_inputs()[1])
    vag = accumulated_value_and_grad(_loss_fn(module), 3)
    with pytest.raises(ValueError, match="not divisible"):
        vag(dict(module.named_parameters()), (torch.zeros(8, N, 3), torch.zeros(8, 3)))
