"""The MoE capacity dispatch under data parallelism (``parallel/ep.py``,
``Trainer(mesh=)``) as gloo ranks at world size 2 and 4, against the JAX
``Trainer`` on its virtual mesh.

The JAX ``Trainer`` partitions one program over the sharded batch, so its
capacity dispatch counts the global ``T = B*N`` and places the tokens in
the global flattened order. The port's ranks hold their rows only: each
token's place is its rank's count plus the tokens that lower ranks route to
the same expert. One step of ``moe_point_transformer`` (the DP step's
deterministic configuration of ``tests/torch_parallel_ranks.py``, no
dropout) at a factor that drops tokens (1.25) and at ``n_experts`` (none
dropped): the same kept tokens a layer, exactly, and the loss, aux loss
and gradient within the bounds below, both sides in float64. The JAX
side's kept tokens are its own dispatch's (``_expert_compute_capacity``)
on the assignment its train step routed, read out of the jitted step.
The FSDP step (``make_fsdp_train_step``) holds a capacity layer too, and
is held against the one-device step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from pointcloud_orientation_tpu import data as jax_data
from pointcloud_orientation_tpu import models as jax_models
from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu.models import MoEPointTransformer as JaxMoEPT
from pointcloud_orientation_tpu.parallel import ep as jax_ep
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import preset as jax_preset
from pointcloud_orientation_tpu_torch import parallel as TP
import torch_parallel_ranks as R

WORLDS = (2, 4)
# Bounds of the DP step against the JAX float64 step (the loss and aux loss
# relative, every gradient leaf relative in norm; each attention's key bias,
# zero in exact arithmetic, by its norm against the query bias's). Both sides
# round the pooled features and the aux loss to float32, as the JAX model's
# ``astype(jnp.float32)`` does, so they agree to float32's resolution. At world
# 2 and 4 and both factors the readings were at most 3.9e-8 on the loss, 0 on
# the aux loss and 3.9e-8 on a gradient leaf, with 111 and 246 of 1,024 tokens
# dropped in the two layers at 1.25 (``JAX_PLATFORMS=cpu XLA_FLAGS=
# --xla_force_host_platform_device_count=8 PYTHONPATH=. python
# tests/test_torch_moe_dp.py`` prints them).
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-6
# The FSDP step against the one-device step, both the port's in float64.
FSDP_ATOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("moe_dp", WORLDS)


class _NoDropMoE(JaxMoEPT):
    """The JAX MoE transformer at the rank suite's sizes, no dropout."""

    depth: int = R.MOE_SIZE["depth"]
    embed_dim: int = R.MOE_SIZE["embed_dim"]
    num_heads: int = R.MOE_SIZE["num_heads"]
    ffn_dim: int = R.MOE_SIZE["ffn_dim"]
    dropout: float = 0.0


def _kept(assign, factor):
    """Global ids of the tokens that the JAX capacity dispatch keeps for
    the assignment ``(B, N)``: its own ``_expert_compute_capacity`` with
    every weight 1 and every input 1, whose output is 1 on a kept token
    and 0 on a dropped one."""
    B, N = assign.shape
    K = jax_preset("moe_point_transformer").moe_experts
    cap = jax_ep.expert_capacity(B * N, K, factor)
    one = jnp.ones((K, 1, 1), jnp.float32)
    zero = jnp.zeros((K, 1), jnp.float32)
    y = jax_ep._expert_compute_capacity(jnp.ones((B, N, 1), jnp.float32), jnp.asarray(assign),
                                        one, zero, one, zero, cap)
    flat = np.asarray(y).reshape(-1)
    assert set(np.unique(flat)) <= {0.0, 1.0}
    return np.flatnonzero(flat == 1.0)


def _jax_moe_step(n, factor, monkeypatch):
    """The JAX Trainer's epoch (one step) of ``R.MOE_STEP_CFG`` on n
    virtual devices from the shared weights, in float64: its history, its
    gradient (read back from the SGD update at lr 1), the train step's aux
    loss and each layer's top-1 assignment ``(B, N)`` of the global batch,
    passed out of the jitted step with ``jax.debug.callback``."""
    monkeypatch.setitem(jax_models.MODEL_REGISTRY, "moe_point_transformer", _NoDropMoE)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), R.moe_step_weights())
    real = JaxTrainer._init_state

    def init(self):
        state = real(self)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        return JP.replicate(state.replace(params=params, opt_state=self.tx.init(params)),
                            self.mesh)

    monkeypatch.setattr(JaxTrainer, "_init_state", init)
    routes, aux, training = {}, [], [False]

    def intercept(next_fun, args, kwargs, context):
        module = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(module, JaxMoEPT):
            training[0] = bool(kwargs.get("train", args[1] if len(args) > 1 else False))
            out = next_fun(*args, **kwargs)
            if training[0]:
                jax.debug.callback(lambda a: aux.append(float(a)), out[1])
            return out
        out = next_fun(*args, **kwargs)
        if isinstance(module, nn.Dense) and module.name == "router" and training[0]:
            layer = module.scope.path[0]
            jax.debug.callback(lambda a, layer=layer: routes.setdefault(layer, np.asarray(a)),
                               jnp.argmax(jax.nn.softmax(out, axis=-1), axis=-1))
        return out

    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    cfg = jax_preset("moe_point_transformer").replace(**R.MOE_STEP_CFG,
                                                      moe_capacity_factor=factor)
    with jax.enable_x64(True), nn.intercept_methods(intercept):
        tr = JaxTrainer(cfg, R.jax_step_dataset(jax_data), mesh=mesh)
        tr.fit(epochs=1, log_every=0)
        after = jax.tree_util.tree_map(np.asarray, tr.state.params)
    jax.effects_barrier()
    assert int(tr.state.step) == 1 and len(aux) == 1
    grads = jax.tree_util.tree_map(lambda p0, p1: (p0 - p1) / R.MOE_STEP_CFG["lr"],
                                   v["params"], after)
    layers = sorted(routes)
    assert len(layers) == R.MOE_SIZE["depth"]
    return {"history": tr.history, "grads": grads, "aux": aux[0],
            "kept": [_kept(routes[k], factor) for k in layers]}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _grad_rel(got, want):
    """The largest gradient leaf's distance, relative in norm (the key
    biases by the query biases' norm)."""
    g, w = _by_path(got), _by_path(want)
    assert set(g) == set(w)
    rel = {}
    for key in w:
        assert g[key].dtype == np.float64, key
        scale = w[key.replace("key", "query")] if "['key']['bias']" in key else w[key]
        rel[key] = float(np.linalg.norm(g[key] - w[key]) / np.linalg.norm(scale))
    return rel


@pytest.mark.parametrize("factor", R.MOE_FACTORS)
@pytest.mark.parametrize("n", WORLDS)
def test_capacity_dp_step_matches_the_jax_trainer_on_the_mesh(ranks, n, factor, monkeypatch):
    """One capacity-dispatch step on n gloo ranks against the JAX Trainer's
    step on n devices of the virtual mesh: the kept tokens of each layer
    equal, as sets of global token ids; at 1.25 some tokens drop, and the
    tokens kept are not those that each rank's batch keeps laid out alone
    (so the comparison sees the layout); at ``n_experts`` none drops. The
    loss, aux loss and every gradient leaf within the bounds above."""
    want = _jax_moe_step(n, factor, monkeypatch)
    got = ranks[n]["step"][factor]
    assert got["steps"] == 1
    T = R.MOE_STEP_CFG["batch_size"] * R.MOE_STEP_CFG["num_points"]
    for layer, (k, w) in enumerate(zip(got["kept"], want["kept"])):
        np.testing.assert_array_equal(np.sort(k), w, err_msg=f"layer {layer}")
    dropped = [T - len(k) for k in got["kept"]]
    if factor < 4:
        assert max(dropped) > 0
        assert any(not np.array_equal(np.sort(k), np.sort(a))
                   for k, a in zip(got["kept"], got["kept_alone"]))
    else:
        assert dropped == [0] * R.MOE_SIZE["depth"]
    assert got["loss"] == pytest.approx(want["history"]["train"][0], rel=LOSS_RTOL)
    assert got["aux"] == pytest.approx(want["aux"], rel=LOSS_RTOL)
    for key, rel in _grad_rel(got["grads"], want["grads"]).items():
        assert rel <= GRAD_RTOL, (key, rel)


@pytest.mark.parametrize("n", WORLDS)
def test_capacity_dp_loss_does_not_depend_on_the_world(ranks, n):
    """The global layout makes the step the global batch's: the loss, the
    aux loss and the kept tokens at world n equal world 2's."""
    for factor in R.MOE_FACTORS:
        a, b = ranks[n]["step"][factor], ranks[2]["step"][factor]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-12)
        assert a["aux"] == pytest.approx(b["aux"], rel=1e-12)
        for k, m in zip(a["kept"], b["kept"]):
            np.testing.assert_array_equal(np.sort(k), np.sort(m))


@pytest.mark.parametrize("n", WORLDS)
def test_fsdp_step_keeps_the_global_layout(ranks, n):
    """An FSDP step of the MoE transformer's regression output (its aux
    left out: the FSDP step's loss is the squared error alone) at factor
    1.25 on n ranks: the kept tokens of the one-device step on the whole
    batch, some dropped, and its loss and updated weights within
    ``FSDP_ATOL``."""
    got, want = ranks[n]["fsdp"]["fsdp"], ranks[n]["fsdp"]["one_device"]
    for k, w in zip(got["kept"], want["kept"]):
        np.testing.assert_array_equal(np.sort(k), np.sort(w))
    assert min(len(k) for k in want["kept"]) < 8 * 64
    assert got["loss"] == pytest.approx(want["loss"], abs=FSDP_ATOL)
    p, q = _by_path(got["params"]), _by_path(want["params"])
    assert set(p) == set(q)
    for key in q:
        np.testing.assert_allclose(p[key], q[key], rtol=0, atol=FSDP_ATOL, err_msg=key)


def test_capacity_dp_at_world_size_one_is_bit_equal():
    """A one-rank mesh lays the slots out with the gathered counts and
    changes no bit of the capacity step: the kept tokens, the loss, the aux
    loss and the gradient equal the meshless step's."""
    want = R.moe_dp_step(1.25)
    mesh = TP.make_mesh(("data",), device="cpu")
    try:
        got = R.moe_dp_step(1.25, mesh)
    finally:
        torch.distributed.destroy_process_group()
    for k, w in zip(got["kept"], want["kept"]):
        np.testing.assert_array_equal(k, w)
    assert (got["loss"], got["aux"]) == (want["loss"], want["aux"])
    g, w = _by_path(got["grads"]), _by_path(want["grads"])
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


if __name__ == "__main__":  # the readings behind LOSS_RTOL and GRAD_RTOL
    import os

    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit("run with XLA_FLAGS=--xla_force_host_platform_device_count=8 "
                         "(tests/conftest.py sets it under pytest)")
    results = R.run_ranks("moe_dp", WORLDS)
    for n in WORLDS:
        for factor in R.MOE_FACTORS:
            with pytest.MonkeyPatch.context() as mp:
                want = _jax_moe_step(n, factor, mp)
            got = results[n]["step"][factor]
            loss = want["history"]["train"][0]
            T = R.MOE_STEP_CFG["batch_size"] * R.MOE_STEP_CFG["num_points"]
            print(f"world {n} factor {factor}: loss {abs(got['loss'] - loss) / abs(loss):.2e} "
                  f"aux {abs(got['aux'] - want['aux']) / abs(want['aux']):.2e} "
                  f"grad {max(_grad_rel(got['grads'], want['grads']).values()):.2e} "
                  f"dropped {[T - len(k) for k in want['kept']]} of {T}")
