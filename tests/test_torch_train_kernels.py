"""The port's two backward kernels on the CPU: their plain versions against
the JAX package's Pallas kernels (interpret mode) and ``jax.grad``, and the
autograd Functions around them against autograd of the plain forwards. The
kernels themselves are held against the plain versions on the card, in
tests/test_torch_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops.pallas_kernels import (
    _sa_mlp_max_bwd_impl,
    _sa_scatter_call,
    sa_group_feats_pallas,
)
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K

# (K, S, MLP widths) of the three set abstractions of the trunk
SA_WIDTHS = {
    "sa1": (32, 128, (3, 64, 64, 128)),
    "sa2": (32, 32, (131, 128, 128, 256)),
    "sa3": (32, 1, (259, 256, 512, 1024)),
}


def _layers_np(rng, widths):
    return [
        (
            (rng.normal(size=(ci, co)) / math.sqrt(ci)).astype(np.float32),
            rng.uniform(0.5, 1.5, size=co).astype(np.float32),
            (0.1 * rng.normal(size=co)).astype(np.float32),
        )
        for ci, co in zip(widths[:-1], widths[1:])
    ]


def _t(layers):
    return [tuple(torch.from_numpy(a) for a in layer) for layer in layers]


@pytest.mark.parametrize("shape", [(2, 128, 32, 32, 128), (3, 40, 5, 8, 7)],
                         ids=["sa2", "small"])
def test_scatter_plain_matches_pallas_scatter(rng, shape):
    """Repeated targets included (S*K slots into N rows). Sums run in
    another order than the Pallas contraction: 1e-5."""
    B, N, S, Kn, D = shape
    idx = rng.integers(0, N, size=(B, S, Kn)).astype(np.int32)
    dg = rng.normal(size=(B, S, Kn, D)).astype(np.float32)  # the Pallas layout
    want = np.asarray(_sa_scatter_call(jnp.asarray(idx), jnp.asarray(dg), N, interpret=True))
    got = K.sa_group_scatter(torch.from_numpy(idx),
                             torch.from_numpy(dg).transpose(1, 2).contiguous(), N)
    assert got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_scatter_reads_a_column_slice_in_place(rng):
    """The wrapper takes the grouped cotangent's ``[..., 3:]`` view; the
    result equals that of a contiguous copy."""
    B, N, S, Kn, D = 2, 50, 6, 4, 9
    idx = torch.from_numpy(rng.integers(0, N, size=(B, S, Kn)).astype(np.int32))
    full = torch.from_numpy(rng.normal(size=(B, Kn, S, 3 + D)).astype(np.float32))
    view = full[..., 3:]
    assert not view.is_contiguous()
    assert torch.equal(K.sa_group_scatter(idx, view, N),
                       K.sa_group_scatter(idx, view.contiguous(), N))


def test_group_feats_gradient_matches_jax_grad(rng):
    """dfeats through ``SAGroupFeatsFn`` (scatter backward) against
    ``jax.grad`` through ``sa_group_feats_pallas`` (its Pallas scatter VJP,
    interpret mode), for a random linear functional of grouped; dxyz is zero
    on both sides."""
    B, N, S, Kn, D = 2, 128, 32, 32, 16
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    cidx = np.stack([rng.permutation(N)[:S] for _ in range(B)]).astype(np.int32)
    w = rng.normal(size=(B, S, Kn, 3 + D)).astype(np.float32)  # JAX layout (B,S,K,C)

    def f(x, ft):
        _, grouped, _ = sa_group_feats_pallas(x, ft, jnp.asarray(cidx), Kn, True)
        return jnp.sum(grouped * w)

    want_dxyz, want_dfeats = jax.grad(f, argnums=(0, 1))(jnp.asarray(xyz), jnp.asarray(feats))
    tx = torch.from_numpy(xyz).requires_grad_()
    tf = torch.from_numpy(feats).requires_grad_()
    _, grouped, idx = K.SAGroupFeatsFn.apply(tx, tf, torch.from_numpy(cidx), Kn)
    (grouped * torch.from_numpy(w).transpose(1, 2)).sum().backward()
    assert not idx.requires_grad
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_dxyz))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_dfeats), rtol=1e-5, atol=1e-5)


def _mlp_bwd_case(rng, stage, ties):
    kn, s, widths = SA_WIDTHS[stage]
    g = rng.normal(size=(2, kn, s, widths[0])).astype(np.float32)
    layers = _layers_np(rng, widths)
    if ties == "dead":  # every last-layer pre-activation negative: all pooled 0
        w, sc, _ = layers[-1]
        layers[-1] = (w, sc, np.full_like(sc, -1e3))
    elif ties == "repeated":  # neighbour 1 repeats neighbour 0: equal rows
        g[:, 1] = g[:, 0]
    dpooled = rng.normal(size=(2, s, widths[-1])).astype(np.float32)
    return g, layers, dpooled


@pytest.mark.parametrize("ties", ["none", "repeated", "dead"])
@pytest.mark.parametrize("stage", sorted(SA_WIDTHS))
def test_mlp_max_bwd_plain_matches_pallas_bwd(rng, stage, ties):
    """dgrouped, dW, dscale, dshift against ``_sa_mlp_max_bwd_impl``
    (interpret mode). Both split the pooled cotangent evenly over ties.
    Tolerance rtol 1e-4, atol 1e-4 times the largest entry of each output:
    sums over up to 8,192 rows in another order."""
    g, layers, dpooled = _mlp_bwd_case(rng, stage, ties)
    want_dg, want_layers = _sa_mlp_max_bwd_impl(
        jnp.asarray(g), [tuple(map(jnp.asarray, layer)) for layer in layers],
        jnp.asarray(dpooled), False, True)
    got_dg, got_layers = K.sa_mlp_max_bwd(torch.from_numpy(g), _t(layers),
                                          torch.from_numpy(dpooled))
    pairs = [("dgrouped", got_dg, want_dg)]
    for i, (got, want) in enumerate(zip(got_layers, want_layers)):
        pairs += [(f"layer {i} {n}", a, b) for n, a, b in zip(("dW", "ds", "dt"), got, want)]
    for name, got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
    if ties == "dead":  # every relu mask of the last layer is zero
        assert not got_dg.numpy().any() and not np.asarray(want_dg).any()


def test_group_feats_fn_matches_autograd_of_plain_gather(rng):
    B, N, S, Kn, D = 2, 60, 7, 5, 6
    xyz = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    cidx = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    w = torch.from_numpy(rng.normal(size=(B, Kn, S, 3 + D)).astype(np.float32))
    f1 = torch.from_numpy(feats).requires_grad_()
    f2 = torch.from_numpy(feats).requires_grad_()
    g1 = K.SAGroupFeatsFn.apply(xyz, f1, cidx, Kn)[1]
    g2 = K.sa_group_plain(xyz, f2, cidx, Kn)[1]  # differentiable torch gathers
    assert torch.equal(g1, g2)
    (g1 * w).sum().backward()
    (g2 * w).sum().backward()
    torch.testing.assert_close(f1.grad, f2.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stage", sorted(SA_WIDTHS))
def test_mlp_max_fn_matches_autograd_of_plain_forward(rng, stage):
    """Gradients in grouped and in every W, scale and shift."""
    kn, s, widths = SA_WIDTHS[stage]
    g = rng.normal(size=(2, kn, s, widths[0])).astype(np.float32)
    layers = _layers_np(rng, widths)
    dp = torch.from_numpy(rng.normal(size=(2, s, widths[-1])).astype(np.float32))

    def grads(fn):
        gt = torch.from_numpy(g).requires_grad_()
        flat = [torch.from_numpy(a).requires_grad_() for layer in layers for a in layer]
        out = fn(gt, flat)
        out.backward(dp)
        return out.detach(), [gt.grad] + [p.grad for p in flat]

    out1, d1 = grads(lambda gt, flat: K.SAMlpMaxFn.apply(gt, False, *flat))
    out2, d2 = grads(lambda gt, flat: K.sa_mlp_max_plain(
        gt, [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]))
    assert torch.equal(out1, out2)
    for a, b in zip(d1, d2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_backward_wrappers_count_nothing_on_the_cpu(rng):
    K.reset_launch_counts()
    idx = torch.zeros((1, 2, 3), dtype=torch.int32)
    K.sa_group_scatter(idx, torch.ones((1, 3, 2, 4)), 5)
    layer = (torch.ones(3, 5), torch.ones(5), torch.zeros(5))
    K.sa_mlp_max_bwd(torch.ones((1, 4, 2, 3)), [layer], torch.ones((1, 2, 5)))
    assert K.sa_mlp_max_bwd(torch.ones((1, 4, 2, 3)), [layer], torch.ones((1, 2, 5)),
                            need_dgrouped=False)[0] is None
    assert K.launch_counts() == {"sa_group": 0, "sa_mlp_max": 0, "sa_group_scatter": 0,
                                 "sa_mlp_max_bwd": 0, "knn": 0, "fps": 0, "ball_query": 0,
                                 "sa_mlp_max_bf16": 0, "sa_mlp_max_bwd_bf16": 0,
                                 "topk_min": 0}
    with pytest.raises(TypeError):
        K.sa_group_scatter(idx, torch.ones((1, 3, 2, 4), dtype=torch.float64), 5)
    with pytest.raises(TypeError):  # grouped features are f32 in either variant
        K.sa_mlp_max_bwd(torch.ones((1, 4, 2, 3), dtype=torch.bfloat16), [layer],
                         torch.ones((1, 2, 5)))
    with pytest.raises(ValueError):
        K.sa_group_scatter(idx.to("meta"), torch.ones((1, 3, 2, 4), device="meta"), 5)
