"""On the card only (marker ``cuda``; skipped without a CUDA device): each
CUDA kernel of the port against its plain PyTorch version, the wrappers'
refusals, the models' outputs through the kernels against the same models
through the plain versions (8-dir, the classifier, the SO(3) heads, clouds
above the fused grouping's size, the point transformer's flash backend),
and a train step's gradients likewise.

This file imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu_torch import OrientationPredictor, random_flax_variables
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as TG
from pointcloud_orientation_tpu_torch.utils import grad_check as GC

# (K, S, MLP widths) of the three set abstractions of the trunk
SA_WIDTHS = {
    "sa1": (32, 128, (3, 64, 64, 128)),
    "sa2": (32, 32, (131, 128, 128, 256)),
    "sa3": (32, 1, (259, 256, 512, 1024)),
}




@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _sa_group_case(gen, dev, B, N, S, KN, D, tiled):
    if tiled:
        base = torch.randn((B, max(KN, N // 4), 3), generator=gen, device=dev)
        xyz = base.repeat(1, -(-N // base.shape[1]), 1)[:, :N].contiguous()
    else:
        xyz = torch.randn((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, D), generator=gen, device=dev) if D else None
    cidx = TG.random_sample_indices(gen, B, N, S, dev).to(torch.int32).contiguous()
    return xyz, feats, cidx


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("shape", [(64, 1024, 128, 32, 0), (16, 10000, 128, 32, 0),
                                   (64, 128, 32, 32, 128), (3, 40, 5, 40, 7),
                                   (2, 1000, 9, 1, 0), (2, 777, 6, 32, 4), (2, 10240, 3, 128, 0),
                                   (2, 200, 9, 32, 5), (2, 400, 17, 64, 0), (2, 1024, 3, 128, 0),
                                   (2, 1025, 5, 32, 0)],
                         ids=["sa1-1024", "sa1-10000", "sa2", "K=N", "K=1", "N=777", "K=128",
                              "N=200", "N=400", "N=1024-K=128", "N=1025"])
def test_sa_group_kernel_equals_plain_on_card(cuda_device, shape, tiled):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xyz, feats, cidx = _sa_group_case(gen, cuda_device, *shape, tiled)
    before = K.sa_group.launches
    got = K.sa_group(xyz, feats, cidx, shape[3])
    want = K.sa_group_plain(xyz, feats, cidx, shape[3])
    torch.cuda.synchronize()
    assert K.sa_group.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# beyond the trunk's shapes: K not a multiple of 4 and rows padded to the
# tile, a ragged last tile of centroids, one layer, four layers
MLP_CASES = {
    **{k: (64,) + v for k, v in SA_WIDTHS.items()},
    "K=40": (3, 40, 5, (7, 12, 20)),
    "ragged-S": (2, 32, 7, (5, 64, 96)),
    "one-layer": (2, 8, 9, (3, 130)),
    "four-layers": (2, 16, 3, (6, 33, 65, 17, 300)),
    # the classifier's group-all stage: 128 rows in two chunks of 64; and
    # rows in three chunks with a ragged last one
    "cls-group-all-K=128": (64, 128, 1, (259, 256, 512, 1024)),
    "K=150-chunked": (2, 150, 1, (259, 256, 512, 1024)),
    # no width a multiple of 8 or 16 (every layer's W copied 4 bytes at a
    # time, every depth zero-padded) and K*S = 91 rows, not a multiple of 16
    "ragged-widths": (3, 13, 7, (11, 37, 21, 75, 19)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_sa_mlp_max_kernel_matches_plain_on_card(cuda_device, case):
    b, kn, s, widths = MLP_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g = torch.randn((b, kn, s, widths[0]), generator=gen, device=cuda_device)
    layers = []
    for ci, co in zip(widths[:-1], widths[1:]):
        layers.append((torch.randn((ci, co), generator=gen, device=cuda_device) / math.sqrt(ci),
                       torch.rand((co,), generator=gen, device=cuda_device) + 0.5,
                       0.1 * torch.randn((co,), generator=gen, device=cuda_device)))
    got = K.sa_mlp_max(g, layers)
    want = K.sa_mlp_max_plain(g, layers)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    xyz = torch.zeros((1, 64, 3), device=cuda_device)
    cidx = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # more than the grouping kernel's N
        K.sa_group(torch.zeros((1, 10241, 3), device=cuda_device), None, cidx, 4)
    with pytest.raises(ValueError):  # fewer points than neighbours
        K.sa_group(xyz, None, cidx, 65)
    with pytest.raises(TypeError):
        K.sa_group(xyz, None, cidx.long(), 4)
    with pytest.raises(ValueError):
        K.sa_group(xyz[:, ::2], None, cidx, 4)
    layer = (torch.ones(3, 5, device=cuda_device), torch.ones(5, device=cuda_device),
             torch.zeros(5, device=cuda_device))
    with pytest.raises(ValueError):  # channel mismatch
        K.sa_mlp_max(torch.zeros((1, 4, 8, 4), device=cuda_device), [layer])
    with pytest.raises(ValueError):  # more layers than the kernel takes
        K.sa_mlp_max(torch.zeros((1, 4, 8, 3), device=cuda_device),
                     [layer] + [(torch.ones(5, 5, device=cuda_device),) + layer[1:]] * 4)


@pytest.mark.cuda
def test_logits_through_kernels_match_plain_versions_on_card(cuda_device):
    v = random_flax_variables(3)
    pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=1024, max_batch=8, device=cuda_device,
                                sampling="first")
    clouds = np.random.default_rng(3).normal(size=(5, 700, 3)).astype(np.float32)
    before = K.launch_counts()
    got = pred(clouds)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "sa_group": 2, "sa_mlp_max": 3, "sa_group_scatter": 0, "sa_mlp_max_bwd": 0,
        "knn": 0, "fps": 0, "ball_query": 0, "sa_mlp_max_bf16": 0, "sa_mlp_max_bwd_bf16": 0,
        "topk_min": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    with mock.patch.object(K, "sa_group", K.sa_group_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
        want = pred(clouds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the training slice's backward kernels
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["grouping", "random"])
def test_scatter_kernel_is_deterministic_and_matches_plain_on_card(cuda_device, source):
    """At sa2's shapes (B=16, N=128, S=32, K=32, D=128), reading the
    cotangent in place at column offset 3 of a (B,K,S,131) tensor: two
    launches bit-equal, and within 1e-5 of the plain version (index_add_,
    another summation order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, N, S, KN, D = 16, 128, 32, 32, 128
    if source == "grouping":
        xyz, feats, cidx = _sa_group_case(gen, cuda_device, B, N, S, KN, D, False)
        idx = K.sa_group(xyz, feats, cidx, KN)[2]
    else:
        idx = torch.randint(0, N, (B, S, KN), generator=gen, device=cuda_device,
                            dtype=torch.int32)
    dg = torch.randn((B, KN, S, 3 + D), generator=gen, device=cuda_device)[..., 3:]
    before = K.sa_group_scatter.launches
    a = K.sa_group_scatter(idx, dg, N)
    b = K.sa_group_scatter(idx, dg, N)
    want = K.sa_group_scatter_plain(idx, dg, N)
    torch.cuda.synchronize()
    assert K.sa_group_scatter.launches == before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)


def _ordered_scatter(idx, dg, n):
    """The scatter summed in ascending slot order (s * K + k), one slot at a
    time in f32: what the kernel computes, to the bit."""
    B, S, KN = idx.shape
    out = torch.zeros((B, n, dg.shape[-1]), dtype=torch.float32, device=dg.device)
    rows = torch.arange(B, device=dg.device)
    for s in range(S):
        for k in range(KN):
            out[rows, idx[:, s, k].long()] += dg[:, k, s]
    return out


# (B, N, S, K, D, columns before the slice, case)
SCATTER_EDGES = {
    "rows-with-no-slot": (16, 128, 32, 32, 128, 3, "few"),
    "one-row-takes-every-slot": (4, 128, 32, 32, 128, 3, "one"),
    "row-stride>D": (8, 64, 16, 32, 64, 5, "random"),
    "D=7": (3, 13, 5, 7, 7, 0, "random"),
    "D=130": (2, 37, 4, 16, 130, 3, "random"),
    "D=96-float4": (16, 128, 32, 32, 96, 0, "random"),
    "B=40-6-row-groups": (40, 128, 32, 32, 128, 3, "random"),
    "B=300-1-row-group": (300, 64, 8, 16, 32, 3, "random"),
    "N=10000": (1, 10000, 32, 32, 16, 3, "random"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SCATTER_EDGES.values()), ids=list(SCATTER_EDGES))
def test_scatter_kernel_edges_on_card(cuda_device, shape):
    """Two launches bit-equal, bit-equal to the slots summed one at a time
    in ascending slot order, and within 1e-5 of the plain version
    (index_add_, another order): rows with no slot (0), one row that takes
    every slot, row strides above D (odd: scalar loads), D off any
    multiple of 4 or 32, float4 loads where D and the stride allow, a
    cloud's rows over 6 blocks (each sorting the cloud's slots) and over one
    block, and a cloud of 10,000 rows (fewer sorting warps). Where rows take hundreds of slots
    ("few", "one"), f32 sums of random values in two orders differ by up to
    ~5e-5, so there the plain version is held to the kernel on dyadic
    cotangents (multiples of 1/8 in [-1, 1]: every sum exact in any
    order)."""
    B, N, S, KN, D, extra, case = shape
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    if case == "one":
        idx = torch.full((B, S, KN), 5, dtype=torch.int32, device=cuda_device)
    else:
        hi = 3 if case == "few" else N
        idx = torch.randint(0, hi, (B, S, KN), generator=gen, device=cuda_device,
                            dtype=torch.int32)
    dg = torch.randn((B, KN, S, extra + D), generator=gen, device=cuda_device)[..., extra:]
    a = K.sa_group_scatter(idx, dg, N)
    b = K.sa_group_scatter(idx, dg, N)
    ordered = _ordered_scatter(idx, dg, N)
    if case in ("few", "one"):
        dg = (dg * 8).round().clamp(-8, 8) / 8
        got, want = K.sa_group_scatter(idx, dg, N), K.sa_group_scatter_plain(idx, dg, N)
    else:
        got, want = a, K.sa_group_scatter_plain(idx, dg, N)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, ordered)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if case == "few":
        assert (a[:, 3:] == 0).all()


def dyadic_mlp_case(gen, dev, b, kn, s, widths, dead=False):
    """Inputs on which every forward product and sum is exact in f32 in any
    order: grouped in multiples of 1/8 within [-1, 1], W in {-1, 0, 1},
    scale a power of two near 1/sqrt(Cin), shift a multiple of the layer's
    granularity. The kernel and the plain version then take the same ReLU
    and max decisions (the max has many exact ties, split evenly), and only
    the backward sums differ in order. ``dead``: the last shift at -1000,
    so every pooled value is 0 and every neighbour ties."""
    g = torch.randint(-8, 9, (b, kn, s, widths[0]), generator=gen, device=dev) / 8.0
    layers, bits = [], 3
    for ci, co in zip(widths[:-1], widths[1:]):
        e = math.ceil(math.log2(math.sqrt(ci)))
        bits += e
        w = torch.randint(-1, 2, (ci, co), generator=gen, device=dev).float()
        sc = torch.full((co,), 2.0 ** -e, device=dev)
        t = torch.randint(-16, 17, (co,), generator=gen, device=dev) * 2.0 ** -bits
        layers.append((w.contiguous(), sc, t.float()))
    if dead:
        layers[-1] = (layers[-1][0], layers[-1][1], torch.full_like(layers[-1][2], -1000.0))
    dp = torch.randn((b, s, widths[-1]), generator=gen, device=dev)
    return g.float().contiguous(), layers, dp


# (B, K, S, MLP widths) of the backward's card tests: B=16 at each set
# abstraction, and ragged shapes whose rows and widths end inside the
# kernel's 64 x 64 product tiles and its 32-deep stages
BWD_CASES = {**{stage: (16, kn, s, widths) for stage, (kn, s, widths) in SA_WIDTHS.items()},
             "ragged-3": (5, 7, 9, (3, 20, 36)), "ragged-131": (5, 7, 9, (131, 40, 72)),
             # the classifier's training path: sa1 K=32 S=512, sa2 K=64 S=128, the
             # group-all stage's K=128 rows (S=1), at B=16 and B=64
             "cls-sa1": (16, 32, 512, (3, 64, 64, 128)),
             "cls-sa2": (16, 64, 128, (131, 128, 128, 256)),
             "cls-group-all": (16, 128, 1, (259, 256, 512, 1024)),
             "cls-group-all-B64": (64, 128, 1, (259, 256, 512, 1024))}


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True], ids=["ties", "all-tied"])
@pytest.mark.parametrize("stage", sorted(BWD_CASES))
def test_mlp_max_bwd_kernel_matches_plain_on_card(cuda_device, stage, dead):
    """B=16 at each set abstraction's shapes, and two ragged shapes:
    dgrouped, dW, dscale and dshift within rtol 1e-4 and atol 1e-4 times
    the output's largest entry (the backward sums over up to 65,536 rows run
    in another order)."""
    b, kn, s, widths = BWD_CASES[stage]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g, layers, dp = dyadic_mlp_case(gen, cuda_device, b, kn, s, widths, dead)
    before = K.sa_mlp_max_bwd.launches
    got = K.sa_mlp_max_bwd(g, layers, dp)
    want = K.sa_mlp_max_bwd_plain(g, layers, dp)
    torch.cuda.synchronize()
    assert K.sa_mlp_max_bwd.launches == before + 1
    pairs = [("dgrouped", got[0], want[0])]
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        pairs += [(f"layer {i} {n}", x, y) for n, x, y in zip(("dW", "ds", "dt"), a, b)]
    for name, a, b in pairs:
        assert torch.isfinite(a).all(), name
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale, msg=name)
    if dead:
        assert not got[0].any()
    again = K.sa_mlp_max_bwd(g, layers, dp)
    assert torch.equal(again[0], got[0])  # no atomics: the same bits twice


# ---------------------------------------------------------------------------
# the bf16 variants of the MLP kernels, and the bf16 trunk through them
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_sa_mlp_max_bf16_kernel_matches_plain_on_card(cuda_device, case):
    """bf16 operands, f32 accumulation: on dyadic inputs (every sum exact in
    any order, so both round the same values to bf16) within 1e-4 of the
    output's scale."""
    b, kn, s, widths = MLP_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    g, layers, _ = dyadic_mlp_case(gen, cuda_device, b, kn, s, widths)
    before = K.launch_counts()
    got = K.sa_mlp_max(g, layers, bf16=True)
    want = K.sa_mlp_max_plain(g, layers, bf16=True)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["sa_mlp_max_bf16"] == before["sa_mlp_max_bf16"] + 1
    assert after["sa_mlp_max"] == before["sa_mlp_max"]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True], ids=["ties", "all-tied"])
@pytest.mark.parametrize("stage", sorted(k for k in BWD_CASES if not k.startswith("cls")))
def test_mlp_max_bwd_bf16_kernel_matches_plain_on_card(cuda_device, stage, dead):
    """The bf16 backward at B=16 and the ragged shapes, on dyadic inputs:
    every output within rtol 1e-4 and atol 1e-4 of its scale; the same bits
    twice."""
    b, kn, s, widths = BWD_CASES[stage]
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    g, layers, dp = dyadic_mlp_case(gen, cuda_device, b, kn, s, widths, dead)
    before = K.sa_mlp_max_bwd.launches_bf16
    got = K.sa_mlp_max_bwd(g, layers, dp, bf16=True)
    want = K.sa_mlp_max_bwd_plain(g, layers, dp, bf16=True)
    torch.cuda.synchronize()
    assert K.sa_mlp_max_bwd.launches_bf16 == before + 1
    pairs = [(got[0], want[0])] + [(x, y) for a, b in zip(got[1], want[1]) for x, y in zip(a, b)]
    for a, b in pairs:
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(K.sa_mlp_max_bwd(g, layers, dp, bf16=True)[0], got[0])


@pytest.mark.cuda
def test_bf16_trunk_serves_and_trains_through_the_bf16_kernels_on_card(cuda_device):
    """A bf16 request: 2 grouping and 3 bf16 MLP launches, logits within
    0.05 of the f32 predictor's; a fused bf16 train step: 3 bf16 backward
    launches, a finite loss, f32 parameters."""
    v = random_flax_variables(3)
    kw = dict(num_points=1024, max_batch=8, device=cuda_device, sampling="first")
    clouds = np.random.default_rng(3).normal(size=(5, 700, 3)).astype(np.float32)
    pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                dtype="bfloat16", **kw)
    before = K.launch_counts()
    got = pred(clouds)
    after = K.launch_counts()
    grown = {k: after[k] - before[k] for k in after}
    assert grown == {**{k: 0 for k in grown}, "sa_group": 2, "sa_mlp_max_bf16": 3}
    f32 = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)(clouds)
    assert np.isfinite(got).all() and np.abs(got - f32).max() < 0.05
    ds = OrientationDataset.synthetic(samples_per_class=4, num_points=1024)
    trainer = Trainer(preset("8dir_kl", num_points=1024, batch_size=8, compute_dtype="bfloat16"),
                      ds, device=cuda_device, fused_mlp_train=True)
    idx, valid, _ = next(trainer.train_ds.batches(8))
    batch, valid, _ = trainer.device_batch(trainer.train_ds, idx, valid, trainer.generator(0, 0, 0))
    before = K.launch_counts()
    loss = float(trainer.train_step(batch, valid, trainer.generator(0, 1, 0))["loss"])
    after = K.launch_counts()
    assert math.isfinite(loss)
    assert after["sa_mlp_max_bwd_bf16"] - before["sa_mlp_max_bwd_bf16"] == 3
    assert after["sa_mlp_max_bwd"] == before["sa_mlp_max_bwd"]
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


@pytest.mark.cuda
def test_backward_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    idx = torch.zeros((1, 4, 2), dtype=torch.int32, device=dev)
    dg = torch.zeros((1, 2, 4, 5), device=dev)
    with pytest.raises(TypeError):
        K.sa_group_scatter(idx, dg.double(), 8)
    with pytest.raises(TypeError):  # int64 indices
        K.sa_group_scatter(idx.long(), dg, 8)
    with pytest.raises(ValueError):  # shape mismatch
        K.sa_group_scatter(idx, torch.zeros((1, 4, 2, 5), device=dev), 8)
    with pytest.raises(ValueError):  # a stride the kernel cannot read
        K.sa_group_scatter(idx, torch.zeros((1, 2, 5, 4), device=dev).transpose(2, 3), 8)
    with pytest.raises(ValueError):  # cpu idx with cuda cotangents
        K.sa_group_scatter(idx.cpu(), dg, 8)
    layer = (torch.ones(3, 5, device=dev), torch.ones(5, device=dev), torch.zeros(5, device=dev))
    g = torch.zeros((1, 4, 8, 3), device=dev)
    with pytest.raises(ValueError):  # dpooled of the wrong width
        K.sa_mlp_max_bwd(g, [layer], torch.zeros((1, 8, 6), device=dev))
    with pytest.raises(ValueError):  # more layers than the kernel takes
        K.sa_mlp_max_bwd(g, [layer] + [(torch.ones(5, 5, device=dev),) + layer[1:]] * 4,
                         torch.zeros((1, 8, 5), device=dev))
    with pytest.raises(ValueError):  # channel mismatch
        K.sa_mlp_max_bwd(torch.zeros((1, 4, 8, 4), device=dev), [layer],
                         torch.zeros((1, 8, 5), device=dev))
    with pytest.raises(TypeError):
        K.sa_mlp_max_bwd(g.double(), [layer], torch.zeros((1, 8, 5), device=dev))


def _step_grads(trainer, batch, valid, seed, pooled=None):
    """One step's gradients by parameter name; with ``pooled``, the step's
    group-all pooled values are appended to it (``grad_check``)."""
    model = trainer.model
    if pooled is not None:
        with GC.record_group_all(model) as seen:
            grads = _step_grads(trainer, batch, valid, seed)
        pooled.extend(seen)
        return grads
    model.zero_grad(set_to_none=True)
    model.train()
    logits = model(batch["points"], torch.Generator(device=batch["points"].device).manual_seed(seed))
    per = trainer.adapter.loss(logits, batch, trainer.cfg)
    ((per * valid).sum() / valid.sum().clamp_min(1.0)).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused-ghost"])
def test_train_step_gradients_through_kernels_match_plain_on_card(cuda_device, fused):
    """One 8dir_kl step at B=16, N=2,048 (full width), through the kernels
    and through the plain versions, from the same weights and generator:
    each parameter's gradient within 1e-3 relative in norm (default path:
    only the scatter's summation order differs) or 5e-2 (fused path: the
    kernels' f32 sums can flip a few ReLU and max decisions between
    near-equal values, which reroutes those rows' gradients)."""
    ds = OrientationDataset.synthetic(samples_per_class=4, num_points=2048)
    trainer = Trainer(preset("8dir_kl", num_points=2048), ds, device=cuda_device,
                      fused_mlp_train=fused)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    before = K.launch_counts()
    pooled = []
    got = _step_grads(trainer, batch, valid, 3, pooled)
    grown = {k: v - before[k] for k, v in K.launch_counts().items()}
    untouched = {"knn": 0, "fps": 0, "ball_query": 0, "sa_mlp_max_bf16": 0,
                     "sa_mlp_max_bwd_bf16": 0, "topk_min": 0,
                 "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    if fused:
        assert grown == {"sa_group": 2, "sa_mlp_max": 3, "sa_group_scatter": 1,
                         "sa_mlp_max_bwd": 3, **untouched}, grown
    else:
        assert grown == {"sa_group": 2, "sa_mlp_max": 0, "sa_group_scatter": 1,
                         "sa_mlp_max_bwd": 0, **untouched}, grown
    trainer.model.load_state_dict(state)
    with mock.patch.object(K, "sa_group", K.sa_group_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain), \
            mock.patch.object(K, "sa_group_scatter", K.sa_group_scatter_plain), \
            mock.patch.object(K, "sa_mlp_max_bwd", K.sa_mlp_max_bwd_plain):
        want = _step_grads(trainer, batch, valid, 3, pooled)
    _assert_grads_match(trainer.model, got, want, pooled, 5e-2 if fused else 1e-3)


def _assert_grads_match(model, got, want, pooled, tol):
    """Every leaf within ``tol`` under ``grad_check``'s rule: the Dense
    biases that a train BatchNorm normalises and each attention's key bias
    left out (zero in exact arithmetic), the group-all shift held by ``tol`` times its scale leaf's
    gradient norm where every pooled value of both steps is > 0, and by the
    relative bound otherwise."""
    res = GC.compare_grads(got, want, tol, GC.zero_gradient_leaves(model),
                           GC.group_all_shift_leaves(model), GC.pooled_all_positive(pooled))
    assert res["ok"], (res["worst"], res["norm_rel_err"], res["group_all_shift"])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused-ghost"])
def test_classifier_train_step_through_kernels_matches_plain_on_card(cuda_device, fused):
    """One classifier step (task ``classification``, B=16, N=1,024, full
    width) through the kernels and through every kernel's plain version,
    from the same weights and generator (the same FPS starts and dropout
    masks): 2 FPS and 2 ball queries a step, and on the fused path 3 MLP
    forwards and 3 backwards; each parameter's gradient within 1e-3
    relative in norm (default: the index kernels are bit-equal to their
    plain versions) or 5e-2 (fused: ReLU and max decisions, as above)."""
    from pointcloud_orientation_tpu_torch.train import TrainConfig
    ds = OrientationDataset.synthetic(samples_per_class=4, num_points=1024)
    cfg = TrainConfig(task="classification", model="pointnet_pp_cls")
    trainer = Trainer(cfg, ds, device=cuda_device, fused_mlp_train=fused)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    before = K.launch_counts()
    pooled = []
    got = _step_grads(trainer, batch, valid, 3, pooled)
    grown = {k: v - before[k] for k, v in K.launch_counts().items() if v != before[k]}
    assert grown == ({"fps": 2, "ball_query": 2, "sa_mlp_max": 3, "sa_mlp_max_bwd": 3} if fused
                     else {"fps": 2, "ball_query": 2}), grown
    trainer.model.load_state_dict(state)
    with mock.patch.object(K, "fps", K.fps_plain), \
            mock.patch.object(K, "ball_query", K.ball_query_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain), \
            mock.patch.object(K, "sa_mlp_max_bwd", K.sa_mlp_max_bwd_plain):
        want = _step_grads(trainer, batch, valid, 3, pooled)
    _assert_grads_match(trainer.model, got, want, pooled, 5e-2 if fused else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw", [
    ("pointnet_pp", {}), ("pointnet_pp_xyz", {"normalize_heads": False}),
    ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True}),
    ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True, "sampling": "fps", "grouping": "ball"}),
], ids=["pp", "xyz-raw", "schmidt-gs", "schmidt-gs-fps-ball"])
def test_so3_heads_through_kernels_match_plain_on_card(cuda_device, name, kw):
    """The SO(3) heads served at B=16, N=2,048 through the kernels and
    through the plain versions from the same generator state: outputs
    within 1e-4; 2 ``sa_group`` and 3 ``sa_mlp_max`` launches a request on
    the kNN trunk, 2 FPS, 2 ball queries and 3 ``sa_mlp_max`` with
    ``grouping="ball"``."""
    v = random_flax_variables(4, name)
    pred = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=2048,
                                max_batch=16, device=cuda_device, **kw)
    x = np.random.default_rng(4).normal(size=(16, 2048, 3)).astype(np.float32)
    before = K.launch_counts()
    got = pred(x)
    grown = {k: v - before[k] for k, v in K.launch_counts().items() if v != before[k]}
    assert grown == ({"fps": 2, "ball_query": 2, "sa_mlp_max": 3} if kw.get("grouping")
                     else {"sa_group": 2, "sa_mlp_max": 3}), grown
    pred.generator.manual_seed(0)
    got = pred(x)
    pred.generator.manual_seed(0)
    with mock.patch.multiple(K, sa_group=K.sa_group_plain, sa_mlp_max=K.sa_mlp_max_plain,
                             fps=K.fps_plain, ball_query=K.ball_query_plain):
        want = pred(x)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.shape == (16, 3) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused-ghost"])
def test_so3_ball_trunk_train_step_matches_plain_on_card(cuda_device, fused):
    """One ``axes`` step of the Schmidt head with FPS and the ball query
    (B=16, N=2,048, full width) through the kernels and through every
    kernel's plain version, from the same weights and generator: 2 FPS and
    2 ball queries a step (the ball grouping's backward is autograd's
    gather, no scatter kernel), and on the fused path 3 MLP forwards and 3
    backwards; every leaf under ``grad_check``'s rule."""
    from pointcloud_orientation_tpu_torch.train import TrainConfig
    ds = OrientationDataset.synthetic(samples_per_class=4, num_points=2048)
    cfg = TrainConfig(task="axes", model="pointnet_pp_xyz_schmidt", rotation_mode="so3",
                      num_points=2048, axes_gram_schmidt=True)
    trainer = Trainer(cfg, ds, device=cuda_device, fused_mlp_train=fused, sampling="fps",
                      grouping="ball")
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    before = K.launch_counts()
    pooled = []
    got = _step_grads(trainer, batch, valid, 3, pooled)
    grown = {k: v - before[k] for k, v in K.launch_counts().items() if v != before[k]}
    assert grown == ({"fps": 2, "ball_query": 2, "sa_mlp_max": 3, "sa_mlp_max_bwd": 3} if fused
                     else {"fps": 2, "ball_query": 2}), grown
    trainer.model.load_state_dict(state)
    with mock.patch.multiple(K, fps=K.fps_plain, ball_query=K.ball_query_plain,
                             sa_mlp_max=K.sa_mlp_max_plain, sa_mlp_max_bwd=K.sa_mlp_max_bwd_plain):
        want = _step_grads(trainer, batch, valid, 3, pooled)
    _assert_grads_match(trainer.model, got, want, pooled, 5e-2 if fused else 1e-3)


# ---------------------------------------------------------------------------
# the index kernels: kNN above the fused grouping's size, FPS, ball query
# ---------------------------------------------------------------------------


def _unit_cloud(gen, dev, B, N, tiled):
    n = max(1, N // 4) if tiled else N
    x = torch.randn((B, n, 3), generator=gen, device=dev)
    x = x / x.norm(dim=-1).amax(dim=1)[:, None, None]
    return x.repeat(1, -(-N // n), 1)[:, :N].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("shape", [(64, 1024, 512), (64, 512, 128), (16, 10000, 512),
                                   (2, 20000, 40), (3, 33, 40), (2, 32769, 64),
                                   (2, 65536, 64), (2, 40000, 512), (1, 300000, 512),
                                   (1, 600000, 64), (200, 1024, 512)],
                         ids=["sa1", "sa2", "N=10000", "N=20000", "npoint>N", "N=32769",
                              "N=65536", "N=40000", "N=300000", "N=600000", "B=200"])
def test_fps_kernel_equals_plain_on_card(cuda_device, shape, tiled):
    B, N, npoint = shape
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    xyz = _unit_cloud(gen, cuda_device, B, N, tiled)
    seeds = torch.randint(0, N, (B,), generator=gen, device=cuda_device, dtype=torch.int32)
    before = K.fps.launches
    got = K.fps(xyz, seeds, npoint)
    want = K.fps_plain(xyz, seeds, npoint)
    torch.cuda.synchronize()
    assert K.fps.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got[:, 0], seeds)


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_form", [False, True], ids=["difference", "matmul"])
@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("shape", [(64, 512, 1024, 32, 0.2), (64, 128, 512, 64, 0.4),
                                   (2, 7, 50, 80, 0.5), (2, 64, 24576, 32, 0.2)],
                         ids=["sa1", "sa2", "K>N", "N=24576"])
def test_ball_query_kernel_equals_plain_on_card(cuda_device, shape, tiled, matmul_form):
    B, S, N, KN, radius = shape
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xyz = _unit_cloud(gen, cuda_device, B, N, tiled)
    new_xyz = TG.index_points(xyz, TG.random_sample_indices(gen, B, N, S, cuda_device))
    new_xyz = new_xyz.contiguous()
    new_xyz[:, 0] = 3.0  # no point within the radius
    before = K.ball_query.launches
    got = K.ball_query(new_xyz, xyz, radius, KN, matmul_form)
    want = K.ball_query_plain(new_xyz, xyz, radius, KN, matmul_form)
    torch.cuda.synchronize()
    assert K.ball_query.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool((got[:, 0] == N - 1).all())


# (B, S, N, K, radius, case). The kernel stages a cloud in 4,096-point tiles
# and splits a centroid's scan over a block's warps where B * S is under 256
# centroids an SM (33,792 on the H100's 132) and N is above one tile.
BALL_EDGES = {
    "N=1000": (3, 100, 1000, 32, 0.2, "random"),
    "N=5000-split": (2, 64, 5000, 32, 0.2, "random"),
    "N=40000-split": (2, 512, 40_000, 32, 0.2, "random"),
    "N=65536-split": (1, 128, 65_536, 32, 0.1, "random"),
    "N=8192-split": (2, 64, 8192, 32, 0.1, "random"),
    "N=8192-staged-2-tiles": (2, 16_896, 8192, 32, 0.1, "random"),
    "N=5000-staged-K=200": (2, 16_896, 5000, 200, 0.3, "random"),
    "K=300>N": (2, 9, 100, 300, 0.5, "random"),
    "K>N-split": (1, 5, 5000, 6000, 0.2, "random"),
    "all-empty": (4, 128, 1024, 32, 0.2, "empty"),
    "all-empty-split": (2, 64, 40_000, 32, 0.2, "empty"),
    "all-inside": (4, 128, 1024, 32, 10.0, "random"),
    "all-inside-split": (2, 64, 24_576, 64, 10.0, "random"),
    "on-radius": (4, 128, 2048, 32, 0.2, "radius"),
    "on-radius-split": (2, 64, 24_576, 32, 0.2, "radius"),
}


def _ball_edge_case(gen, dev, B, S, N, radius, case):
    xyz = _unit_cloud(gen, dev, B, N, False)
    new_xyz = TG.index_points(xyz, TG.random_sample_indices(gen, B, N, S, dev)).contiguous()
    if case == "empty":
        new_xyz.fill_(3.0)
    elif case == "radius":  # a third of the points at radius * (1 + e), |e| <= 2e-6
        n_near = N // 3
        owner = torch.randint(0, S, (B, n_near), generator=gen, device=dev)
        u = torch.randn((B, n_near, 3), generator=gen, device=dev)
        u = u / u.norm(dim=-1, keepdim=True)
        e = (torch.rand((B, n_near, 1), generator=gen, device=dev) * 2 - 1) * 2e-6
        at = torch.randperm(N, generator=gen, device=dev)[:n_near]
        xyz[:, at] = TG.index_points(new_xyz, owner) + radius * (1 + e) * u
    return new_xyz, xyz.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_form", [False, True], ids=["difference", "matmul"])
@pytest.mark.parametrize("shape", list(BALL_EDGES.values()), ids=list(BALL_EDGES))
def test_ball_query_kernel_edges_on_card(cuda_device, shape, matmul_form):
    """Index for index equal to the plain version in both distance forms:
    N off any multiple of 32 and of the tile, N past one tile (the split
    scan at few centroids, the staged path's tiles at many), nsample of 200
    and above N (in both paths), every centroid empty, every point inside (nsample reached in
    the first group), points on the radius."""
    B, S, N, KN, radius, case = shape
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    new_xyz, xyz = _ball_edge_case(gen, cuda_device, B, S, N, radius, case)
    before = K.ball_query.launches
    got = K.ball_query(new_xyz, xyz, radius, KN, matmul_form)
    want = K.ball_query_plain(new_xyz, xyz, radius, KN, matmul_form)
    torch.cuda.synchronize()
    assert K.ball_query.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if case == "empty":
        assert bool((got == N - 1).all())
    if radius >= 10.0:
        assert bool((got == torch.arange(KN, dtype=torch.int32, device=cuda_device)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["random", "tiled"])
@pytest.mark.parametrize("shape", [(16, 128, 16384, 32), (16, 128, 20480, 32),
                                   (2, 5, 10300, 128), (2, 7, 10241, 1), (2, 3, 100, 100)],
                         ids=["N=16384", "N=20480", "K=128", "K=1", "K=N"])
def test_knn_kernel_equals_plain_on_card(cuda_device, shape, tiled):
    B, S, N, KN = shape
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    xyz = _unit_cloud(gen, cuda_device, B, N, tiled)
    new_xyz = TG.index_points(xyz, TG.random_sample_indices(gen, B, N, S, cuda_device))
    before = K.knn.launches
    got = K.knn(new_xyz.contiguous(), xyz, KN)
    want = K.knn_plain(new_xyz, xyz, KN)
    torch.cuda.synchronize()
    assert K.knn.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
def test_grouping_and_knn_keep_their_nan_behaviour_on_card(cuda_device):
    """A NaN point is never selected while numbers are left (as the plain
    versions' sort puts NaN last); a centroid with NaN coordinates has only
    NaN distances and gets index 0 in every slot, as the argmin passes gave
    it. The matmul form's distances that round below zero (a centroid to
    itself) sort first, as in the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    for n, kn in ((1024, 32), (12_000, 32)):
        xyz = _unit_cloud(gen, cuda_device, 2, n, False) * 40.0
        xyz[0, 7] = float("nan")
        xyz[1, 3] = float("nan")  # a centroid below
        cidx = torch.tensor([[0, 5, 9], [3, 1, 2]], dtype=torch.int32, device=cuda_device)
        new_xyz = TG.index_points(xyz, cidx).contiguous()
        if n <= TG.FUSED_GROUP_MAX_N:
            got = K.sa_group(xyz, None, cidx, kn)[2]
            want = K.sa_group_plain(xyz, None, cidx, kn)[2]
        else:
            got = K.knn(new_xyz, xyz, kn)
            want = K.knn_plain(new_xyz, xyz, kn)
        torch.cuda.synchronize()
        assert not bool((got[0] == 7).any())
        assert torch.equal(got[1, 0], torch.zeros_like(got[1, 0]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1, 1:], want[1, 1:])


@pytest.mark.cuda
def test_index_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    xyz = torch.zeros((1, 64, 3), device=dev)
    with pytest.raises(ValueError):  # beyond the kNN kernel's N
        K.knn(xyz[:, :8], torch.zeros((1, 20481, 3), device=dev), 4)
    with pytest.raises(ValueError):  # more neighbours than points
        K.knn(xyz[:, :8], xyz, 65)
    with pytest.raises(ValueError):  # beyond the FPS kernel's int index (refused unread)
        K.fps(torch.zeros((1, 1, 3), device=dev).expand(1, K.FPS_MAX_N + 1, 3),
              torch.zeros((1,), dtype=torch.int32, device=dev), 4)
    with pytest.raises(TypeError):  # int64 seeds
        K.fps(xyz, torch.zeros((1,), dtype=torch.long, device=dev), 4)
    with pytest.raises(TypeError):
        K.ball_query(xyz[:, :8].double(), xyz.double(), 0.2, 4)
    with pytest.raises(ValueError):  # a cloud on another device
        K.ball_query(xyz[:, :8].cpu(), xyz, 0.2, 4)


@pytest.mark.cuda
def test_classifier_through_kernels_matches_plain_versions_on_card(cuda_device):
    """PointNetPPCls serving at N=1024 with normals: 2 FPS, 2 ball-query and
    3 MLP launches, no grouping kernel; log-probabilities within 1e-4 of the
    plain versions from the same generator state."""
    v = random_flax_variables(5, "pointnet_pp_cls", in_channels=6)
    pred = OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                num_points=1024, max_batch=8, device=cuda_device)
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(5, 900, 3))
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    clouds = np.concatenate([xyz, rng.normal(size=(5, 900, 3))], -1).astype(np.float32)
    before = K.launch_counts()
    pred.generator.manual_seed(1)
    got = pred(clouds)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "sa_group": 0, "sa_mlp_max": 3, "sa_group_scatter": 0, "sa_mlp_max_bwd": 0,
        "knn": 0, "fps": 2, "ball_query": 2, "sa_mlp_max_bf16": 0, "sa_mlp_max_bwd_bf16": 0,
        "topk_min": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    pred.generator.manual_seed(1)
    with mock.patch.object(K, "fps", K.fps_plain), \
            mock.patch.object(K, "ball_query", K.ball_query_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
        want = pred(clouds)
    assert got.shape == (5, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 24576])
def test_large_clouds_serve_on_card(cuda_device, n):
    """8-dir serving above the fused grouping's 10,240 points: sa1 through
    the kNN kernel up to 20,480 points, through the matmul-form sort above;
    logits within 1e-4 of the plain versions."""
    v = random_flax_variables(6)
    pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=n, max_batch=4, device=cuda_device,
                                sampling="first")
    clouds = np.random.default_rng(6).normal(size=(3, n, 3)).astype(np.float32)
    before = K.launch_counts()
    got = pred(clouds)
    after = K.launch_counts()
    grown = {k: after[k] - before[k] for k in after}
    assert grown["knn"] == (1 if n <= TG.KNN_KERNEL_MAX_N else 0)
    assert grown["sa_group"] == 1 and grown["sa_mlp_max"] == 3
    with mock.patch.object(K, "sa_group", K.sa_group_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain), \
            mock.patch.object(K, "knn", K.knn_plain):
        want = pred(clouds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def topk_min_case(gen, dev, B, S, M, Kn, signed=False):
    """Candidate tiles as the grid path makes them, with many exact ties
    (multiples of 1/8), a row with 5 finite entries, an all-inf row and a
    row with exactly K finite entries. ``signed``: the ties drawn from
    negative values, -0.0 beside 0.0 (one key: a stable sort keeps them in
    position order) and positive ones."""
    if signed:
        values = torch.tensor([-2.5, -1.0, -0.0, 0.0, 0.125, 3.0], device=dev)
        d = values[torch.randint(0, len(values), (B, S, M), generator=gen, device=dev)]
    else:
        d = torch.randint(0, 64, (B, S, M), generator=gen, device=dev).float() / 8
    d[0, 0, 5:] = math.inf
    d[0, 1] = math.inf
    d[-1, -1, Kn:] = math.inf
    return d.contiguous()


# (B, S, M, K): the grid path's shapes, then M from staged rows past 12,288
# entries to rows past the kernel's 57,344 staged entries, read from device
# memory (230,000), each at K = 1, 31 and 64
TOPK_CASES = {
    "sa1-grid": (16, 128, 1024, 32), "M=1000": (16, 128, 1000, 32), "M=K": (16, 128, 32, 32),
    "M=4096": (16, 128, 4096, 32), "M=20000": (4, 128, 20000, 32), "K=64": (2, 3, 70, 64),
    **{f"M={m}-K={k}": (b, 4, m, k) for m, b in ((4096, 4), (12288, 2), (12289, 2), (20000, 2),
                                                 (230_000, 1)) for k in (1, 31, 64)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_min_kernel_equals_plain_on_card(cuda_device, case):
    """Bit-equal indices, on tiles with ties and short rows (non-negative,
    and signed with -0.0 beside 0.0), on random distances, and on random
    distances in a contiguous view whose base is not 16-byte aligned (a
    storage offset of one entry)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    shape = TOPK_CASES[case]
    B, S, M, Kn = shape
    tiles = [topk_min_case(gen, cuda_device, *shape),
             topk_min_case(gen, cuda_device, *shape, signed=True),
             torch.rand((B, S, M), generator=gen, device=cuda_device)]
    offset = torch.empty(1 + tiles[-1].numel(), device=cuda_device)[1:].view(B, S, M)
    tiles.append(offset.copy_(tiles[-1]))
    for d in tiles:
        before = K.topk_min.launches
        got = K.topk_min(d, Kn)
        torch.cuda.synchronize()
        assert K.topk_min.launches == before + 1
        assert torch.equal(got, K.topk_min_plain(d, Kn))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1024, 230_000])
def test_topk_min_orders_nan_after_inf_on_card(cuda_device, M):
    """NaN of either sign sorts after +inf, as in the stable sort of
    ``topk_min_plain``, and keeps its position (only +inf gives 0); staged
    rows and rows read from device memory."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    d = torch.rand((2, 3, M), generator=gen, device=cuda_device)
    d[0, 0, 40:] = math.inf
    d[0, 0, 7] = float("nan")
    d[0, 1, :] = -float("nan")
    d[1, 2, 3:10] = math.inf
    d[1, 2, 10:] = float("nan")
    for Kn in (1, 33, 64):
        assert torch.equal(K.topk_min(d, Kn), K.topk_min_plain(d, Kn))


@pytest.mark.cuda
def test_topk_min_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    d = torch.zeros((1, 2, 100), device=cuda_device)
    with pytest.raises(ValueError):
        K.topk_min(d, 65)
    with pytest.raises(ValueError):
        K.topk_min(torch.zeros((1, 2, K.TOPK_MIN_MAX_M + 1), device=cuda_device), 4)
    with pytest.raises(ValueError):
        K.topk_min(d[..., ::2], 4)  # not contiguous


@pytest.mark.cuda
def test_grid_request_launches_topk_min_and_matches_exact_on_card(cuda_device):
    """An 8-dir request at B=4, N=10,000 under the grid dispatch on a cloud
    whose first 128 points (the centroids, sampling "first") lie inside:
    one topk_min launch, no kNN (the certificate holds), sa_group at sa2
    only; logits within 1e-4 of the exact dispatch."""
    v = random_flax_variables(9)
    pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=10_000, max_batch=4, device=cuda_device,
                                sampling="first")
    clouds = np.random.default_rng(9).uniform(-1, 1, size=(4, 10_000, 3)).astype(np.float32)
    clouds[:, :128] *= 0.5
    try:
        TG.set_knn_impl("grid")
        before = K.launch_counts()
        got = pred(clouds)
        after = K.launch_counts()
    finally:
        TG.set_knn_impl("exact")
    grown = {k: after[k] - before[k] for k in after}
    assert grown == {**{k: 0 for k in grown}, "topk_min": 1, "sa_group": 1, "sa_mlp_max": 3}
    np.testing.assert_allclose(got, pred(clouds), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_grid_kernel_artifact_launches_what_the_request_launches_on_card(cuda_device,
                                                                         tmp_path):
    """The 8-dir kernel artifact under the grid dispatch (symbolic batch,
    N=10,000, the certificate a ``torch.cond``) loaded onto the card, at
    B=4: on clouds that certify it launches what the eager grid request
    launches (1 topk_min, no kNN); on a two-cluster cloud that fails the
    certificate, the fallback branch's kNN kernel too; logits within 1e-4
    of the request's."""
    from pointcloud_orientation_tpu_torch.utils.aot_export import (
        export_orientation_model, load_artifact, save_artifact)

    v = random_flax_variables(9)
    pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=10_000, max_batch=4, device=cuda_device,
                                sampling="first")
    rng = np.random.default_rng(9)
    certified = rng.uniform(-1, 1, size=(4, 10_000, 3)).astype(np.float32)
    certified[:, :128] *= 0.5
    clusters = rng.uniform(2, 3, size=(4, 10_000, 3)).astype(np.float32)
    clusters[:, 1::2] *= -1
    path = str(tmp_path / "grid_kernels.pt2")
    try:
        TG.set_knn_impl("grid")
        save_artifact(path, export_orientation_model(
            "pointnet_pp_8dir", v["params"], v["batch_stats"], batch_size=None,
            num_points=10_000, use_kernels=True))
        program = load_artifact(path, device=cuda_device).module()
        for clouds, knn in ((certified, 0), (clusters, 1)):
            K.reset_launch_counts()
            want = pred(clouds)
            request = K.launch_counts()
            K.reset_launch_counts()
            got = program(torch.from_numpy(clouds).to(cuda_device)).cpu().numpy()
            artifact = K.launch_counts()
            assert request == artifact == {**{k: 0 for k in artifact}, "topk_min": 1,
                                           "knn": knn, "sa_group": 1, "sa_mlp_max": 3}
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    finally:
        TG.set_knn_impl("exact")


# ---------------------------------------------------------------------------
# the MLP forward against its backward's recompute
# ---------------------------------------------------------------------------

# (K, widths) of every stage the MLP kernels run: the 8-dir trunk's and the
# classifier's (K=64 at its sa2, 128 rows at its group-all)
RECOMPUTE_STAGES = {"sa1": (32, (3, 64, 64, 128)), "sa2": (32, (131, 128, 128, 256)),
                    "sa3": (32, (259, 256, 512, 1024)), "cls-sa1": (32, (6, 64, 64, 128)),
                    "cls-sa2": (64, (131, 128, 128, 256)),
                    "cls-group-all": (128, (259, 256, 512, 1024))}


def _affine_f32(z, s, t):
    return np.float32(np.float32(np.float32(z) * np.float32(s)) + np.float32(t))


def _random_layers(widths, gen, dev):
    return [(torch.randn((ci, co), generator=gen, device=dev) / math.sqrt(ci),
             torch.rand((co,), generator=gen, device=dev) + 0.5,
             0.1 * torch.randn((co,), generator=gen, device=dev))
            for ci, co in zip(widths[:-1], widths[1:])]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", list(RECOMPUTE_STAGES))
def test_backward_recompute_reproduces_the_pooled_value_on_card(cuda_device, stage, bf16):
    """One centroid whose neighbours are near ties, dpooled one-hot at a
    column with a positive pooled value: where the backward routes it to one
    neighbour, its last dscale is the recomputed z at the recomputed
    maximum, and relu(z * s + t) (two roundings) is the forward's pooled
    value bit for bit."""
    kn, widths = RECOMPUTE_STAGES[stage]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    checked = 0
    for _ in range(2):
        base = torch.randn((widths[0],), generator=gen, device=cuda_device)
        noise = torch.randn((1, kn, 1, widths[0]), generator=gen, device=cuda_device)
        g = (base * (1 + (2.0 ** -6 if bf16 else 2.0 ** -12) * noise)).contiguous()
        layers = _random_layers(widths, gen, cuda_device)
        pooled = K.sa_mlp_max(g, layers, bf16=bf16)[0, 0]
        for c in torch.nonzero(pooled > 0).flatten()[:8].tolist():
            dp = torch.zeros((1, 1, widths[-1]), device=cuda_device)
            dp[0, 0, c] = 1.0
            dg, dl = K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16)
            if int((dg[0, :, 0] != 0).any(dim=-1).sum()) != 1:
                continue  # a tied maximum: dscale mixes the tied rows
            y = max(_affine_f32(float(dl[-1][1][c]), float(layers[-1][1][c]),
                                float(layers[-1][2][c])), np.float32(0.0))
            assert np.float32(y).view(np.int32) == np.float32(float(pooled[c])).view(np.int32)
            checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# the selection micro-benchmarks (csrc/vpu_select.cu)
# ---------------------------------------------------------------------------

# (B, S, N, K): the JAX file's shape, the training grouping's, K=1, K=N, N
# not a multiple of 32, and a row of the kNN kernel's size; then the edges
# of the selections' designs (a warp a row up to N=1,024, a lane's words 1
# to 32; a block a row above), each at K=1 and K=N; and the last row held in
# registers (16,384), the first in shared memory and the longest (MAX_N),
# each at K=1 and K=32
VPU_SELECT_CASES = {"B=64-N=1024": (64, 128, 1024, 32), "B=16-N=10000": (16, 128, 10_000, 32),
                    "K=1": (2, 8, 300, 1), "K=N": (2, 8, 40, 40), "N=1000": (3, 5, 1000, 7),
                    "N=20480": (2, 4, 20_480, 32),
                    **{f"N={n}-K={k}": (2, 3, n, k)
                       for n in (1, 31, 32, 33, 1023, 1024, 1025, 10_000) for k in sorted({1, n})},
                    **{f"N={n}-K={k}": (2, 3, n, k)
                       for n in (16_384, 16_385, 49_152) for k in (1, 32)}}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["random", "ties", "inf", "equal", "signed"])
@pytest.mark.parametrize("case", list(VPU_SELECT_CASES))
@pytest.mark.parametrize("name", ["sel_argmin", "sel_mintie", "radix_count", "count_emit"])
def test_vpu_select_kernels_equal_plain_on_card(cuda_device, name, case, rows):
    """Each selection bit for bit against its plain version, on random and
    tie-rich rows, rows with +inf runs, all-equal rows, and signed rows
    (-0.0 beside +0.0, negative values: bit patterns below zero for the
    radix kernels)."""
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    b, s, n, kn = VPU_SELECT_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    d = PV.select_rows(rows, (b, s, n), gen)
    fn = getattr(PV, name)
    before = fn.launches
    got = fn(d, kn)
    want = PV.PLAIN[fn](d, kn)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["random", "ties", "inf", "equal", "signed"])
@pytest.mark.parametrize("case", list(VPU_SELECT_CASES))
def test_vpu_sel_argmin_equals_sel_mintie_on_card(cuda_device, case, rows):
    """The two K-pass kernels share their keys and differ only in a pass's
    reduction (one packed argmin against a minimum and its lowest tied
    lane), so their outputs are equal bit for bit."""
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    b, s, n, kn = VPU_SELECT_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    d = PV.select_rows(rows, (b, s, n), gen)
    before = PV.sel_argmin.launches, PV.sel_mintie.launches
    got, want = PV.sel_argmin(d, kn), PV.sel_mintie(d, kn)
    torch.cuda.synchronize()
    assert (PV.sel_argmin.launches, PV.sel_mintie.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["random", "ties", "inf", "equal", "signed"])
@pytest.mark.parametrize("case", list(VPU_SELECT_CASES))
def test_vpu_radix_count_is_the_count_emit_threshold_on_card(cuda_device, case, rows):
    """radix_count's answer is the threshold count_emit emits against:
    every lane count_emit emits holds a bit pattern at or below it, and
    every pattern of the row strictly below it is emitted (the first K of
    them where K or more lie below it: a row with K negative patterns has
    the threshold 0)."""
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    b, s, n, kn = VPU_SELECT_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    d = PV.select_rows(rows, (b, s, n), gen)
    before = PV.radix_count.launches, PV.count_emit.launches
    threshold = PV.radix_count(d, kn)[:, 0, :, None]  # (B, S, 1)
    lanes = PV.count_emit(d, kn).transpose(1, 2).long()  # (B, S, K)
    torch.cuda.synchronize()
    assert (PV.radix_count.launches, PV.count_emit.launches) == (before[0] + 1, before[1] + 1)
    bits = d.view(torch.int32)
    emitted = torch.gather(bits, -1, lanes)
    assert (emitted <= threshold).all()
    # the lanes emitted are distinct, so equal counts below the threshold
    # mean every such lane of the row was emitted
    below = (bits < threshold).sum(-1)
    assert torch.equal((emitted < threshold).sum(-1), below.clamp_max(kn))
    assert (lanes.diff(dim=-1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [3, 32])
@pytest.mark.parametrize("shape", [(64, 128, 1024), (3, 5, 37)], ids=["jax-shape", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16],
                         ids=["f32", "bf16", "int16"])
def test_vpu_ew_kernel_bit_equal_to_plain_on_card(cuda_device, dtype, shape, reps):
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = PV.ew_input(dtype, shape, gen)
    before = PV.ew.launches
    got = PV.ew(x, reps)
    want = PV.ew_plain(x, reps)
    torch.cuda.synchronize()
    assert PV.ew.launches == before + 1
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert got.dtype == dtype and torch.equal(got.view(view), want.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [0, 1, 31, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16],
                         ids=["f32", "bf16", "int16"])
def test_vpu_ew_kernel_bit_equal_to_plain_on_edge_values_and_tails_on_card(cuda_device, dtype,
                                                                           reps):
    """The edge values (signed zeros, infinities, NaN, subnormals; int16's
    extremes and wrapping values) at every edge length (tails of 1 to 7
    elements past whole 16-byte vectors, lengths below one vector, more
    vectors than the persistent grid's threads), the benchmark's unrolled
    32 rounds and the run-time loop's other counts, bit for bit (NaN
    included)."""
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    for n in PV.EW_EDGE_LENGTHS:
        x = PV.ew_edge_input(dtype, n, gen)
        got, want = PV.ew(x, reps), PV.ew_plain(x, reps)
        torch.cuda.synchronize()
        differ = int((got.view(view) != want.view(view)).sum())
        assert got.dtype == dtype and differ == 0, (n, differ)


@pytest.mark.cuda
def test_vpu_select_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
    d = torch.rand((1, 2, PV.MAX_N + 1), device=cuda_device)
    with pytest.raises(ValueError):
        PV.sel_argmin(d, 4)  # a row past shared memory
    with pytest.raises(ValueError):
        PV.count_emit(torch.rand((1, 4, 64), device=cuda_device)[:, ::2], 4)  # not contiguous
    with pytest.raises(ValueError):
        PV.ew(torch.ones(9, device=cuda_device)[1:])  # not 16-byte aligned


# the flash attention kernels: (B, H, N, D) at the preset's request, the
# long-context step's, and small or odd cases (one tile; D=8 and 32)
FLASH_CASES = {"preset": (16, 4, 1024, 16), "long": (2, 4, 16384, 16), "one-tile": (3, 2, 128, 16),
               "D=8": (2, 3, 384, 8), "D=32": (2, 2, 640, 32)}
# kernel vs plain, the largest difference over the plain output's largest
# value (l relative, m over max(1, |m|)): f32 sums in other orders; bf16
# also flips roundings of p, ds and the outputs (a bf16 step is 2^-8)
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def _flash_rel(a, b):
    return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernels_match_plain_on_card(cuda_device, case, dtype):
    """The forward (o, l, m), dK/dV and dQ kernels against their plain
    versions on the same inputs, each launched once."""
    from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
    shape = FLASH_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    before = K.launch_counts()
    o, l, m = K.flash_attention_fwd(q, k, v, scale)
    di = FA.row_di(o, do)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale)
    dq = K.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale)
    torch.cuda.synchronize()
    grown = {n: c - before[n] for n, c in K.launch_counts().items() if c != before[n]}
    assert grown == {"flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
                     "flash_attention_bwd_dq": 1}
    assert o.dtype == dk.dtype == dv.dtype == dq.dtype == dtype
    po, pl, pm = FA.flash_attention_plain(q, k, v, scale)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert _flash_rel(o, po) <= fwd_tol
    assert float(((l - pl).abs() / pl).max()) <= 1e-5
    assert float((m - pm).abs().max()) <= 1e-5 * max(1.0, float(pm.abs().max()))
    pdk, pdv = FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, scale)
    pdq = FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, scale)
    for got, want in ((dk, pdk), (dv, pdv), (dq, pdq)):
        assert _flash_rel(got, want) <= bwd_tol


# B*H odd and five 128-row tiles: the grid's batch-head count and the
# double buffer's last stage differ from the cases above (ten 64-row blocks)
FLASH_ODD = {"odd": (1, 3, 640, 16)}


def _flash_case(dev, shape, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES) + list(FLASH_ODD))
def test_flash_attention_kernels_repeat_their_bits_on_card(cuda_device, case, dtype):
    """The forward, dK/dV and dQ kernels sum each output row in one warp in
    a fixed order (no atomics): two calls on the same inputs give the same
    bits, o, l, m, dk, dv and dq."""
    from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
    shape = {**FLASH_CASES, **FLASH_ODD}[case]
    q, k, v, do = _flash_case(cuda_device, shape, dtype, 12)
    scale = shape[-1] ** -0.5
    first = K.flash_attention_fwd(q, k, v, scale)
    second = K.flash_attention_fwd(q, k, v, scale)
    di = FA.row_di(first[0], do)
    args = (q, k, v, first[1], first[2], do, di, scale)
    first += (*K.flash_attention_bwd_dkv(*args), K.flash_attention_bwd_dq(*args))
    second += (*K.flash_attention_bwd_dkv(*args), K.flash_attention_bwd_dq(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "l", "m", "dk", "dv", "dq"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES) + list(FLASH_ODD))
def test_flash_attention_forward_statistics_feed_dq_on_card(cuda_device, case, dtype):
    """The forward kernel's l and m (and o, through di) feed the dQ and
    dK/dV kernels, and the result is the plain backward on the plain
    forward's own statistics, within FLASH_TOL; at the odd case the forward
    is also held to its plain version."""
    from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
    shape = {**FLASH_CASES, **FLASH_ODD}[case]
    q, k, v, do = _flash_case(cuda_device, shape, dtype, 13)
    scale = shape[-1] ** -0.5
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    o, l, m = K.flash_attention_fwd(q, k, v, scale)
    di = FA.row_di(o, do)
    dq = K.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale)
    torch.cuda.synchronize()
    po, pl, pm = FA.flash_attention_plain(q, k, v, scale)
    assert _flash_rel(o, po) <= fwd_tol
    assert float(((l - pl).abs() / pl).max()) <= 1e-5
    assert float((m - pm).abs().max()) <= 1e-5 * max(1.0, float(pm.abs().max()))
    pdi = FA.row_di(po, do)
    want = (FA.flash_attention_bwd_dq_plain(q, k, v, pl, pm, do, pdi, scale),
            *FA.flash_attention_bwd_dkv_plain(q, k, v, pl, pm, do, pdi, scale))
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _flash_rel(got, w) <= bwd_tol, name


@pytest.mark.cuda
def test_flash_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """A head dimension the kernels do not take raises naming it (no
    fallback); so do other types, N off the 128 grid and mixed devices."""
    def qkv(shape, dtype=torch.float32, dev=cuda_device):
        return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(3)]

    with pytest.raises(ValueError, match="head dimension D=12"):
        K.flash_attention_fwd(*qkv((1, 1, 128, 12)), 1.0)
    with pytest.raises(ValueError, match="head dimension D=64"):
        K.flash_attention_fwd(*qkv((1, 1, 128, 64)), 1.0)
    with pytest.raises(TypeError, match="float16"):
        K.flash_attention_fwd(*qkv((1, 1, 128, 16), torch.float16), 1.0)
    with pytest.raises(ValueError, match="divisible by block_k_major=128"):
        K.flash_attention_fwd(*qkv((1, 1, 192, 16)), 1.0)
    q, k, _ = qkv((1, 1, 128, 16))
    with pytest.raises(ValueError):
        K.flash_attention_fwd(q, k, torch.zeros((1, 1, 128, 16)), 1.0)
    o, l, m = K.flash_attention_fwd(*qkv((1, 1, 128, 16)), 1.0)
    with pytest.raises(TypeError):
        K.flash_attention_bwd_dq(q, k, q, l.double(), m, q, l, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_point_transformer_flash_step_through_kernels_matches_plain_on_card(cuda_device, dtype):
    """One ``point_transformer`` step with ``transformer_attention="flash"``
    (B=16, N=1,024, full width) through the kernels and through their
    plain versions, from the same weights and generator (the same residual
    and feed-forward dropout masks): 6 forward, 6 dK/dV and 6 dQ launches,
    the outputs of an eval request likewise, and each parameter's gradient
    within 1e-3 (f32: only the order of f32 sums differs) or 1e-1 (bf16:
    flipped roundings of p and ds, through six layers) relative in norm,
    each attention's key bias left out (zero in exact arithmetic)."""
    import warnings
    from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
    plain = {"flash_attention_fwd": FA.flash_attention_plain,
             "flash_attention_bwd_dkv": FA.flash_attention_bwd_dkv_plain,
             "flash_attention_bwd_dq": FA.flash_attention_bwd_dq_plain}
    ds = OrientationDataset.synthetic(samples_per_class=20, num_points=1024,
                                      class_names=["chair"])
    trainer = Trainer(preset("point_transformer", transformer_attention="flash",
                             compute_dtype=dtype), ds, device=cuda_device)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
    batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 1, 0))
    before = K.launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash backend's dropout warning
        got = _step_grads(trainer, batch, valid, 3, [])
        grown = {k: v - before[k] for k, v in K.launch_counts().items() if v != before[k]}
        assert grown == {"flash_attention_fwd": 6, "flash_attention_bwd_dkv": 6,
                         "flash_attention_bwd_dq": 6}, grown
        trainer.model.load_state_dict(state)
        with mock.patch.multiple(K, **plain):
            want = _step_grads(trainer, batch, valid, 3, [])
    _assert_grads_match(trainer.model, got, want, [], 1e-3 if dtype is None else 1e-1)
    trainer.model.load_state_dict(state)
    trainer.model.eval()
    with torch.no_grad():
        out = trainer.model(batch["points"])
        with mock.patch.multiple(K, **plain):
            out_plain = trainer.model(batch["points"])
    assert float((out - out_plain).abs().max()) <= (1e-4 if dtype is None else 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["pointnet_pp_8dir", "pointnet_pp_von_mises",
                                   "pointnet_pp_mvm"])
def test_ensemble_request_is_its_members_combined_on_card(cuda_device, model):
    """A 3-member ensemble request at B=16 N=1,024: three single requests'
    launches, and its output equal to the host's combine of the three
    single-member predictors' outputs (same sampling draws: one generator
    state for every member)."""
    members = [random_flax_variables(40 + i, model) for i in range(3)]
    kw = dict(num_points=1024, max_batch=16, seed=5, device=cuda_device)
    ens = OrientationPredictor.from_seed_sweep(model, members, **kw)
    singles = [OrientationPredictor.from_seed_sweep(model, [m], **kw) for m in members]
    x = np.random.default_rng(4).normal(size=(16, 1024, 3)).astype(np.float32)
    before = K.launch_counts()
    got = ens(x)
    torch.cuda.synchronize()
    n_ens = {k: v - before[k] for k, v in K.launch_counts().items()}
    before = K.launch_counts()
    outs = [p(x) for p in singles]
    torch.cuda.synchronize()
    n_one = {k: v - before[k] for k, v in K.launch_counts().items()}
    assert n_ens == n_one and n_ens["sa_group"] == 6 and n_ens["sa_mlp_max"] == 9
    if model == "pointnet_pp_8dir":
        p = [torch.softmax(torch.from_numpy(o).double(), -1) for o in outs]
        want = torch.log(sum(p) / 3 + 1e-12).numpy()
        assert np.abs(got - want).max() <= 1e-6
    elif model == "pointnet_pp_von_mises":
        def moment(mu, kappa):
            from pointcloud_orientation_tpu_torch.ops.von_mises import bessel_ratio
            a = bessel_ratio(torch.from_numpy(np.asarray(kappa, np.float64))).numpy()
            return np.stack([a * np.cos(mu), a * np.sin(mu)], -1)
        want = np.mean([moment(*o) for o in outs], 0)
        assert np.abs(moment(*got) - want).max() <= 1e-6
    else:
        mu, kappa, w = (np.concatenate([o[j] for o in outs], -1) for j in range(3))
        d = np.mod(got[0] - mu + np.pi, 2 * np.pi) - np.pi
        assert np.abs(d).max() <= 1e-5
        assert np.abs(got[1] - kappa).max() <= 1e-5 and np.abs(got[2] - w / 3).max() <= 1e-5


@pytest.mark.cuda
def test_preempted_run_resumes_bit_equal_on_card(cuda_device, tmp_path):
    """8dir_kl at B=16 N=1,024, asynchronous checkpoints every epoch, a
    guard requested after epoch 2 of 3: ``epoch_1.pt``, which only the
    writer thread wrote (the preemption save rewrites ``epoch_2.pt``), is
    byte for byte the uninterrupted run's synchronous ``epoch_1.pt``;
    resumed from it, the history and every weight, statistic and optimizer
    moment equal the uninterrupted run's bit for bit (no float atomics on
    the path)."""
    from pointcloud_orientation_tpu_torch.train.reliability import PreemptionGuard

    ds = OrientationDataset.synthetic(samples_per_class=8, num_points=1024)
    cfg = preset("8dir_kl", num_points=1024, epochs=3, checkpoint_every=1,
                 async_checkpoint=True)
    full = Trainer(cfg.replace(async_checkpoint=False), ds, device=cuda_device)
    full.fit(log_every=0, checkpoint_dir=str(tmp_path / "full"))
    run = Trainer(cfg, ds, device=cuda_device)
    with PreemptionGuard() as guard:
        real = run.run_epoch

        def run_epoch(e):
            out = real(e)
            if e == 2:
                guard.request()
            return out

        run.run_epoch = run_epoch
        run.fit(log_every=0, checkpoint_dir=str(tmp_path / "run"), preemption_guard=guard)
    assert run.epoch == 2
    path = tmp_path / "run" / "epoch_1.pt"
    assert path.read_bytes() == (tmp_path / "full" / "epoch_1.pt").read_bytes()
    resumed = Trainer(cfg, ds, device=cuda_device)
    resumed.restore_checkpoint(str(path))
    resumed.fit(start_epoch=2, log_every=0)
    assert resumed.history == full.history
    for (k, a), b in zip(resumed.model.state_dict().items(), full.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    full.optimizer.state_dict()["state"].values()):
        assert all(a[k].device == b[k].device and torch.equal(a[k], b[k]) for k in a)
