"""On the card only (marker ``cuda``; skipped without a CUDA device): each
CUDA kernel of the port against its plain PyTorch version, the wrappers'
refusals, and the model's logits through the kernels against the same model
through the plain versions.

This file imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu_torch import OrientationPredictor, random_flax_variables
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as TG

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
                                   (64, 128, 32, 32, 128), (3, 40, 5, 40, 7)],
                         ids=["sa1-1024", "sa1-10000", "sa2", "K=N"])
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
    assert {k: after[k] - before[k] for k in after} == {"sa_group": 2, "sa_mlp_max": 3}
    with mock.patch.object(K, "sa_group", K.sa_group_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
        want = pred(clouds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
