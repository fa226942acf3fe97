"""The f32 MLP backward kernel's numerics on the CPU: csrc/sa_mlp_max_bwd.cu
computes its three products (the forward recompute, dW = x^T dz and
da = dz W^T) as 3xTF32 on the card's tensor cores. Emulated here in plain
PyTorch, product by product as the kernel splits it, and held against
``_sa_mlp_max_bwd_impl`` (the VJP of ``sa_mlp_max_pallas``, HIGHEST f32,
interpret mode), the counterpart of
``tests/test_torch_kernels.py::test_3xtf32_mlp_max_matches_pallas_f32``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops.pallas_kernels import _sa_mlp_max_bwd_impl

# (K, S, MLP widths) of the three set abstractions of the trunk
SA_WIDTHS = {
    "sa1": (32, 128, (3, 64, 64, 128)),
    "sa2": (32, 32, (131, 128, 128, 256)),
    "sa3": (32, 1, (259, 256, 512, 1024)),
}


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as the kernel's tf32_rna rounds finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the kernel's f32 template takes it: 3 passes, lo*hi +
    hi*lo + hi*hi of each operand split as hi = rna(x), lo = rna(x - hi)
    (each partial product exact in f32, the sums rounded); 1 pass, hi*hi
    alone."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    z = ah @ bh
    if passes == 3:
        z = (_tf32_rna(a - ah) @ bh + ah @ _tf32_rna(b - bh)) + z
    return z


def _mlp_max_bwd_tf32(grouped, layers, dpooled, passes):
    """The recompute backward with every product as ``_product``; the rest
    in f32 as the kernel: y = z * s + t, a = relu(y), the pooled cotangent
    split evenly over the ties of the recomputed maximum, then per layer
    dy = da * (y > 0), dscale = sum(dy * z), dshift = sum(dy), dz = dy * s,
    dW = x^T dz, da = dz W^T."""
    B, Kn, S, C = grouped.shape
    acts, pre = [grouped.reshape(-1, C)], []
    for w, s, t in layers:
        z = _product(acts[-1], w, passes)
        y = z * s + t
        pre.append((z, y))
        acts.append(torch.relu(y))
    a_last = acts[-1].reshape(B, Kn, S, -1)
    ties = (a_last == a_last.amax(dim=1, keepdim=True)).float()
    da = (ties * (dpooled / ties.sum(dim=1))[:, None]).reshape(-1, a_last.shape[-1])
    dlayers = []
    for l in range(len(layers) - 1, -1, -1):
        (z, y), (w, s, _) = pre[l], layers[l]
        dy = da * (y > 0.0).float()
        dz = dy * s
        dlayers.insert(0, (_product(acts[l].t(), dz, passes), (dy * z).sum(dim=0),
                           dy.sum(dim=0)))
        da = _product(dz, w.t(), passes)
    return da.reshape(B, Kn, S, C), dlayers


@pytest.mark.parametrize("stage", sorted(SA_WIDTHS))
def test_3xtf32_mlp_max_bwd_matches_pallas_f32(rng, stage):
    """B=2 at each set abstraction's widths, normal random inputs: every
    output of the 3xTF32 backward within rtol 1e-4 and atol 1e-4 times the
    output's largest entry of the Pallas f32 backward (the card's gate
    between the kernel and its plain version, chip_smoke.py BWD_TOL): the
    split keeps about 21 of f32's 24 bits of each operand and drops only
    lo*lo, so the error is of the order of f32 rounding in sums of up to
    8,192 rows. One TF32 pass is printed beside it, not asserted: it keeps
    about three decimal digits, which is why the kernel splits."""
    kn, s, widths = SA_WIDTHS[stage]
    g = rng.normal(size=(2, kn, s, widths[0])).astype(np.float32)
    layers = [((rng.normal(size=(ci, co)) / math.sqrt(ci)).astype(np.float32),
               rng.uniform(0.5, 1.5, size=co).astype(np.float32),
               (0.1 * rng.normal(size=co)).astype(np.float32))
              for ci, co in zip(widths[:-1], widths[1:])]
    dpooled = rng.normal(size=(2, s, widths[-1])).astype(np.float32)
    want_dg, want_layers = _sa_mlp_max_bwd_impl(
        jnp.asarray(g), [tuple(map(jnp.asarray, layer)) for layer in layers],
        jnp.asarray(dpooled), False, True)
    want = [np.asarray(want_dg)] + [np.asarray(x) for layer in want_layers for x in layer]
    tl = [tuple(map(torch.from_numpy, layer)) for layer in layers]
    results = {}
    for passes in (3, 1):
        dg, dlayers = _mlp_max_bwd_tf32(torch.from_numpy(g), tl, torch.from_numpy(dpooled),
                                        passes)
        results[passes] = [dg.numpy()] + [x.numpy() for layer in dlayers for x in layer]
    rel = {p: max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
                  for a, b in zip(got, want)) for p, got in results.items()}
    print(f"{stage}: largest error over the output's scale against the Pallas f32 backward: "
          f"3xTF32 {rel[3]:.2e}, one TF32 pass {rel[1]:.2e}")
    names = ["dgrouped"] + [f"layer {i} {n}" for i in range(len(layers))
                            for n in ("dW", "ds", "dt")]
    for name, got, ref in zip(names, results[3], want):
        assert got.shape == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
