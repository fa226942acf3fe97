"""The port's two kernel modules on the CPU: plain versions against the JAX
package's Pallas kernels (interpret mode), wrapper dispatch and checks, and
the nvcc build's set-up. The kernels themselves are held against their plain
versions on the card, in tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.ops.pallas_kernels import sa_mlp_max_pallas
from pointcloud_orientation_tpu_torch.ops import _build
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


@pytest.mark.parametrize("stage", sorted(SA_WIDTHS))
def test_sa_mlp_max_matches_pallas(rng, stage):
    kn, s, widths = SA_WIDTHS[stage]
    g = rng.normal(size=(2, kn, s, widths[0])).astype(np.float32)
    layers = _layers_np(rng, widths)
    want = sa_mlp_max_pallas(
        jnp.asarray(g), [tuple(map(jnp.asarray, layer)) for layer in layers], False, True)
    got = K.sa_mlp_max(torch.from_numpy(g),
                       [tuple(map(torch.from_numpy, layer)) for layer in layers])
    assert got.shape == (2, s, widths[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds finite values: half a TF32 ulp added to
    the magnitude's bits, then the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mlp_max_tf32(grouped, layers, passes):
    """The f32 MLP kernel's numerics in plain PyTorch: every product of the
    layers as ``passes`` TF32 products summed in f32. 3 (the kernel's
    3xTF32): lo*hi + hi*lo + hi*hi with hi = rna(x), lo = rna(x - hi) for
    both operands; 1: hi*hi alone, one TF32 pass. A product of two TF32
    values is exact in f32, so only the sums round."""
    B, Kn, S, C = grouped.shape
    x = grouped.reshape(-1, C)
    for w, s, t in layers:
        xh, wh = _tf32_rna(x), _tf32_rna(w)
        z = xh @ wh
        if passes == 3:
            z = (_tf32_rna(x - xh) @ wh + xh @ _tf32_rna(w - wh)) + z
        x = torch.relu(z * s + t)
    return x.reshape(B, Kn, S, -1).amax(dim=1)


@pytest.mark.parametrize("stage", sorted(SA_WIDTHS))
def test_3xtf32_mlp_max_matches_pallas_f32(rng, stage):
    """The f32 MLP kernel multiplies as 3xTF32 on the card's tensor cores;
    emulated here at the trunk's widths, it lies within 1e-4 (the kernel's
    f32 gate on the card, chip_smoke.py MLP_TOL) of sa_mlp_max_pallas in
    interpret mode (HIGHEST f32): the split keeps about 21 of f32's 24 bits
    of each operand and drops only lo*lo (~2^-22 relative), so the error is
    of the order of f32 rounding in sums of up to 512 products. One TF32
    pass is printed beside it, not asserted: it keeps about three decimal
    digits, which is why the kernel splits."""
    kn, s, widths = SA_WIDTHS[stage]
    g = rng.normal(size=(2, kn, s, widths[0])).astype(np.float32)
    layers = _layers_np(rng, widths)
    want = np.asarray(sa_mlp_max_pallas(
        jnp.asarray(g), [tuple(map(jnp.asarray, layer)) for layer in layers], False, True))
    tg = torch.from_numpy(g)
    tl = [tuple(map(torch.from_numpy, layer)) for layer in layers]
    got = _mlp_max_tf32(tg, tl, 3).numpy()
    one_pass = _mlp_max_tf32(tg, tl, 1).numpy()
    print(f"{stage}: max abs err against the Pallas f32 kernel: 3xTF32 "
          f"{np.abs(got - want).max():.2e}, one TF32 pass {np.abs(one_pass - want).max():.2e}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_without_counting(rng):
    K.reset_launch_counts()
    xyz = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    cidx = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    got = K.sa_group(xyz, None, cidx, 4)
    want = K.sa_group_plain(xyz, None, cidx, 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    layers = [(torch.ones(3, 5), torch.ones(5), torch.zeros(5))]
    g = torch.from_numpy(rng.normal(size=(2, 4, 8, 3)).astype(np.float32))
    assert torch.equal(K.sa_mlp_max(g, layers), K.sa_mlp_max_plain(g, layers))
    assert K.launch_counts() == {"sa_group": 0, "sa_mlp_max": 0, "sa_group_scatter": 0,
                                 "sa_mlp_max_bwd": 0, "knn": 0, "fps": 0, "ball_query": 0,
                                 "sa_mlp_max_bf16": 0, "sa_mlp_max_bwd_bf16": 0,
                                 "topk_min": 0, "flash_attention_fwd": 0,
                                 "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}


def test_wrappers_refuse_other_dtypes_and_devices():
    xyz = torch.zeros((1, 64, 3), dtype=torch.float64)
    cidx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.sa_group(xyz, None, cidx, 4)
    with pytest.raises(TypeError):  # grouped features are f32 in either variant
        K.sa_mlp_max(torch.zeros((1, 4, 8, 3), dtype=torch.bfloat16),
                     [(torch.ones(3, 5), torch.ones(5), torch.zeros(5))])
    with pytest.raises(ValueError):
        K.sa_group(torch.zeros((1, 64, 3), device="meta"), None,
                   torch.zeros((1, 8), dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError):
        K.sa_mlp_max(torch.zeros((1, 4, 8, 3), device="meta"),
                     [(torch.ones(3, 5), torch.ones(5), torch.zeros(5))])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build._Library().load()


def test_build_flags_and_signatures():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-Xptxas -v" in flags
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == ["ball_query.cu", "flash_attention.cu", "fps.cu", "knn.cu", "sa_group.cu",
                       "sa_mlp_max.cu", "sa_mlp_max_bwd.cu", "sa_scatter.cu", "topk_min.cu",
                       "vpu_select.cu"]
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == ["threshold_select.cuh"]
    text = "".join((_build.CSRC / s).read_text() for s in sources)
    for name, argtypes in _build.SIGNATURES.items():
        assert f'extern "C" int {name}(' in text
        assert argtypes[-1] is _build.ctypes.c_void_p  # the stream
    assert "torch/extension.h" not in text
    log = ("ptxas info    : Function properties for k\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, 576 bytes smem\nother\n")
    assert _build.ptxas_lines(log) == [
        "ptxas info    : Function properties for k",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 576 bytes smem"]



_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(("link " if "-c" not in args else "start ") + out + " " + repr(time.time()) + "\\n")
if "-c" in args:
    src = args[-1]
    if "broken" in src:
        print("error: broken source"); sys.exit(2)
    time.sleep(0.3)
    print("ptxas info    : Used 8 registers for " + src)
    with open({log!r}, "a") as f:
        f.write("end " + out + " " + repr(time.time()) + "\\n")
open(out, "w").write("object")
"""


def test_build_compiles_every_source_at_once_then_links(tmp_path):
    """One nvcc a source, all started before any ends, then one link of
    their objects, returning what they printed; a source that fails
    raises with its output, and no library is left."""
    import sys

    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    sources = []
    for name in ("a.cu", "b.cu", "c.cu"):
        (tmp_path / name).write_text("// source")
        sources.append(tmp_path / name)
    objs = [tmp_path / f"{p.stem}.o" for p in sources]
    out = _build._compile_and_link(str(nvcc), sources, objs, tmp_path / "lib.so")
    assert (tmp_path / "lib.so").read_text() == "object"
    assert out.count("ptxas info") == 3
    calls = [line.split() for line in log.read_text().splitlines()]
    starts = [float(t) for kind, _, t in calls if kind == "start"]
    ends = [float(t) for kind, _, t in calls if kind == "end"]
    assert len(starts) == len(ends) == 3 and max(starts) < min(ends)
    assert calls[-1][0] == "link"
    (tmp_path / "broken.cu").write_text("// source")
    with pytest.raises(_build.BuildError, match="broken source"):
        _build._compile_and_link(str(nvcc), sources + [tmp_path / "broken.cu"],
                                 objs + [tmp_path / "broken.o"], tmp_path / "lib2.so")
    assert not (tmp_path / "lib2.so").exists()
