"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_orientation_tpu_torch/csrc``
with nvcc, holds each kernel against its plain PyTorch version at the shapes
the serving path gives it, serves requests through
``OrientationPredictor`` (PointNet++ 8-dir, full width, random weights from
a seed) at N=1024 and N=10,000 and checks that they went through the
kernels, then times the kernels and the requests with CUDA events and the
host clock. Prints one flushed JSON line per phase, each with a ``"phase"``
key; any failure raises and exits non-zero. The line before the last is the
per-kernel summary with the run's total seconds, and the last line is
``{"ok": true, "device": ...}``.

Imports only the port, torch, numpy and the standard library. Exits
non-zero before building anything when no CUDA device is visible.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from pointcloud_orientation_tpu_torch import OrientationPredictor, random_flax_variables
from pointcloud_orientation_tpu_torch.ops import _build, cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops.geometry import random_sample_indices

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores. The bound of a kernel is the larger of its bytes
# and its FLOPs over these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TIMING_ITERS = 20
SEED = 0

# The kernels' shapes on the serving path. K1: (B, N, S, K, D); K2: (B, K, S,
# widths). sa1/sa2/sa3 at the bench shape (B=64, N=1024) and sa1 at the
# reference's canonical N=10,000 (B=16).
SA_GROUP_SHAPES = {
    "sa1 B=64 N=1024": (64, 1024, 128, 32, 0),
    "sa1 B=16 N=10000": (16, 10000, 128, 32, 0),
    "sa2 B=64": (64, 128, 32, 32, 128),
}
SA_MLP_SHAPES = {
    "sa1 B=64": (64, 32, 128, (3, 64, 64, 128)),
    "sa2 B=64": (64, 32, 32, (131, 128, 128, 256)),
    "sa3 B=64": (64, 32, 1, (259, 256, 512, 1024)),
}
# one forward at the bench shape launches these (summed in the last line)
BENCH_FORWARD = {"sa_group": ("sa1 B=64 N=1024", "sa2 B=64"),
                 "sa_mlp_max": ("sa1 B=64", "sa2 B=64", "sa3 B=64")}
MLP_TOL = 1e-4  # rtol and atol: the kernel sums in another order than cuBLAS
LOGIT_TOL = 1e-4

T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sa_group_cost(B, N, S, Kn, D) -> tuple[float, float]:
    """Bytes (each input read once, each output written once) and f32
    operations: 8 per centroid-point distance, 5 per squared norm, 3 per
    centred neighbour."""
    nbytes = 4 * (B * N * 3 + B * N * D + B * S) + 4 * (B * S * 3 + B * Kn * S * (3 + D) + B * S * Kn)
    flops = 8 * B * S * N + 5 * B * N + 5 * B * S + 3 * B * Kn * S
    return nbytes, flops


def sa_mlp_cost(B, Kn, S, widths) -> tuple[float, float]:
    rows = B * Kn * S
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 4 * (rows * widths[0] + sum(ci * co + 2 * co for ci, co in pairs) + B * S * widths[-1])
    flops = sum(2 * rows * ci * co + 3 * rows * co for ci, co in pairs) + rows * widths[-1]
    return nbytes, flops


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no CUDA device to run on",
              file=sys.stderr, flush=True)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi.stdout.strip().splitlines()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "capability": list(torch.cuda.get_device_capability(0)),
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    lib = _build.LIBRARY
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=lib.build_seconds,
         library=str(lib.path), ptxas=_build.ptxas_lines(lib.nvcc_log))


def make_layers(widths, gen, dev):
    layers = []
    for ci, co in zip(widths[:-1], widths[1:]):
        w = torch.randn((ci, co), generator=gen, device=dev) / math.sqrt(ci)
        s = torch.rand((co,), generator=gen, device=dev) + 0.5
        t = 0.1 * torch.randn((co,), generator=gen, device=dev)
        layers.append((w, s, t))
    return layers


def sa_group_inputs(shape, gen, dev, tiled: bool):
    B, N, S, Kn, D = shape
    if tiled:  # the predictor's padding: a short cloud cycled to N points (exact ties)
        base = torch.randn((B, max(Kn, N // 4), 3), generator=gen, device=dev)
        xyz = base.repeat(1, -(-N // base.shape[1]), 1)[:, :N].contiguous()
    else:
        xyz = torch.randn((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, D), generator=gen, device=dev) if D else None
    cidx = random_sample_indices(gen, B, N, S, dev).to(torch.int32).contiguous()
    return xyz, feats, cidx


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {"sa_group": {}, "sa_mlp_max": {}}
    for name, shape in SA_GROUP_SHAPES.items():
        for tiled in (False, True):
            xyz, feats, cidx = sa_group_inputs(shape, gen, dev, tiled)
            got = K.sa_group(xyz, feats, cidx, shape[3])
            ref = K.sa_group_plain(xyz, feats, cidx, shape[3])
            torch.cuda.synchronize()
            for label, a, b in zip(("new_xyz", "grouped", "idx"), got, ref):
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"sa_group {name}: {label} {tuple(a.shape)} {a.dtype} vs "
                         f"{tuple(b.shape)} {b.dtype}")
                if not torch.equal(a, b):
                    diff = int((a != b).sum())
                    fail(f"sa_group {name} tiled={tiled}: {label} differs in {diff} entries")
        results["sa_group"][name] = {"max_abs_err": 0.0, "exact": True}
        emit("kernel_check", kernel="sa_group", shape=name, exact=True,
             inputs=["random", "tiled"])
    for name, (B, Kn, S, widths) in SA_MLP_SHAPES.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        got = K.sa_mlp_max(g, layers)
        ref = K.sa_mlp_max_plain(g, layers)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"sa_mlp_max {name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        err = (got - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
        ok = bool(torch.allclose(got, ref, rtol=MLP_TOL, atol=MLP_TOL))
        emit("kernel_check", kernel="sa_mlp_max", shape=name, max_abs_err=max_abs,
             max_rel_err=max_rel, tol=MLP_TOL, ok=ok)
        if not ok or not torch.isfinite(got).all():
            fail(f"sa_mlp_max {name}: max abs err {max_abs} beyond rtol=atol={MLP_TOL}")
        results["sa_mlp_max"][name] = {"max_abs_err": max_abs}
    return results


def phase_serve(dev) -> dict:
    v = random_flax_variables(SEED)
    rng = np.random.default_rng(SEED)
    requests = [(1024, 64, b) for b in (1, 13, 64, 100)] + [(10000, 16, 16)]
    predictors = {
        n: OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=n, max_batch=mb, seed=SEED, device=dev)
        for n, mb in {(n, mb) for n, mb, _ in requests}
    }
    clouds = {(n, b): rng.normal(size=(b, n, 3)).astype(np.float32) for n, _, b in requests}

    # the main path: counts from 0, every request, counts read right after
    K.reset_launch_counts()
    outs, chunks_total = {}, 0
    per_request = []
    for n, mb, b in requests:
        before = K.launch_counts()
        out = predictors[n](clouds[(n, b)])
        after = K.launch_counts()
        chunks = -(-b // mb)
        chunks_total += chunks
        grown = {k: after[k] - before[k] for k in after}
        if out.shape != (b, 8) or not np.isfinite(out).all():
            fail(f"request N={n} B={b}: output {out.shape}, finite={np.isfinite(out).all()}")
        if grown != {"sa_group": 2 * chunks, "sa_mlp_max": 3 * chunks}:
            fail(f"request N={n} B={b} ({chunks} chunks): launches grew by {grown}")
        outs[(n, b)] = out
        per_request.append({"N": n, "B": b, "chunks": chunks, "launches": grown})
    launches = K.launch_counts()
    emit("serve", requests=per_request, launches=launches)
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was never launched: {launches}")

    fwd = predictors[1024].forward_vectors(clouds[(1024, 13)])
    norms = np.linalg.norm(fwd, axis=-1)
    if fwd.shape != (13, 3) or not np.allclose(norms, 1.0, atol=1e-5):
        fail(f"forward_vectors: shape {fwd.shape}, norms {norms}")

    # the same model through the plain versions on the card (sampling="first")
    first = {
        n: OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=n, max_batch=mb, seed=SEED, device=dev,
                                sampling="first")
        for n, mb in ((1024, 64), (10000, 16))
    }
    parity = []
    for n, b in ((1024, 64), (10000, 16)):
        x = clouds[(n, b)]
        with_kernels = first[n](x)
        with mock.patch.object(K, "sa_group", K.sa_group_plain), \
                mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
            plain = first[n](x)
        err = float(np.abs(with_kernels - plain).max())
        ok = bool(np.allclose(with_kernels, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL))
        parity.append({"N": n, "B": b, "max_abs_err": err, "ok": ok})
        if not ok:
            fail(f"logits N={n} B={b}: kernels vs plain versions max abs err {err}")
    emit("serve_check", forward_vector_norm_max_dev=float(np.abs(norms - 1).max()),
         logits_vs_plain=parity, tol=LOGIT_TOL)
    return {"launches": launches, "predictors": predictors, "clouds": clouds}


def phase_timing(dev, checks: dict, serve: dict) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    per_shape = {"sa_group": {}, "sa_mlp_max": {}}
    for name, shape in SA_GROUP_SHAPES.items():
        xyz, feats, cidx = sa_group_inputs(shape, gen, dev, tiled=False)
        ms = cuda_ms(lambda: K.sa_group(xyz, feats, cidx, shape[3]))
        plain_ms = cuda_ms(lambda: K.sa_group_plain(xyz, feats, cidx, shape[3]))
        b_ms, b_by = bound_ms(*sa_group_cost(*shape))
        per_shape["sa_group"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                           **checks["sa_group"][name])
        emit("timing", kernel="sa_group", shape=name, **per_shape["sa_group"][name])
    for name, (B, Kn, S, widths) in SA_MLP_SHAPES.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        ms = cuda_ms(lambda: K.sa_mlp_max(g, layers))
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_plain(g, layers))
        b_ms, b_by = bound_ms(*sa_mlp_cost(B, Kn, S, widths))
        per_shape["sa_mlp_max"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by, **checks["sa_mlp_max"][name])
        emit("timing", kernel="sa_mlp_max", shape=name, **per_shape["sa_mlp_max"][name])

    # request latency per bucket (host clock around a whole request, which
    # ends in a device-to-host copy), median of 5 after one warm-up
    predictors, rng = serve["predictors"], np.random.default_rng(SEED + 2)
    latency = []
    for n, buckets in ((1024, (1, 2, 4, 8, 16, 32, 64)), (10000, (16,))):
        for b in buckets:
            x = rng.normal(size=(b, n, 3)).astype(np.float32)
            predictors[n](x)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                predictors[n](x)
                ts.append((time.perf_counter() - t0) * 1e3)
            med = float(np.median(ts))
            latency.append({"N": n, "B": b, "ms_median": med, "ms_all": ts,
                            "clouds_per_s": b / med * 1e3})
    emit("timing_serve", requests=latency)

    summary = []
    sources = {"sa_group": ("pointcloud_orientation_tpu_torch/csrc/sa_group.cu",
                            "pointcloud_orientation_tpu/ops/pallas_kernels.py:468"),
               "sa_mlp_max": ("pointcloud_orientation_tpu_torch/csrc/sa_mlp_max.cu",
                              "pointcloud_orientation_tpu/ops/pallas_kernels.py:738")}
    for kname, shapes in BENCH_FORWARD.items():
        rows = [per_shape[kname][s] for s in shapes]
        b_ms = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        summary.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "launches": serve["launches"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape[kname].values()),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": "bytes" if by_bytes * 2 >= b_ms else "operations",
            "library_ms": None,
            "per": "one forward at B=64 N=1024: " + ", ".join(shapes),
            "shapes": per_shape[kname],
        })
    return summary


def main() -> None:
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    checks = phase_kernels(dev)
    serve = phase_serve(dev)
    summary = phase_timing(dev, checks, serve)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": summary,
                      "total_seconds": round(time.perf_counter() - T_START, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
