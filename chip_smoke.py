"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_orientation_tpu_torch/csrc``
with nvcc and holds each kernel against its plain PyTorch version at the
shapes its path gives it. Then drives the main paths at full width, random
weights from a seed, each with the launch counters set to 0 just before and
read just after: serving through ``OrientationPredictor`` (PointNet++ 8-dir)
at N=1024 and N=10,000; serving the ModelNet40 classifier
(``pointnet_pp_cls``, FPS and ball query, 6-channel clouds) at N=1024;
8-dir serving at N=16,384 (the kNN kernel) and N=24,576 (no kernel for the
kNN) and one 8dir_kl train step at N=16,384; and training of the 8dir_kl
preset (B=16, N=10,000) through ``Trainer`` in both train configurations
(the default, and ``fused_mlp_train``), with a gradient check against the
plain versions and a checkpoint round trip. Finally times the kernels, the
requests and the train steps with CUDA events and the host clock. Prints one
flushed JSON line per phase, each with a ``"phase"`` key; any failure raises
and exits non-zero. The line before the last is the per-kernel summary with
the run's total seconds, and the last line is ``{"ok": true, "device": ...}``.

Imports only the port, torch, numpy and the standard library. Exits
non-zero before building anything when no CUDA device is visible.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from pointcloud_orientation_tpu_torch import OrientationPredictor, random_flax_variables
from pointcloud_orientation_tpu_torch.data import OrientationDataset, synthetic_modelnet
from pointcloud_orientation_tpu_torch.ops import _build, cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import geometry as G
from pointcloud_orientation_tpu_torch.ops.geometry import random_sample_indices
from pointcloud_orientation_tpu_torch.train import Trainer, preset

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores. The bound of a kernel is the larger of its bytes
# and its FLOPs over these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TIMING_ITERS = 20
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's SM clock: a sleep at least this long
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
    # the classifier's three stages at B=64 N=1024 (6-channel clouds); the
    # group-all stage's 128 rows run in two chunks
    "cls sa1 B=64": (64, 32, 512, (6, 64, 64, 128)),
    "cls sa2 B=64": (64, 64, 128, (131, 128, 128, 256)),
    "cls group-all K=128 B=64": (64, 128, 1, (259, 256, 512, 1024)),
}
# one forward at the bench shape launches these (summed in the last line)
BENCH_FORWARD = {"sa_group": ("sa1 B=64 N=1024", "sa2 B=64"),
                 "sa_mlp_max": ("sa1 B=64", "sa2 B=64", "sa3 B=64")}
MLP_TOL = 1e-4  # rtol and atol: the kernel sums in another order than cuBLAS
LOGIT_TOL = 1e-4
SERVE_KERNELS = ("sa_group", "sa_mlp_max")

# The index kernels' shapes. FPS: (B, N, npoint), the classifier's two stages
# at B=64 N=1024 and a 10,000-point cloud. Ball query: (B, S, N, K, radius),
# the classifier's two stages. kNN: (B, S, N, K), the 8-dir sa1 above the
# fused grouping's 10,240 points, up to the kernel's 20,480.
FPS_SHAPES = {"sa1 B=64 N=1024": (64, 1024, 512), "sa2 B=64 N=512": (64, 512, 128),
              "B=16 N=10000": (16, 10000, 512)}
BALL_SHAPES = {"sa1 B=64": (64, 512, 1024, 32, 0.2), "sa2 B=64": (64, 128, 512, 64, 0.4)}
KNN_SHAPES = {"sa1 B=16 N=16384": (16, 128, 16384, 32), "sa1 B=16 N=20480": (16, 128, 20480, 32)}
CLS_FORWARD = {"fps": ("sa1 B=64 N=1024", "sa2 B=64 N=512"), "ball_query": ("sa1 B=64", "sa2 B=64")}
CLS_CHANNELS = 6  # xyz and normals
LARGE_N = (16_384, 24_576)  # 8-dir serving with and without the kNN kernel
LSE_TOL = 1e-5  # log-probabilities: each row's logsumexp is 0 up to f32 rounding

# The training path's backward kernels at the 8dir_kl preset's B=16 (N=10,000
# points; sa2 groups 128 points). Scatter: (B, N, S, K, D); MLP: (B, K, S, widths).
SCATTER_SHAPE = (16, 128, 32, 32, 128)
TRAIN_MLP_SHAPES = {
    "sa1 B=16": (16, 32, 128, (3, 64, 64, 128)),
    "sa2 B=16": (16, 32, 32, (131, 128, 128, 256)),
    "sa3 B=16": (16, 32, 1, (259, 256, 512, 1024)),
}
SCATTER_TOL = 1e-5  # the plain index_add_ sums up to 32 slots in another order
# the MLP backward: rtol, and atol times the output's largest entry (sums
# over up to 65,536 rows in another order), on inputs whose forward is exact
BWD_TOL = 1e-4
# on normal random inputs the kernel's and cuBLAS's f32 forwards can put a
# few pre-activations on opposite sides of zero, which reroutes those rows'
# gradients: held in norm, relative, per output
BWD_RANDOM_NORM_TOL = 1e-3
# a train step's gradients through the kernels vs the plain versions, per
# parameter, relative in norm (fused: ReLU/max decisions, as above)
GRAD_TOL = {"default": 1e-3, "fused": 5e-2}
TRAIN_N = 10_000
TRAIN_SAMPLES_PER_CLASS = 8  # 48 clouds: 3 train steps and 1 val batch at B=16
TRAIN_STEP_ITERS = 5

T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn`` over ``iters`` back-to-back
    calls. The host ms is the time the host takes to enqueue one call. For
    the device time the card first sleeps for twice the host's enqueue time
    of all the calls, so that the calls queue up and run back to back: a
    kernel shorter than its wrapper's host overhead is then timed on the
    device, not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0 * host_s * SLEEP_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    return timed(fn, iters, warmup)[0]


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


def fps_cost(B, N, npoint) -> tuple[float, float]:
    """Bytes: the cloud and the seeds read once, the indices written once.
    Operations: 10 per point for each of the npoint - 1 updates (3
    differences, 3 squares, 2 adds, the running min, the argmax compare)."""
    return 4 * (B * N * 3 + B + B * npoint), 10 * B * N * (npoint - 1)


def ball_cost(B, S, N, Kn, scanned) -> tuple[float, float]:
    """Bytes: cloud and centroids read once, indices written once.
    Operations: 9 per point a query must test (3 differences, 3 squares, 2
    adds, the compare), ``scanned`` of them: for each centroid the points up
    to its Kn-th hit, or all N when it has fewer (what this run's data
    needs)."""
    return 4 * (B * N * 3 + B * S * 3 + B * S * Kn), 9 * scanned


def knn_cost(B, S, N, Kn) -> tuple[float, float]:
    """Bytes: cloud and centroids read once, indices written once.
    Operations: 8 per centroid-point distance and one selection compare per
    centroid-point pair (picking the Kn smallest of N needs on the order of
    N compares, not the Kn passes over all N that the kernel makes)."""
    return 4 * (B * N * 3 + B * S * 3 + B * S * Kn), 9 * B * S * N


def ball_scanned(new_xyz, xyz, radius, Kn) -> int:
    """The points the ball query of these inputs must test: for each
    centroid up to its Kn-th point within ``radius``, else all N."""
    hits = (G.diff_square_distance(new_xyz, xyz) <= K.radius_sq_f32(radius)).int().cumsum(-1)
    full = hits[..., -1] >= Kn
    need = torch.where(full, (hits < Kn).sum(-1) + 1, torch.full_like(full, xyz.shape[1],
                                                                      dtype=torch.long))
    return int(need.sum())


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


def unit_cloud(B, N, gen, dev, tiled: bool) -> torch.Tensor:
    """``(B, N, 3)`` points scaled into the unit ball, as the classifier's
    clouds are; ``tiled``: a quarter of them cycled to N (exact ties, and
    four times the points inside any radius)."""
    n = max(1, N // 4) if tiled else N
    x = torch.randn((B, n, 3), generator=gen, device=dev)
    x = (x / x.norm(dim=-1).amax(dim=1)[:, None, None]).contiguous()
    return x.repeat(1, -(-N // n), 1)[:, :N].contiguous() if tiled else x


def select_inputs(kernel, shape, gen, dev, case):
    """The inputs of one index kernel at ``shape``: ``case`` is "random",
    "tiled", "empty" (ball query: centroid 0 of every cloud far from the
    cloud) or "seeds" (FPS: random non-zero start points)."""
    if kernel == "fps":
        B, N, npoint = shape
        xyz = unit_cloud(B, N, gen, dev, case == "tiled")
        if case == "seeds":
            seeds = torch.randint(1, N, (B,), generator=gen, device=dev, dtype=torch.int32)
        else:
            seeds = torch.zeros((B,), dtype=torch.int32, device=dev)
        return xyz, seeds, npoint
    if kernel == "ball_query":
        B, S, N, Kn, radius = shape
        xyz = unit_cloud(B, N, gen, dev, case == "tiled")
        cidx = random_sample_indices(gen, B, N, S, dev)
        new_xyz = G.index_points(xyz, cidx).contiguous()
        if case == "empty":
            new_xyz[:, 0] = 3.0
        return new_xyz, xyz, radius, Kn
    B, S, N, Kn = shape
    xyz = unit_cloud(B, N, gen, dev, case == "tiled")
    cidx = random_sample_indices(gen, B, N, S, dev)
    return G.index_points(xyz, cidx).contiguous(), xyz, Kn


SELECT = {  # kernel: (shapes, cases, plain version)
    "fps": (FPS_SHAPES, ("random", "tiled", "seeds"), K.fps_plain),
    "ball_query": (BALL_SHAPES, ("random", "tiled", "empty"), K.ball_query_plain),
    "knn": (KNN_SHAPES, ("random", "tiled"), K.knn_plain),
}


def phase_kernels_select(dev) -> dict:
    """FPS, ball query and kNN bit-equal to their plain versions on random
    clouds, tiled clouds (ties), start seeds and empty radii."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    results = {k: {} for k in SELECT}
    for kname, (shapes, cases, plain) in SELECT.items():
        for name, shape in shapes.items():
            for case in cases:
                args = select_inputs(kname, shape, gen, dev, case)
                got = getattr(K, kname)(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    fail(f"{kname} {name} {case}: {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(want.shape)} {want.dtype}")
                if not torch.equal(got, want):
                    fail(f"{kname} {name} {case}: differs in {int((got != want).sum())} entries")
                if case == "empty" and not bool((got[:, 0] == args[1].shape[1] - 1).all()):
                    fail(f"{kname} {name}: a centroid with an empty radius got {got[0, 0]}")
            results[kname][name] = {"max_abs_err": 0.0, "exact": True}
            emit("kernel_check", kernel=kname, shape=name, exact=True, inputs=list(cases))
    return results


def expected_launches(**nonzero) -> dict:
    """Every counter at 0 but the ones given."""
    return {**{k: 0 for k in K.launch_counts()}, **nonzero}


def cls_clouds(b, n, rng) -> np.ndarray:
    """``(b, n, 6)`` classifier inputs: synthetic ModelNet-like xyz (boxes
    with a nose, centred and scaled) and unit normals pointing outwards."""
    xyz, _, _ = synthetic_modelnet(seed=int(rng.integers(1 << 30)), num_points=n,
                                   samples_per_class=-(-b // 6))
    xyz = xyz[rng.permutation(len(xyz))[:b]].astype(np.float32)
    normals = xyz / (np.linalg.norm(xyz, axis=-1, keepdims=True) + 1e-6)
    return np.concatenate([xyz, normals], axis=-1).astype(np.float32)


def phase_serve_cls(dev) -> dict:
    """The classifier's main path: ``OrientationPredictor("pointnet_pp_cls")``
    at N=1024, max_batch 64, 6-channel clouds, B = 1, 13, 64, 100; per chunk
    2 FPS, 2 ball-query and 3 MLP launches, no grouping kernel."""
    v = random_flax_variables(SEED, "pointnet_pp_cls", in_channels=CLS_CHANNELS)
    rng = np.random.default_rng(SEED + 6)
    pred = OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                num_points=1024, max_batch=64, seed=SEED, device=dev)
    clouds = {b: cls_clouds(b, 1024, rng) for b in (1, 13, 64, 100)}

    K.reset_launch_counts()
    per_request = []
    for b, x in clouds.items():
        before = K.launch_counts()
        out = pred(x)
        after = K.launch_counts()
        chunks = -(-b // 64)
        grown = {k: after[k] - before[k] for k in after}
        lse = np.log(np.exp(out.astype(np.float64)).sum(-1))
        if out.shape != (b, 40) or not np.isfinite(out).all() or np.abs(lse).max() > LSE_TOL:
            fail(f"classifier B={b}: output {out.shape}, logsumexp up to {np.abs(lse).max()}")
        if grown != expected_launches(fps=2 * chunks, ball_query=2 * chunks,
                                      sa_mlp_max=3 * chunks):
            fail(f"classifier B={b} ({chunks} chunks): launches grew by {grown}")
        per_request.append({"B": b, "chunks": chunks, "launches": grown,
                            "max_abs_logsumexp": float(np.abs(lse).max())})
    launches = K.launch_counts()
    emit("serve_cls", requests=per_request, launches=launches)

    # the B=64 log-probabilities through the kernels and through the plain
    # versions, from the same generator state (the same FPS start points)
    x = clouds[64]
    pred.generator.manual_seed(SEED)
    with_kernels = pred(x)
    pred.generator.manual_seed(SEED)
    with mock.patch.object(K, "fps", K.fps_plain), \
            mock.patch.object(K, "ball_query", K.ball_query_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
        plain = pred(x)
    err = float(np.abs(with_kernels - plain).max())
    ok = bool(np.allclose(with_kernels, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL))
    emit("serve_cls_check", B=64, max_abs_err=err, tol=LOGIT_TOL, ok=ok)
    if not ok:
        fail(f"classifier B=64: kernels vs plain versions max abs err {err}")
    return {"launches": launches, "predictor": pred}


def phase_large(dev) -> dict:
    """Clouds above the fused grouping kernel's 10,240 points: 8-dir serving
    at N=16,384 (sa1 through the kNN kernel) and N=24,576 (sa1 through the
    matmul-form sort), each against the plain versions, then one 8dir_kl
    train step at B=16 N=16,384."""
    v = random_flax_variables(SEED)
    rng = np.random.default_rng(SEED + 7)
    out = {"predictors": {}, "launches": {}}
    patches = (("sa_group", K.sa_group_plain), ("sa_mlp_max", K.sa_mlp_max_plain),
               ("knn", K.knn_plain))
    for n in LARGE_N:
        x = rng.normal(size=(16, n, 3)).astype(np.float32)
        pred = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                    num_points=n, max_batch=16, seed=SEED, device=dev)
        K.reset_launch_counts()
        got = pred(x)
        launches = K.launch_counts()
        knn_n = 1 if n <= G.KNN_KERNEL_MAX_N else 0
        if launches != expected_launches(knn=knn_n, sa_group=1, sa_mlp_max=3):
            fail(f"8-dir N={n}: launches {launches}")
        if got.shape != (16, 8) or not np.isfinite(got).all():
            fail(f"8-dir N={n}: output {got.shape}, finite={np.isfinite(got).all()}")
        pred.generator.manual_seed(SEED)
        with_kernels = pred(x)
        pred.generator.manual_seed(SEED)
        with mock.patch.multiple(K, **dict(patches)):
            plain = pred(x)
        err = float(np.abs(with_kernels - plain).max())
        ok = bool(np.allclose(with_kernels, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL))
        emit("serve_large", N=n, B=16, launches=launches, max_abs_err=err, tol=LOGIT_TOL, ok=ok)
        if not ok:
            fail(f"8-dir N={n}: kernels vs plain versions max abs err {err}")
        out["predictors"][n] = pred
        out["launches"][n] = launches

    n = LARGE_N[0]
    ds = OrientationDataset(*synthetic_modelnet(num_points=n, samples_per_class=3))
    trainer = Trainer(preset("8dir_kl", num_points=n), ds, device=dev)
    idx, valid, _ = next(trainer.train_ds.batches(16))
    batch, valid, _ = trainer.device_batch(trainer.train_ds, idx, valid,
                                           trainer.generator(0, 96, 0))
    K.reset_launch_counts()
    loss = float(trainer.train_step(batch, valid, trainer.generator(0, 95, 0))["loss"])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expected = expected_launches(knn=1, sa_group=1, sa_group_scatter=1)
    emit("train_large", N=n, B=16, loss=loss, launches=launches, expected_launches=expected)
    if not math.isfinite(loss) or launches != expected:
        fail(f"8dir_kl step at N={n}: loss {loss}, launches {launches}")
    out["train_launches"] = launches
    return out


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
        if grown != expected_launches(sa_group=2 * chunks, sa_mlp_max=3 * chunks):
            fail(f"request N={n} B={b} ({chunks} chunks): launches grew by {grown}")
        outs[(n, b)] = out
        per_request.append({"N": n, "B": b, "chunks": chunks, "launches": grown})
    launches = K.launch_counts()
    emit("serve", requests=per_request, launches=launches)
    if min(launches[k] for k in SERVE_KERNELS) == 0:
        fail(f"a kernel of the serving path was never launched: {launches}")

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
        ms, host_ms = timed(lambda: K.sa_group(xyz, feats, cidx, shape[3]))
        plain_ms = cuda_ms(lambda: K.sa_group_plain(xyz, feats, cidx, shape[3]))
        b_ms, b_by = bound_ms(*sa_group_cost(*shape))
        per_shape["sa_group"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                           host_ms=host_ms, **checks["sa_group"][name])
        emit("timing", kernel="sa_group", shape=name, **per_shape["sa_group"][name])
    for name, (B, Kn, S, widths) in SA_MLP_SHAPES.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        ms, host_ms = timed(lambda: K.sa_mlp_max(g, layers))
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_plain(g, layers))
        b_ms, b_by = bound_ms(*sa_mlp_cost(B, Kn, S, widths))
        per_shape["sa_mlp_max"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by, host_ms=host_ms,
                                             **checks["sa_mlp_max"][name])
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


def request_latency(pred, x) -> dict:
    """Host clock around whole requests (ending in a device-to-host copy),
    median of 5 after one warm-up."""
    pred(x)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred(x)
        ts.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ts))
    return {"N": x.shape[1], "B": x.shape[0], "ms_median": med, "ms_all": ts,
            "clouds_per_s": x.shape[0] / med * 1e3}


def phase_timing_select(dev, checks: dict, cls: dict, large: dict) -> list:
    """The index kernels at their shapes (CUDA events, bound, plain version),
    the classifier's request latency and 8-dir requests on large clouds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    per_shape = {k: {} for k in SELECT}
    for kname, (shapes, _, plain) in SELECT.items():
        for name, shape in shapes.items():
            args = select_inputs(kname, shape, gen, dev, "random")
            kernel = getattr(K, kname)
            ms, host_ms = timed(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args), iters=3 if kname == "fps" else TIMING_ITERS,
                               warmup=1)
            if kname == "fps":
                cost = fps_cost(*shape)
            elif kname == "ball_query":
                cost = ball_cost(*shape[:4], ball_scanned(*args))
            else:
                cost = knn_cost(*shape)
            b_ms, b_by = bound_ms(*cost)
            per_shape[kname][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                          share=b_ms / ms, library_ms=None, host_ms=host_ms,
                                          ops=cost[1], **checks[kname][name])
            emit("timing", kernel=kname, shape=name, **per_shape[kname][name])

    rng = np.random.default_rng(SEED + 9)
    latency = [request_latency(cls["predictor"], cls_clouds(b, 1024, rng)) for b in (1, 64)]
    emit("timing_serve_cls", requests=latency)
    latency = [request_latency(large["predictors"][n],
                               rng.normal(size=(16, n, 3)).astype(np.float32))
               for n in LARGE_N]
    emit("timing_serve_large", requests=latency)

    paths = {
        "fps": ("fps.cu", ":74", CLS_FORWARD["fps"], cls["launches"]["fps"],
                "one classifier forward at B=64 N=1024: sa1, sa2",
                "classifier serving, B=1/13/64/100 (5 chunks)"),
        "ball_query": ("ball_query.cu", ":202", CLS_FORWARD["ball_query"],
                       cls["launches"]["ball_query"],
                       "one classifier forward at B=64 N=1024: sa1, sa2",
                       "classifier serving, B=1/13/64/100 (5 chunks)"),
        "knn": ("knn.cu", ":238", ("sa1 B=16 N=16384",), large["launches"][LARGE_N[0]]["knn"],
                "one 8-dir forward at B=16 N=16384: sa1", "8-dir serving at N=16384, B=16"),
    }
    summary = []
    for kname, (src, line, shapes, launches, per, path) in paths.items():
        rows = [per_shape[kname][s] for s in shapes]
        b_ms = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"pointcloud_orientation_tpu_torch/csrc/{src}",
            "replaces": f"pointcloud_orientation_tpu/ops/pallas_kernels.py{line}",
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": "bytes" if by_bytes * 2 >= b_ms else "operations",
            "library_ms": None, "per": per, "launches_path": path, "shapes": per_shape[kname],
        })
    return summary


def scatter_cost(B, N, S, Kn, D) -> tuple[float, float]:
    """Bytes: the cotangents and indices read once, the rows written once;
    operations: one add per cotangent."""
    return 4 * (B * Kn * S * D + B * S * Kn + B * N * D), B * S * Kn * D


def mlp_bwd_cost(B, Kn, S, widths) -> tuple[float, float]:
    """Bytes: grouped, the layers and dpooled read once; dgrouped and the
    summed dW, dscale, dshift written once. Operations: the recompute, dW
    and da products (6 * rows * sum Cin*Cout) and ~12 elementwise per
    activation (affine, relu, max/tie split, mask, dscale/dshift sums)."""
    rows = B * Kn * S
    pairs = list(zip(widths[:-1], widths[1:]))
    params = sum(ci * co + 2 * co for ci, co in pairs)
    nbytes = 4 * (rows * widths[0] + params + B * S * widths[-1]) + 4 * (rows * widths[0] + params)
    flops = sum(6 * rows * ci * co + 12 * rows * co for ci, co in pairs)
    return nbytes, flops


def dyadic_mlp_case(gen, dev, b, kn, s, widths, dead=False):
    """Inputs on which every forward product and sum is exact in f32 in any
    order (grouped in multiples of 1/8 in [-1, 1], W in {-1, 0, 1}, scale a
    power of two near 1/sqrt(Cin), shift a multiple of the layer's
    granularity), so that the kernel and the plain version take the same
    ReLU and max decisions; the max has many exact ties, split evenly.
    ``dead``: the last shift at -1000, every pooled value 0, all tied."""
    g = torch.randint(-8, 9, (b, kn, s, widths[0]), generator=gen, device=dev) / 8.0
    layers, bits = [], 3
    for ci, co in zip(widths[:-1], widths[1:]):
        e = math.ceil(math.log2(math.sqrt(ci)))
        bits += e
        w = torch.randint(-1, 2, (ci, co), generator=gen, device=dev).float().contiguous()
        sc = torch.full((co,), 2.0 ** -e, device=dev)
        t = (torch.randint(-16, 17, (co,), generator=gen, device=dev) * 2.0 ** -bits).float()
        layers.append((w, sc, t))
    if dead:
        layers[-1] = (layers[-1][0], layers[-1][1], torch.full_like(layers[-1][2], -1000.0))
    dp = torch.randn((b, s, widths[-1]), generator=gen, device=dev)
    return g.float().contiguous(), layers, dp


def bwd_outputs(res):
    dg, dlayers = res
    out = [("dgrouped", dg)]
    for i, layer in enumerate(dlayers):
        out += [(f"layer{i}.{n}", x) for n, x in zip(("dW", "ds", "dt"), layer)]
    return out


def phase_kernels_bwd(dev) -> dict:
    """The backward kernels against their plain versions at the training
    path's shapes, and the scatter's determinism."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    results = {"sa_group_scatter": {}, "sa_mlp_max_bwd": {}}
    B, N, S, Kn, D = SCATTER_SHAPE
    xyz, feats, cidx = sa_group_inputs(SCATTER_SHAPE, gen, dev, tiled=False)
    idx = K.sa_group(xyz, feats, cidx, Kn)[2]  # the grouping's own indices
    dg = torch.randn((B, Kn, S, 3 + D), generator=gen, device=dev)[..., 3:]  # read in place
    a = K.sa_group_scatter(idx, dg, N)
    b = K.sa_group_scatter(idx, dg, N)
    ref = K.sa_group_scatter_plain(idx, dg, N)
    torch.cuda.synchronize()
    err = float((a - ref).abs().max())
    bit_equal = bool(torch.equal(a, b))
    ok = bool(torch.allclose(a, ref, rtol=SCATTER_TOL, atol=SCATTER_TOL))
    emit("kernel_check", kernel="sa_group_scatter", shape="sa2 B=16", max_abs_err=err,
         tol=SCATTER_TOL, ok=ok, two_launches_bit_equal=bit_equal)
    if not (ok and bit_equal and torch.isfinite(a).all()):
        fail(f"sa_group_scatter: max abs err {err} (tol {SCATTER_TOL}), bit-equal {bit_equal}")
    results["sa_group_scatter"]["sa2 B=16"] = {"max_abs_err": err}

    for name, (B, Kn, S, widths) in TRAIN_MLP_SHAPES.items():
        worst = worst_abs = 0.0
        for case in ("ties", "all-tied", "random"):
            if case == "random":
                g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
                layers = make_layers(widths, gen, dev)
                dp = torch.randn((B, S, widths[-1]), generator=gen, device=dev)
            else:
                g, layers, dp = dyadic_mlp_case(gen, dev, B, Kn, S, widths, case == "all-tied")
            got = K.sa_mlp_max_bwd(g, layers, dp)
            again = K.sa_mlp_max_bwd(g, layers, dp)
            want = K.sa_mlp_max_bwd_plain(g, layers, dp)
            torch.cuda.synchronize()
            fields = {}
            for (label, x), (_, y), (_, z) in zip(bwd_outputs(got), bwd_outputs(want),
                                                  bwd_outputs(again)):
                scale = max(float(y.abs().max()), 1e-30)
                diff = (x - y).abs()
                fields[label] = {
                    "max_abs_err": float(diff.max()), "scale": scale,
                    "norm_rel_err": float((x - y).norm() / y.norm().clamp_min(1e-30)),
                    "elementwise_ok": bool(torch.allclose(x, y, rtol=BWD_TOL, atol=BWD_TOL * scale)),
                    "finite": bool(torch.isfinite(x).all()), "bit_equal_twice": bool(torch.equal(x, z)),
                }
            ok = all(f["finite"] and f["bit_equal_twice"] for f in fields.values())
            if case == "random":
                ok = ok and all(f["norm_rel_err"] <= BWD_RANDOM_NORM_TOL for f in fields.values())
            else:
                ok = ok and all(f["elementwise_ok"] for f in fields.values())
            if case == "all-tied":
                ok = ok and not bool(got[0].any())
            rel_to_scale = max(f["max_abs_err"] / f["scale"] for f in fields.values())
            emit("kernel_check", kernel="sa_mlp_max_bwd", shape=name, case=case, ok=ok,
                 tol=BWD_TOL if case != "random" else BWD_RANDOM_NORM_TOL,
                 max_abs_err_over_scale=rel_to_scale,
                 max_norm_rel_err=max(f["norm_rel_err"] for f in fields.values()),
                 max_abs_err=max(f["max_abs_err"] for f in fields.values()),
                 finite=all(f["finite"] for f in fields.values()),
                 bit_equal_twice=all(f["bit_equal_twice"] for f in fields.values()))
            if not ok:
                fail(f"sa_mlp_max_bwd {name} {case}: {fields}")
            worst = max(worst, rel_to_scale)
            worst_abs = max([worst_abs] + [f["max_abs_err"] for f in fields.values()])
        results["sa_mlp_max_bwd"][name] = {"max_abs_err": worst_abs,
                                           "max_abs_err_over_scale": worst}
    return results


def train_dataset() -> OrientationDataset:
    return OrientationDataset(*synthetic_modelnet(num_points=TRAIN_N,
                                                  samples_per_class=TRAIN_SAMPLES_PER_CLASS))


def step_grads(trainer, batch, valid, seed) -> dict:
    model = trainer.model
    model.zero_grad(set_to_none=True)
    model.train()
    logits = model(batch["points"], torch.Generator(device=batch["points"].device).manual_seed(seed))
    per = trainer.adapter.loss(logits, batch, trainer.cfg)
    ((per * valid).sum() / valid.sum().clamp_min(1.0)).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _zero_in_exact_arithmetic(name: str) -> bool:
    """A Dense bias that feeds a train-mode BatchNorm: the batch mean
    removes it, so its gradient is rounding noise on both sides."""
    return name.endswith("bias") and ("linears" in name or name in ("trunk.fc1.bias",
                                                                    "trunk.fc2.bias"))


def phase_train(dev) -> dict:
    """The training main path: one epoch of the 8dir_kl preset (B=16,
    N=10,000, full width) in each train configuration, counters from 0."""
    ds = train_dataset()
    out = {}
    for mode in ("default", "fused"):
        fused = mode == "fused"
        trainer = Trainer(preset("8dir_kl", epochs=1), ds, device=dev, fused_mlp_train=fused)
        steps = -(-len(trainer.train_ds) // trainer.cfg.batch_size)
        val = -(-len(trainer.val_ds) // trainer.cfg.batch_size)
        K.reset_launch_counts()
        trainer.fit(epochs=1, log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expected = expected_launches(sa_group=2 * (steps + val),
                                     sa_mlp_max=3 * (steps + val) if fused else 3 * val,
                                     sa_group_scatter=steps,
                                     sa_mlp_max_bwd=3 * steps if fused else 0)
        losses = trainer.step_losses
        emit("train", mode=mode, train_steps=steps, val_batches=val, step_losses=losses,
             val_loss=trainer.history["val"][0], val_angular_deg=trainer.history["val_ang"][0],
             launches=launches, expected_launches=expected, timings=trainer.timings)
        if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
                and math.isfinite(trainer.history["val"][0])):
            fail(f"train {mode}: losses {losses}, val {trainer.history['val']}")
        if launches != expected:
            fail(f"train {mode}: launches {launches}, expected {expected}")

        # one step's gradients through the kernels vs through the plain versions
        state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        got = step_grads(trainer, batch, valid, SEED)
        trainer.model.load_state_dict(state)
        with mock.patch.object(K, "sa_group", K.sa_group_plain), \
                mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain), \
                mock.patch.object(K, "sa_group_scatter", K.sa_group_scatter_plain), \
                mock.patch.object(K, "sa_mlp_max_bwd", K.sa_mlp_max_bwd_plain):
            want = step_grads(trainer, batch, valid, SEED)
        trainer.model.load_state_dict(state)
        rel = {n: float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)) for n in want}
        checked = {n: r for n, r in rel.items() if not _zero_in_exact_arithmetic(n)}
        worst = max(checked, key=checked.get)
        finite = all(bool(torch.isfinite(g).all()) for g in got.values())
        ok = finite and checked[worst] <= GRAD_TOL[mode]
        emit("train_check", mode=mode, grads_vs_plain_worst=worst, norm_rel_err=checked[worst],
             tol=GRAD_TOL[mode], finite=finite, ok=ok,
             median_norm_rel_err=float(np.median(list(checked.values()))))
        if not ok:
            fail(f"train {mode}: gradient of {worst} differs by {checked[worst]} from the plain path")

        # checkpoint round trip, in a temporary directory outside the tree
        with tempfile.TemporaryDirectory() as d:
            path = trainer.save_checkpoint(d)
            other = Trainer(preset("8dir_kl", epochs=1), ds, device=dev, fused_mlp_train=fused)
            epoch = other.restore_checkpoint(path)
            same = all(torch.equal(a, b) for a, b in zip(other.model.state_dict().values(),
                                                         trainer.model.state_dict().values()))
            ok = same and epoch == 1 and other.history == trainer.history
            emit("checkpoint", mode=mode, epoch=epoch, state_equal=same, ok=ok)
            if not ok:
                fail(f"checkpoint round trip ({mode}): epoch {epoch}, state equal {same}")
        out[mode] = {"trainer": trainer, "launches": launches, "steps": steps}
    return out


def phase_timing_train(dev, checks: dict, train: dict) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    per_shape = {"sa_group_scatter": {}, "sa_mlp_max_bwd": {}}
    B, N, S, Kn, D = SCATTER_SHAPE
    xyz, feats, cidx = sa_group_inputs(SCATTER_SHAPE, gen, dev, tiled=False)
    idx = K.sa_group(xyz, feats, cidx, Kn)[2]
    dg = torch.randn((B, Kn, S, 3 + D), generator=gen, device=dev)[..., 3:]
    ms, host_ms = timed(lambda: K.sa_group_scatter(idx, dg, N))
    plain_ms = cuda_ms(lambda: K.sa_group_scatter_plain(idx, dg, N))
    # the library call: one index_add over flattened (cloud, row) indices
    flat = (idx.long() + torch.arange(B, device=dev)[:, None, None] * N).reshape(-1)
    vals = dg.permute(0, 2, 1, 3).reshape(-1, D).contiguous()
    zeros = torch.zeros((B * N, D), device=dev)
    library_ms = cuda_ms(lambda: zeros.index_add(0, flat, vals))
    b_ms, b_by = bound_ms(*scatter_cost(*SCATTER_SHAPE))
    per_shape["sa_group_scatter"]["sa2 B=16"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
        host_ms=host_ms, **checks["sa_group_scatter"]["sa2 B=16"])
    emit("timing", kernel="sa_group_scatter", shape="sa2 B=16",
         **per_shape["sa_group_scatter"]["sa2 B=16"])
    for name, (B, Kn, S, widths) in TRAIN_MLP_SHAPES.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        dp = torch.randn((B, S, widths[-1]), generator=gen, device=dev)
        ms, host_ms = timed(lambda: K.sa_mlp_max_bwd(g, layers, dp), iters=10)
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_bwd_plain(g, layers, dp), iters=10)
        b_ms, b_by = bound_ms(*mlp_bwd_cost(B, Kn, S, widths))
        per_shape["sa_mlp_max_bwd"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                                 bound_ms=b_ms, bound_by=b_by, host_ms=host_ms,
                                                 **checks["sa_mlp_max_bwd"][name])
        emit("timing", kernel="sa_mlp_max_bwd", shape=name, **per_shape["sa_mlp_max_bwd"][name])

    # a train step (forward, backward, Adam) on one batch, host clock, synchronised
    steps = {}
    for mode, run in train.items():
        trainer = run["trainer"]
        ds = trainer.train_ds
        idx, valid, _ = next(ds.batches(trainer.cfg.batch_size))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 98, 0))
        ts = []
        for i in range(2 + TRAIN_STEP_ITERS):
            step_gen = trainer.generator(0, 97, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_step(batch, valid, step_gen)["loss"]
            torch.cuda.synchronize()
            if i >= 2:
                ts.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(float(loss)):
                fail(f"timing_train {mode}: loss {float(loss)}")
        med = float(np.median(ts))
        steps[mode] = {"ms_median": med, "ms_all": ts,
                       "clouds_per_s": trainer.cfg.batch_size / med * 1e3,
                       "epoch_train_clouds_per_s": trainer.timings.get("train_clouds_per_sec")}
    emit("timing_train", batch=16, num_points=TRAIN_N, steps=steps)

    sources = {
        "sa_group_scatter": ("pointcloud_orientation_tpu_torch/csrc/sa_scatter.cu",
                             "pointcloud_orientation_tpu/ops/pallas_kernels.py:530",
                             "default", ("sa2 B=16",),
                             "one train step at B=16 N=10000 (either configuration): sa2"),
        "sa_mlp_max_bwd": ("pointcloud_orientation_tpu_torch/csrc/sa_mlp_max_bwd.cu",
                           "pointcloud_orientation_tpu/ops/pallas_kernels.py:762",
                           "fused", tuple(TRAIN_MLP_SHAPES),
                           "one fused train step at B=16 N=10000: sa1, sa2, sa3"),
    }
    summary = []
    for kname, (src, replaces, mode, shapes, per) in sources.items():
        rows = [per_shape[kname][s] for s in shapes]
        b_ms = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        lib = [r["library_ms"] for r in rows]
        summary.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train[mode]["launches"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": "bytes" if by_bytes * 2 >= b_ms else "operations",
            "library_ms": None if None in lib else sum(lib),
            "per": per, "launches_path": f"train {mode}, one epoch", "shapes": per_shape[kname],
        })
    return summary


def main() -> None:
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    checks = phase_kernels(dev)
    checks.update(phase_kernels_select(dev))
    checks.update(phase_kernels_bwd(dev))
    serve = phase_serve(dev)
    cls = phase_serve_cls(dev)
    large = phase_large(dev)
    train = phase_train(dev)
    summary = phase_timing(dev, checks, serve)
    summary += phase_timing_train(dev, checks, train)
    summary += phase_timing_select(dev, checks, cls, large)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": summary,
                      "total_seconds": round(time.perf_counter() - T_START, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
