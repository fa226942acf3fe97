"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_orientation_tpu_torch/csrc``
with nvcc and holds each kernel against its plain PyTorch version at the
shapes its path gives it (the f32 MLP kernels, forward and backward, 3xTF32
on the tensor cores, also against float64 beside the plain f32 version; the
backward's device kernels per fused train step; FPS on thread-block
clusters up to the N=40,000 request's shape). Then drives the main paths at full width, random
weights from a seed, each with the launch counters set to 0 just before and
read just after: serving through ``OrientationPredictor`` (PointNet++ 8-dir)
at N=1024 and N=10,000; serving the ModelNet40 classifier
(``pointnet_pp_cls``, FPS and ball query, 6-channel clouds) at N=1024 and
N=40,000; 8-dir serving at N=16,384 (the kNN kernel) and N=24,576 (no kernel
for the kNN) and one 8dir_kl train step at N=16,384; and training of the
8dir_kl preset (B=16, N=10,000) through ``Trainer`` in both train
configurations (the default, and ``fused_mlp_train``), with a gradient check
against the plain versions and a checkpoint round trip. The bfloat16 trunk
(``dtype="bfloat16"``, ``compute_dtype="bfloat16"``) is driven the same way:
8-dir serving at N=1024 and N=10,000 through the bf16 ``sa_mlp_max`` kernel,
and one epoch of the 8dir_kl preset in both train configurations (the fused
one through the bf16 backward kernel). The grid-pruned kNN
(``set_knn_impl("grid")``, the JAX package's ``PCOT_KNN=grid``): its
``topk_min`` kernel against its plain version, an 8-dir and a vM request at
B=16, N=10,000 under the grid and the exact dispatch (sa1's neighbour sets
against the kNN kernel's), and a cloud that fails the certificate. The
yaw-distribution heads (``pointnet_pp_fwd``, ``pointnet_pp_von_mises``,
``pointnet_pp_mvm``) served at B=16, N=10,000 against their plain versions,
and one epoch each of the multi_8dir, vm_kl, mvm_robust and mvm_debug
presets, vm_kl and mvm_robust again under the grid dispatch. The ModelNet40
classifier trained through ``Trainer`` (``TrainConfig(task="classification",
model="pointnet_pp_cls")``, B=16, N=1024) one epoch in both train
configurations, with its launch counts and a step's gradients against the
plain versions, and its step timed. The SO(3) heads (``pointnet_pp``,
``pointnet_pp_xyz``, ``pointnet_pp_xyz_schmidt``) served at B=64 N=1024 in
f32 and bf16 and, with FPS and the ball query, at B=16 N=10,000, each
request against the plain versions with every index call bit for bit; the
``pointnet_pp_forward`` preset trained one epoch in both configurations,
``axes_all_labels`` through ``run_per_label`` over two labels and resumed,
and a FPS/ball train step, every step's gradients held under
``utils/grad_check.py``'s rule (the group-all shift by an absolute bound
where a forward hook saw every pooled value > 0); and their latency and
step time in turns beside the 8-dir paths. Finally times
the kernels, the requests and the train steps, f32 beside bf16 and exact
beside grid, with CUDA events, the profiler and the host clock. Besides: the
MLP forward against its backward's recompute (the pooled value reproduced
bit for bit, f32 and bf16, every stage's widths); the five selection
micro-benchmark kernels (``benchmarks/profile_vpu_select.py``) bit for bit
against their plain versions (``ew`` also on NaN, infinities, subnormals
and tails), then their benchmark as its own main path. Real data
(``real_data``): a PLY tree of 48 clouds of 10,000 points written, rotated
and given its ground-truth sidecars by ``data/offline.py``, read back
through the native parser (built from ``native/fastply.cc``) beside the
NumPy one; the 8dir_kl preset trained one epoch on its stored targets
(``rotation_mode="none"``) through ``train.run.run_single`` in both train
configurations, with exact launches, the targets in the batch, a step's
gradients, the prediction PLYs, the step beside the synthetic one in
turns; the weights written as a reference ``.pth`` and served and
evaluated from it; mvm one epoch (``results.txt``) and the classifier one
epoch from the canonical tree as ``ply:``. The rest of serving
(``serve_tta``): yaw-voting TTA for every head family at B=64 N=1,024
(8-dir at V=8 in f32 and bf16, 512 views through the grouping and MLP
kernels; the forward, two-axis, vM and MvM heads at V=4; the flash
transformer at V=2), each request one model call's launches, against the
plain versions and against its own combine of V single-view requests;
int8 serving (``serve_int8``) of 8-dir from an ``.npz`` this run writes,
against the plain versions, within the JAX package's envelope of the f32
predictor, with its weight bytes on the card. The PointNet backbones
(``pointnet``, cuBLAS only): ``pointnet_cls`` and ``pointnet`` served and
the ``simple_pointnet`` preset and ``pointnet_cls`` classification trained
against the port on the CPU; then all of these timed (``timing_serving``).
The Trainer's other paths and the protocols (``protocols``, 8dir_kl at
B=16 N=1,024): the cosine schedule with warmup under Adam and SGD (each
step's learning rate the schedule's), a run preempted by a
``PreemptionGuard`` after epoch 2 and resumed from its asynchronous
checkpoint bit-equal to an uninterrupted one, the per-label protocol over
two labels of unequal size and three seeds preempted and resumed, in
lockstep, each member bit-equal to its own sequential run, 3-member
ensembles (8-dir from that protocol checkpoint, vM and MvM from random
weights) at B=64 equal to the host's combine of their single members and
S times a single request's launches, and the point transformer's flash
step accumulated over 4 microbatches against the whole batch's gradient;
then timed (``timing_protocols``: ensemble requests at S=1 and 3, a
member's epoch in lockstep against a sequential one, a synchronous
checkpoint's stall against an asynchronous one's).
Prints one
flushed JSON line per phase, each with a ``"phase"`` key; any failure raises
and exits non-zero. The line before the last is the per-kernel summary with
the run's total seconds, and the last line is ``{"ok": true, "device": ...}``.

Imports only the port, torch, numpy and the standard library. Exits
non-zero before building anything when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np
import torch

from pointcloud_orientation_tpu_torch import OrientationPredictor, infer, random_flax_variables
from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
from pointcloud_orientation_tpu_torch.benchmarks.roofline import bound_ms, timed
from pointcloud_orientation_tpu_torch.benchmarks.roofline import device_ms as cuda_ms
from pointcloud_orientation_tpu_torch.data import OrientationDataset, synthetic_modelnet
from pointcloud_orientation_tpu_torch.data import fastply, offline
from pointcloud_orientation_tpu_torch.data.ply import read_ply, read_ply_numpy, write_ply
from pointcloud_orientation_tpu_torch.models import layers as LAYERS
from pointcloud_orientation_tpu_torch.ops import _build, cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
from pointcloud_orientation_tpu_torch.ops import geometry as G
from pointcloud_orientation_tpu_torch.ops import von_mises as TVM
from pointcloud_orientation_tpu_torch.ops.geometry import random_sample_indices
from pointcloud_orientation_tpu_torch.ops.rotations import random_so3_matrix, rotate_points
from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig, preset
from pointcloud_orientation_tpu_torch.train import evaluate as EV
from pointcloud_orientation_tpu_torch.train import trainer as TR
from pointcloud_orientation_tpu_torch.train.accum import make_accum_train_step
from pointcloud_orientation_tpu_torch.train.metrics import have_matplotlib
from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed
from pointcloud_orientation_tpu_torch.train.reliability import PreemptionGuard
from pointcloud_orientation_tpu_torch.train.run import load_dataset, run_per_label, run_single
from pointcloud_orientation_tpu_torch.train.profile_step import device_events, profile_mode
from pointcloud_orientation_tpu_torch.utils import grad_check as GC
from pointcloud_orientation_tpu_torch.utils import save_torch_checkpoint, to_flax_variables
from pointcloud_orientation_tpu_torch.utils.quantize import save_quantized_checkpoint

# The card's peaks and the bound formula (roofline.bound_ms): a bf16
# kernel's products at the bf16 tensor-core rate; the products of an f32 MLP
# kernel (forward and backward) at the least time the card takes for
# f32-grade products, three TF32 products each (3xTF32); the rest at the f32
# rate.
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
    # the classifier's three stages at B=64 N=1024 (6-channel clouds); the
    # group-all stage's 128 rows run in two chunks
    "cls sa1 B=64": (64, 32, 512, (6, 64, 64, 128)),
    "cls sa2 B=64": (64, 64, 128, (131, 128, 128, 256)),
    "cls group-all K=128 B=64": (64, 128, 1, (259, 256, 512, 1024)),
    # the classifier's training path: B=16 N=1024 xyz clouds (eval's forward
    # and the fused train step's)
    "cls train sa1 B=16": (16, 32, 512, (3, 64, 64, 128)),
    "cls train sa2 B=16": (16, 64, 128, (131, 128, 128, 256)),
    "cls train group-all K=128 B=16": (16, 128, 1, (259, 256, 512, 1024)),
}
# one forward at the bench shape launches these (summed in the last line)
BENCH_FORWARD = {"sa_group": ("sa1 B=64 N=1024", "sa2 B=64"),
                 "sa_mlp_max": ("sa1 B=64", "sa2 B=64", "sa3 B=64")}
MLP_TOL = 1e-4  # rtol and atol: the kernel sums in another order than cuBLAS
F64_REL_FLOOR = 1e-3  # outputs held to a relative error against float64, of the largest
LOGIT_TOL = 1e-4
SERVE_KERNELS = ("sa_group", "sa_mlp_max")
# bf16 variants of the MLP kernels, at the 8-dir serving shapes and the K=128
# group-all (forward) and the training shapes (backward). On dyadic inputs
# (``dyadic_mlp_case``: every sum exact in any order, so both round the same
# values to bf16) within BF16_TOL of the output's scale; on normal random
# inputs a sum in another order puts a few activations on the other side of a
# bf16 rounding midpoint, so those are held in norm
BF16_MLP_SHAPES = ("sa1 B=64", "sa2 B=64", "sa3 B=64", "cls group-all K=128 B=64")
BF16_TOL = 1e-4
BF16_RANDOM_NORM_TOL = 1e-3
# bf16 logits through the kernels vs the plain versions (rounding flips, as
# above), and vs the f32 model (the bound of tests/test_bf16.py). A smoke
# check only: the bf16 logits lie 3.3e-3 to 4.5e-3 from the f32 ones, inside
# BF16_LOGIT_TOL, so it cannot tell the bf16 path from the f32 one; the
# kernel checks on random inputs (BF16_RANDOM_NORM_TOL) and the train-step
# checks below can
BF16_LOGIT_TOL = 1e-2
BF16_VS_F32_TOL = 0.05
# A bf16 train step's gradients. Default configuration: through the kernels
# against autograd through the plain grouping, the same forward (the
# grouping kernel is bit-equal to it), whole gradient relative in norm.
# Fused: each call of the bf16 MLP backward kernel in the step against the
# bf16 plain version on the same inputs, all outputs relative in norm; the
# f32 plain version (f32 recompute, other max decisions) must lie further
# than the bound from the kernel's result (its f32 max decisions move a
# whole fused step's gradient 0.21-0.30 on the CPU, tests/test_torch_bf16.py)
BF16_GRAD_TOL = {"default": 1e-3, "fused": 1e-2}

# The index kernels' shapes. FPS: (B, N, npoint), the classifier's two stages
# at B=64 N=1024 and a 10,000-point cloud. Ball query: (B, S, N, K, radius),
# the classifier's two stages. kNN: (B, S, N, K), the 8-dir sa1 above the
# fused grouping's 10,240 points, up to the kernel's 20,480.
# FPS: one block a cloud at the classifier's N <= 1024, a cloud over a
# thread-block cluster from about 10,000 points (B=2 N=40,000: the N=40,000
# classifier request's sa1).
# Ball query: the matmul form (last entry) where the JAX package's TPU
# dispatch takes it (N=512 at the classifier's sa2, N above 20,480), and the
# difference form at sa2 too, for its time beside the matmul form's; B=2
# N=40,000 is the N=40,000 classifier request's sa1.
FPS_SHAPES = {"sa1 B=64 N=1024": (64, 1024, 512), "sa2 B=64 N=512": (64, 512, 128),
              "B=16 N=10000": (16, 10000, 512), "B=2 N=40000": (2, 40_000, 512),
              "B=4 N=40000": (4, 40_000, 512), "B=4 N=65536": (4, 65_536, 512),
              "cls train sa1 B=16 N=1024": (16, 1024, 512),
              "cls train sa2 B=16 N=512": (16, 512, 128),
              "so3 sa1 B=16 N=10000": (16, 10_000, 128), "so3 sa2 B=16 N=128": (16, 128, 32)}
BALL_SHAPES = {"sa1 B=64": (64, 512, 1024, 32, 0.2, False),
               "sa2 B=64": (64, 128, 512, 64, 0.4, True),
               "sa2 B=64 difference form": (64, 128, 512, 64, 0.4, False),
               "B=4 N=24576": (4, 128, 24_576, 32, 0.2, True),
               "B=2 N=40000": (2, 512, 40_000, 32, 0.2, True),
               "cls train sa1 B=16": (16, 512, 1024, 32, 0.2, False),
               "cls train sa2 B=16": (16, 128, 512, 64, 0.4, True),
               # the trunk heads' FPS/ball modes at B=16 N=10,000: radius 0.2 at
               # both stages, sa2 over 128 points in the matmul form
               "so3 sa1 B=16": (16, 128, 10_000, 32, 0.2, False),
               "so3 sa2 B=16": (16, 32, 128, 32, 0.2, True)}
KNN_SHAPES = {"sa1 B=16 N=16384": (16, 128, 16384, 32), "sa1 B=16 N=20480": (16, 128, 20480, 32)}
CLS_FORWARD = {"fps": ("sa1 B=64 N=1024", "sa2 B=64 N=512"), "ball_query": ("sa1 B=64", "sa2 B=64")}
CLS_CHANNELS = 6  # xyz and normals
CLS_LARGE_N = 40_000  # a classifier request above the FPS kernel's register limit
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
# The classifier's training path (B=16, N=1024 xyz clouds): the backward at
# sa1 (K=32, S=512), sa2 (K=64, S=128) and the group-all stage (K=128 rows,
# S=1: 16 groups), the last also at B=64 (the kernel's scratch, row chunks
# and grid limits)
CLS_TRAIN_MLP_SHAPES = {
    "cls sa1 B=16": (16, 32, 512, (3, 64, 64, 128)),
    "cls sa2 B=16": (16, 64, 128, (131, 128, 128, 256)),
    "cls group-all K=128 B=16": (16, 128, 1, (259, 256, 512, 1024)),
    "cls group-all K=128 B=64": (64, 128, 1, (259, 256, 512, 1024)),
}
CLS_TRAIN_N = 1024
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
# train steps timed f32 beside bf16, (N, B): the preset's and bench.py's shape
TIMED_TRAIN_SHAPES = ((TRAIN_N, 16), (1024, 64))

T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sa_group_cost(B, N, S, Kn, D) -> tuple[float, float]:
    """Bytes (each input read once, each output written once) and f32
    operations: 8 per centroid-point distance, 5 per squared norm, 3 per
    centred neighbour."""
    nbytes = 4 * (B * N * 3 + B * N * D + B * S) + 4 * (B * S * 3 + B * Kn * S * (3 + D) + B * S * Kn)
    flops = 8 * B * S * N + 5 * B * N + 5 * B * S + 3 * B * Kn * S
    return nbytes, flops


def sa_mlp_cost(B, Kn, S, widths) -> tuple[float, float, float]:
    """Bytes (grouped, the layers and the output once, all f32), the
    elementwise operations (3 per activation: scale, shift, ReLU; and the
    max) and the products' operations, apart."""
    rows = B * Kn * S
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 4 * (rows * widths[0] + sum(ci * co + 2 * co for ci, co in pairs) + B * S * widths[-1])
    products = sum(2 * rows * ci * co for ci, co in pairs)
    rest = sum(3 * rows * co for ci, co in pairs) + rows * widths[-1]
    return nbytes, rest, products


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


def ball_scanned(new_xyz, xyz, radius, Kn, matmul_form=False) -> int:
    """The points the ball query of these inputs must test: for each
    centroid up to its Kn-th point within ``radius``, else all N."""
    distance = G.square_distance if matmul_form else G.diff_square_distance
    hits = (distance(new_xyz, xyz) <= K.radius_sq_f32(radius)).int().cumsum(-1)
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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds finite values."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mlp_max_3xtf32(grouped, layers):
    """The f32 MLP kernel's split in plain PyTorch: every product as
    lo*hi + hi*lo + hi*hi of TF32 halves (hi = rna(x), lo = rna(x - hi)),
    each product exact in f32 and summed by an f32 GEMM (cuBLAS with TF32
    off, PyTorch's default), so its error against float64 is the split's
    alone, without the tensor cores' accumulation (the copy in
    tests/test_torch_kernels.py holds it to the Pallas kernel on the CPU)."""
    B, Kn, S, C = grouped.shape
    x = grouped.reshape(-1, C)
    for w, s, t in layers:
        xh, wh = tf32_rna(x), tf32_rna(w)
        z = (tf32_rna(x - xh) @ wh + xh @ tf32_rna(w - wh)) + xh @ wh
        x = torch.relu(z * s + t)
    return x.reshape(B, Kn, S, -1).amax(dim=1)


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
        # the kernel (3xTF32), the plain f32 version and the kernel's split
        # emulated with f32 GEMMs, each against the same function in
        # float64: the largest error relative to the output's largest entry,
        # and relative per output over the outputs of at least F64_REL_FLOOR
        # of it (a pooled output near 0 has no meaningful relative error)
        ref64 = K.sa_mlp_max_plain(g.double(), [tuple(x.double() for x in layer)
                                                for layer in layers])
        scale64 = float(ref64.abs().max())
        big = ref64.abs() >= F64_REL_FLOOR * scale64
        vs_f64 = {}
        for label, x in (("kernel", got), ("plain_f32", ref),
                         ("emulated_3xtf32", mlp_max_3xtf32(g, layers))):
            e64 = (x.double() - ref64).abs()
            vs_f64[label] = {"max_abs_err_over_scale": float(e64.max()) / scale64,
                             "max_rel_err": float((e64[big] / ref64.abs()[big]).max())}
        emit("kernel_check", kernel="sa_mlp_max", shape=name, max_abs_err=max_abs,
             max_rel_err=max_rel, tol=MLP_TOL, ok=ok, vs_f64=vs_f64)
        if not ok or not torch.isfinite(got).all():
            fail(f"sa_mlp_max {name}: max abs err {max_abs} beyond rtol=atol={MLP_TOL}")
        results["sa_mlp_max"][name] = {"max_abs_err": max_abs, "vs_f64": vs_f64}
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
        B, S, N, Kn, radius, matmul_form = shape
        xyz = unit_cloud(B, N, gen, dev, case == "tiled")
        cidx = random_sample_indices(gen, B, N, S, dev)
        new_xyz = G.index_points(xyz, cidx).contiguous()
        if case == "empty":
            new_xyz[:, 0] = 3.0
        return new_xyz, xyz, radius, Kn, matmul_form
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
        nbytes, rest, products = sa_mlp_cost(B, Kn, S, widths)
        b_ms, b_by = bound_ms(nbytes, rest, f32_products=products)
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


def device_kernels(fn) -> int:
    """How many kernels (with copies and fills) one call of ``fn`` runs on
    the card, from the profiler's device events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_events(prof))


def bwd_device_kernels(g, layers, dp, name, bf16=False) -> int:
    """Device kernels of one backward call as a fused train step makes it:
    sa1's grouped input (coordinates) needs no gradient."""
    return device_kernels(lambda: K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16,
                                                   need_dgrouped="sa1" not in name))


def scatter_cost(B, N, S, Kn, D) -> tuple[float, float]:
    """Bytes: the cotangents and indices read once, the rows written once;
    operations: one add per cotangent."""
    return 4 * (B * Kn * S * D + B * S * Kn + B * N * D), B * S * Kn * D


def mlp_bwd_cost(B, Kn, S, widths) -> tuple[float, float, float]:
    """Bytes: grouped, the layers and dpooled read once; dgrouped and the
    summed dW, dscale, dshift written once. Operations, apart: ~12
    elementwise per activation (affine, relu, max/tie split, mask,
    dscale/dshift sums), and the recompute, dW and da products (6 * rows *
    sum Cin*Cout)."""
    rows = B * Kn * S
    pairs = list(zip(widths[:-1], widths[1:]))
    params = sum(ci * co + 2 * co for ci, co in pairs)
    nbytes = 4 * (rows * widths[0] + params + B * S * widths[-1]) + 4 * (rows * widths[0] + params)
    rest = sum(12 * rows * co for ci, co in pairs)
    products = sum(6 * rows * ci * co for ci, co in pairs)
    return nbytes, rest, products


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


def vs_f64(got, plain, g, layers, dp) -> dict:
    """The f32 backward kernel (3xTF32) and the plain f32 version, each
    against the plain version in float64 on the same inputs: the largest
    error over each output's scale, and the error in norm, worst over the
    outputs."""
    ref = K.sa_mlp_max_bwd_plain(g.double(), [tuple(x.double() for x in layer)
                                              for layer in layers], dp.double())
    out = {}
    for label, res in (("kernel", got), ("plain_f32", plain)):
        scale_err = norm_err = 0.0
        for (_, x), (_, y) in zip(bwd_outputs(res), bwd_outputs(ref)):
            scale_err = max(scale_err, float((x.double() - y).abs().max())
                            / max(float(y.abs().max()), 1e-300))
            norm_err = max(norm_err, float((x.double() - y).norm() / y.norm().clamp_min(1e-300)))
        out[label] = {"max_abs_err_over_scale": scale_err, "max_norm_rel_err": norm_err}
    return out


def check_mlp_bwd(gen, dev, name, shape, cases, bf16=False) -> dict:
    """``sa_mlp_max_bwd`` against its plain version at ``shape``: on dyadic
    inputs (``ties``, ``all-tied``) every output within BWD_TOL of its
    scale, on normal random inputs within BWD_RANDOM_NORM_TOL in norm; two
    launches bit-equal; finite. On random inputs the f32 kernel's error
    against float64 is printed beside the plain f32 version's."""
    B, Kn, S, widths = shape
    kernel = "sa_mlp_max_bwd_bf16" if bf16 else "sa_mlp_max_bwd"
    worst = worst_abs = 0.0
    out = {}
    for case in cases:
        if case == "random":
            g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
            layers = make_layers(widths, gen, dev)
            dp = torch.randn((B, S, widths[-1]), generator=gen, device=dev)
        else:
            g, layers, dp = dyadic_mlp_case(gen, dev, B, Kn, S, widths, case == "all-tied")
        got = K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16)
        again = K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16)
        want = K.sa_mlp_max_bwd_plain(g, layers, dp, bf16=bf16)
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
        extra = {"vs_f64": vs_f64(got, want, g, layers, dp)} if case == "random" and not bf16 else {}
        emit("kernel_check", kernel=kernel, shape=name, case=case, ok=ok, **extra,
             tol=BWD_TOL if case != "random" else BWD_RANDOM_NORM_TOL,
             max_abs_err_over_scale=rel_to_scale,
             max_norm_rel_err=max(f["norm_rel_err"] for f in fields.values()),
             max_abs_err=max(f["max_abs_err"] for f in fields.values()),
             finite=all(f["finite"] for f in fields.values()),
             bit_equal_twice=all(f["bit_equal_twice"] for f in fields.values()))
        if not ok:
            fail(f"{kernel} {name} {case}: {fields}")
        worst = max(worst, rel_to_scale)
        worst_abs = max([worst_abs] + [f["max_abs_err"] for f in fields.values()])
        out.update(extra)
    return {"max_abs_err": worst_abs, "max_abs_err_over_scale": worst, **out}


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

    for name, shape in {**TRAIN_MLP_SHAPES, **CLS_TRAIN_MLP_SHAPES}.items():
        results["sa_mlp_max_bwd"][name] = check_mlp_bwd(gen, dev, name, shape,
                                                        ("ties", "all-tied", "random"))
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


def grads_vs_plain(trainer, batch, valid, mode: str, plain: dict, tol: float = None) -> dict:
    """One step's gradients through the kernels against the same step with
    each kernel wrapper of ``plain`` replaced by its plain version (same
    generator: the same FPS starts and dropout masks), per parameter,
    relative in norm, under ``utils/grad_check.py``'s rule: the Dense biases
    that a train BatchNorm normalises (zero in exact arithmetic) left out;
    the group-all shift held by ``GRAD_TOL`` times its scale leaf's
    gradient norm where every pooled value of both steps is > 0 (read by a
    forward hook on the group-all stage), else relative like the rest. The
    model's state is restored after each. Each attention's key bias (zero
    in exact arithmetic) is left out too; ``tol`` overrides ``GRAD_TOL``."""
    model = trainer.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with GC.record_group_all(model) as pooled:
        got = step_grads(trainer, batch, valid, SEED)
        model.load_state_dict(state)
        with mock.patch.multiple(K, **plain):
            want = step_grads(trainer, batch, valid, SEED)
    model.load_state_dict(state)
    return GC.compare_grads(got, want, tol or GRAD_TOL[mode], GC.zero_gradient_leaves(model),
                            GC.group_all_shift_leaves(model), GC.pooled_all_positive(pooled))


TRAIN_PLAIN = {"sa_group": K.sa_group_plain, "sa_mlp_max": K.sa_mlp_max_plain,
               "sa_group_scatter": K.sa_group_scatter_plain,
               "sa_mlp_max_bwd": K.sa_mlp_max_bwd_plain}


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
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        check = grads_vs_plain(trainer, batch, valid, mode, TRAIN_PLAIN)
        emit("train_check", mode=mode, grads_vs_plain_worst=check["worst"],
             **{k: v for k, v in check.items() if k != "worst"})
        if not check["ok"]:
            fail(f"train {mode}: gradient of {check['worst']} differs by "
                 f"{check['norm_rel_err']} from the plain path")

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


def step_times(trainer, what: str) -> dict:
    """A train step (forward, backward, Adam) on one batch, host clock
    around a synchronised step: median of TRAIN_STEP_ITERS after 2
    warm-ups."""
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
            fail(f"{what}: loss {float(loss)}")
    med = float(np.median(ts))
    return {"ms_median": med, "ms_all": ts, "clouds_per_s": trainer.cfg.batch_size / med * 1e3,
            "epoch_train_clouds_per_s": trainer.timings.get("train_clouds_per_sec")}


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
    for name, (B, Kn, S, widths) in {**TRAIN_MLP_SHAPES, **CLS_TRAIN_MLP_SHAPES}.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        dp = torch.randn((B, S, widths[-1]), generator=gen, device=dev)
        ms, host_ms = timed(lambda: K.sa_mlp_max_bwd(g, layers, dp), iters=10)
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_bwd_plain(g, layers, dp), iters=10)
        nbytes, rest, products = mlp_bwd_cost(B, Kn, S, widths)
        b_ms, b_by = bound_ms(nbytes, rest, f32_products=products)
        per_shape["sa_mlp_max_bwd"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                                 bound_ms=b_ms, bound_by=b_by, host_ms=host_ms,
                                                 device_kernels=bwd_device_kernels(g, layers, dp,
                                                                                   name),
                                                 **checks["sa_mlp_max_bwd"][name])
        emit("timing", kernel="sa_mlp_max_bwd", shape=name, **per_shape["sa_mlp_max_bwd"][name])

    steps = {mode: step_times(run["trainer"], f"timing_train {mode}")
             for mode, run in train.items()}
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
            **({"device_kernels_per_fused_step": sum(r["device_kernels"] for r in rows)}
               if kname == "sa_mlp_max_bwd" else {}),
        })
    return summary


# ---------------------------------------------------------------------------
# the bfloat16 trunk
# ---------------------------------------------------------------------------


def phase_kernels_bf16(dev) -> dict:
    """The bf16 variants of the MLP kernels against their plain versions:
    the forward at the 8-dir serving shapes and the K=128 group-all, the
    backward at the training shapes (dyadic inputs, as the f32 backward)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    results = {"sa_mlp_max_bf16": {}, "sa_mlp_max_bwd_bf16": {}}
    for name in BF16_MLP_SHAPES:
        B, Kn, S, widths = SA_MLP_SHAPES[name]
        row = {}
        for case in ("dyadic", "random"):
            if case == "dyadic":
                g, layers, _ = dyadic_mlp_case(gen, dev, B, Kn, S, widths)
            else:
                g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
                layers = make_layers(widths, gen, dev)
            got = K.sa_mlp_max(g, layers, bf16=True)
            ref = K.sa_mlp_max_plain(g, layers, bf16=True)
            f32 = K.sa_mlp_max_plain(g, layers)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != torch.float32:
                fail(f"sa_mlp_max bf16 {name}: {tuple(got.shape)} {got.dtype}")
            scale = max(float(ref.abs().max()), 1e-30)
            err = float((got - ref).abs().max())
            norm_rel = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
            vs_f32 = float((ref - f32).norm() / f32.norm().clamp_min(1e-30))
            if case == "dyadic":
                ok, tol = err <= BF16_TOL * scale, BF16_TOL
            else:
                ok, tol = norm_rel <= BF16_RANDOM_NORM_TOL, BF16_RANDOM_NORM_TOL
            ok = ok and bool(torch.isfinite(got).all())
            emit("kernel_check", kernel="sa_mlp_max_bf16", shape=name, case=case,
                 max_abs_err=err, max_abs_err_over_scale=err / scale, norm_rel_err=norm_rel,
                 plain_bf16_vs_plain_f32_norm_rel=vs_f32, tol=tol, ok=ok)
            if not ok:
                fail(f"sa_mlp_max bf16 {name} {case}: max abs err {err} (scale {scale}), "
                     f"norm rel {norm_rel}")
            row[case] = {"max_abs_err": err, "max_abs_err_over_scale": err / scale,
                         "norm_rel_err": norm_rel}
        results["sa_mlp_max_bf16"][name] = {
            "max_abs_err": max(r["max_abs_err"] for r in row.values()), "cases": row}
    for name, shape in TRAIN_MLP_SHAPES.items():
        results["sa_mlp_max_bwd_bf16"][name] = check_mlp_bwd(gen, dev, name, shape,
                                                             ("ties", "all-tied"), bf16=True)
    return results


def phase_serve_bf16(dev) -> dict:
    """The bf16 serving main path: ``OrientationPredictor("pointnet_pp_8dir",
    dtype="bfloat16")`` at N=1024 (B = 1, 13, 64, 100, max_batch 64) and at
    N=10,000 (B=16); per chunk 2 ``sa_group`` and 3 bf16 ``sa_mlp_max``
    launches, no f32 ``sa_mlp_max``. Then the same centroids through the f32
    predictor and through the plain versions."""
    v = random_flax_variables(SEED)
    rng = np.random.default_rng(SEED + 11)
    requests = [(1024, 64, b) for b in (1, 13, 64, 100)] + [(10000, 16, 16)]
    shapes = {(1024, 64), (10000, 16)}
    kw = {n: dict(num_points=n, max_batch=mb, seed=SEED, device=dev) for n, mb in shapes}
    predictors = {n: OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                          dtype="bfloat16", **kw[n]) for n, _ in shapes}
    f32 = {n: OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw[n])
           for n, _ in shapes}
    clouds = {(n, b): rng.normal(size=(b, n, 3)).astype(np.float32) for n, _, b in requests}

    K.reset_launch_counts()
    per_request = []
    for n, mb, b in requests:
        before = K.launch_counts()
        out = predictors[n](clouds[(n, b)])
        after = K.launch_counts()
        chunks = -(-b // mb)
        grown = {k: after[k] - before[k] for k in after}
        if out.shape != (b, 8) or out.dtype != np.float32 or not np.isfinite(out).all():
            fail(f"bf16 request N={n} B={b}: output {out.shape} {out.dtype}")
        if grown != expected_launches(sa_group=2 * chunks, sa_mlp_max_bf16=3 * chunks):
            fail(f"bf16 request N={n} B={b} ({chunks} chunks): launches grew by {grown}")
        per_request.append({"N": n, "B": b, "chunks": chunks, "launches": grown})
    launches = K.launch_counts()
    emit("serve_bf16", requests=per_request, launches=launches)

    checks = []
    for n, b in ((1024, 64), (10000, 16)):
        x = clouds[(n, b)]
        predictors[n].generator.manual_seed(SEED)
        got = predictors[n](x)
        f32[n].generator.manual_seed(SEED)
        ref = f32[n](x)
        predictors[n].generator.manual_seed(SEED)
        with mock.patch.object(K, "sa_group", K.sa_group_plain), \
                mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
            plain = predictors[n](x)
        vs_plain = float(np.abs(got - plain).max())
        vs_f32 = float(np.abs(got - ref).max())
        ok = vs_plain <= BF16_LOGIT_TOL and vs_f32 <= BF16_VS_F32_TOL
        checks.append({"N": n, "B": b, "max_abs_err_vs_plain": vs_plain,
                       "max_abs_diff_vs_f32": vs_f32, "ok": ok})
        if not ok:
            fail(f"bf16 logits N={n} B={b}: {vs_plain} from the plain versions (tol "
                 f"{BF16_LOGIT_TOL}), {vs_f32} from f32 (tol {BF16_VS_F32_TOL})")
    emit("serve_bf16_check", logits=checks, tol_vs_plain=BF16_LOGIT_TOL,
         tol_vs_f32=BF16_VS_F32_TOL)
    return {"launches": launches, "predictors": predictors, "f32": f32,
            "max_abs_err": max(c["max_abs_err_vs_plain"] for c in checks)}


def phase_train_bf16(dev) -> dict:
    """The bf16 training main path: one epoch of the 8dir_kl preset with
    ``compute_dtype="bfloat16"`` (B=16, N=10,000) in each train
    configuration, counters from 0; the fused one runs the bf16 backward
    kernel. Parameters and Adam's state stay f32. One more step's gradients
    are checked (``BF16_GRAD_TOL``): not against the plain versions' whole
    step, because in bf16 a few rounding flips reroute a step's gradient as
    much as bf16 itself does (tests/test_torch_bf16.py), but with the same
    forward on both sides."""
    ds = train_dataset()
    out = {}
    for mode in ("default", "fused"):
        fused = mode == "fused"
        trainer = Trainer(preset("8dir_kl", epochs=1, compute_dtype="bfloat16"), ds, device=dev,
                          fused_mlp_train=fused)
        steps = -(-len(trainer.train_ds) // trainer.cfg.batch_size)
        val = -(-len(trainer.val_ds) // trainer.cfg.batch_size)
        K.reset_launch_counts()
        trainer.fit(epochs=1, log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expected = expected_launches(sa_group=2 * (steps + val),
                                     sa_mlp_max_bf16=3 * (steps + val) if fused else 3 * val,
                                     sa_group_scatter=steps,
                                     sa_mlp_max_bwd_bf16=3 * steps if fused else 0)
        losses = trainer.step_losses
        f32_state = all(p.dtype == torch.float32 for p in trainer.model.parameters()) and all(
            t.dtype == torch.float32 for st in trainer.optimizer.state.values()
            for t in st.values() if t.dim())
        emit("train_bf16", mode=mode, train_steps=steps, val_batches=val, step_losses=losses,
             val_loss=trainer.history["val"][0], launches=launches, expected_launches=expected,
             params_and_adam_f32=f32_state, timings=trainer.timings)
        if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
                and math.isfinite(trainer.history["val"][0])):
            fail(f"train bf16 {mode}: losses {losses}, val {trainer.history['val']}")
        if launches != expected or not f32_state:
            fail(f"train bf16 {mode}: launches {launches}, expected {expected}, "
                 f"f32 state {f32_state}")

        state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        check = (bf16_bwd_calls(trainer, batch, valid) if fused
                 else bf16_grads_vs_autograd(trainer, batch, valid))
        trainer.model.load_state_dict(state)
        emit("train_bf16_check", mode=mode, tol=BF16_GRAD_TOL[mode], **check)
        if not check["ok"]:
            fail(f"train bf16 {mode}: gradient check {check}")
        out[mode] = {"trainer": trainer, "launches": launches, "steps": steps}
    return out


def _norm_rel(got, want) -> float:
    a = torch.cat([x.reshape(-1) for x in got])
    b = torch.cat([x.reshape(-1) for x in want])
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bf16_grads_vs_autograd(trainer, batch, valid) -> dict:
    """The default bf16 step's gradients through the kernels against the
    same step with the grouping's explicit backward (the scatter kernel and
    the cast of its result to bf16) replaced by autograd through the plain
    grouping: the whole gradient, but the Dense biases that a train
    BatchNorm normalises (``grad_check``; zero in exact arithmetic),
    relative in norm."""
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got = step_grads(trainer, batch, valid, SEED)
    trainer.model.load_state_dict(state)

    def group(xyz, feats, cidx, nsample):
        return K.sa_group_plain(xyz, feats.to(xyz.dtype), cidx, nsample)

    with mock.patch.object(K.SAGroupFeatsFn, "apply", group):
        want = step_grads(trainer, batch, valid, SEED)
    skip = GC.bias_leaves_feeding_batch_norm(trainer.model)
    names = [n for n in want if n not in skip]
    err = _norm_rel([got[n] for n in names], [want[n] for n in names])
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    return {"norm_rel_err": err, "finite": finite,
            "ok": finite and err <= BF16_GRAD_TOL["default"]}


def bf16_bwd_calls(trainer, batch, valid) -> dict:
    """Each bf16 MLP backward kernel call of one fused bf16 step against the
    bf16 plain version on the same inputs, and the f32 plain version as the
    control (all outputs as one vector, relative in norm)."""
    calls = []
    backward = K.SAMlpMaxFn.backward

    def recording(ctx, dpooled):
        res = backward(ctx, dpooled)
        grouped, *flat = ctx.saved_tensors
        layers = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        calls.append((grouped, layers, dpooled.contiguous(), ctx.needs_input_grad[0], ctx.bf16,
                      ([res[0]] if ctx.needs_input_grad[0] else []) + list(res[2:])))
        return res

    with mock.patch.object(K.SAMlpMaxFn, "backward", staticmethod(recording)):
        step_grads(trainer, batch, valid, SEED)
    errs, controls = [], []
    with torch.no_grad():
        for grouped, layers, dpooled, need, bf16, got in calls:
            for flag, into in ((True, errs), (False, controls)):
                rdg, rdl = K.sa_mlp_max_bwd_plain(grouped, layers, dpooled, need, flag)
                into.append(_norm_rel(got, ([rdg] if need else []) + [x for layer in rdl
                                                                       for x in layer]))
    ok = (len(calls) == 3 and all(c[4] for c in calls)
          and max(errs) <= BF16_GRAD_TOL["fused"] < min(controls))
    return {"calls": len(calls), "bf16": [c[4] for c in calls], "norm_rel_err": errs,
            "f32_plain_norm_rel_err": controls, "ok": ok}


def phase_serve_cls_large(dev) -> dict:
    """A classifier request at N=40,000 (B=2): FPS above its register limit
    at sa1, the matmul-form ball query at both stages (N above 20,480 and
    N=512); against the plain versions."""
    v = random_flax_variables(SEED, "pointnet_pp_cls", in_channels=CLS_CHANNELS)
    pred = OrientationPredictor("pointnet_pp_cls", v["params"], v["batch_stats"],
                                num_points=CLS_LARGE_N, max_batch=2, seed=SEED, device=dev)
    x = cls_clouds(2, CLS_LARGE_N, np.random.default_rng(SEED + 12))
    K.reset_launch_counts()
    out = pred(x)
    launches = K.launch_counts()
    lse = np.log(np.exp(out.astype(np.float64)).sum(-1))
    if out.shape != (2, 40) or not np.isfinite(out).all() or np.abs(lse).max() > LSE_TOL:
        fail(f"classifier N={CLS_LARGE_N}: output {out.shape}, logsumexp {np.abs(lse).max()}")
    if launches != expected_launches(fps=2, ball_query=2, sa_mlp_max=3):
        fail(f"classifier N={CLS_LARGE_N}: launches {launches}")
    pred.generator.manual_seed(SEED)
    with_kernels = pred(x)
    pred.generator.manual_seed(SEED)
    with mock.patch.object(K, "fps", K.fps_plain), \
            mock.patch.object(K, "ball_query", K.ball_query_plain), \
            mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
        plain = pred(x)
    err = float(np.abs(with_kernels - plain).max())
    ok = bool(np.allclose(with_kernels, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL))
    emit("serve_cls_large", N=CLS_LARGE_N, B=2, launches=launches, max_abs_err=err,
         tol=LOGIT_TOL, ok=ok)
    if not ok:
        fail(f"classifier N={CLS_LARGE_N}: kernels vs plain versions max abs err {err}")
    return {"predictor": pred, "clouds": x}


def phase_timing_bf16(dev, checks: dict, serve_bf16: dict, train_bf16: dict,
                      cls_large: dict) -> list:
    """The bf16 kernels beside their f32 variants (CUDA events, bounds at
    the bf16 rate), then end to end, f32 beside bf16 in this one run:
    requests at B=64 N=1024 and B=16 N=10,000, train steps at B=16
    N=10,000 (the preset) and at bench.py's B=64 N=1024, both configurations;
    and the N=40,000 classifier request."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    per_shape = {"sa_mlp_max_bf16": {}, "sa_mlp_max_bwd_bf16": {}}
    for name in BF16_MLP_SHAPES:
        B, Kn, S, widths = SA_MLP_SHAPES[name]
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        ms, host_ms = timed(lambda: K.sa_mlp_max(g, layers, bf16=True))
        f32_ms = cuda_ms(lambda: K.sa_mlp_max(g, layers))
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_plain(g, layers, bf16=True))
        b_ms, b_by = bound_ms(*sa_mlp_cost(B, Kn, S, widths))
        per_shape["sa_mlp_max_bf16"][name] = dict(
            ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            share=b_ms / ms, library_ms=None, host_ms=host_ms,
            max_abs_err=checks["sa_mlp_max_bf16"][name]["max_abs_err"])
        emit("timing", kernel="sa_mlp_max_bf16", shape=name, **per_shape["sa_mlp_max_bf16"][name])
    for name, (B, Kn, S, widths) in TRAIN_MLP_SHAPES.items():
        g = torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev)
        layers = make_layers(widths, gen, dev)
        dp = torch.randn((B, S, widths[-1]), generator=gen, device=dev)
        ms, host_ms = timed(lambda: K.sa_mlp_max_bwd(g, layers, dp, bf16=True), iters=10)
        f32_ms = cuda_ms(lambda: K.sa_mlp_max_bwd(g, layers, dp), iters=10)
        plain_ms = cuda_ms(lambda: K.sa_mlp_max_bwd_plain(g, layers, dp, bf16=True), iters=10)
        b_ms, b_by = bound_ms(*mlp_bwd_cost(B, Kn, S, widths))
        per_shape["sa_mlp_max_bwd_bf16"][name] = dict(
            ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            share=b_ms / ms, library_ms=None, host_ms=host_ms,
            device_kernels=bwd_device_kernels(g, layers, dp, name, bf16=True),
            **checks["sa_mlp_max_bwd_bf16"][name])
        emit("timing", kernel="sa_mlp_max_bwd_bf16", shape=name,
             **per_shape["sa_mlp_max_bwd_bf16"][name])

    # requests, f32 and bf16 alternating (host clock, median of 5 each)
    rng = np.random.default_rng(SEED + 14)
    latency = []
    for n, b in ((1024, 64), (10000, 16)):
        x = rng.normal(size=(b, n, 3)).astype(np.float32)
        for rnd in range(2):
            for dtype, pred in (("float32", serve_bf16["f32"][n]),
                                ("bfloat16", serve_bf16["predictors"][n])):
                latency.append({"dtype": dtype, "round": rnd, **request_latency(pred, x)})
    latency.append({"dtype": "float32", "model": "pointnet_pp_cls",
                    **request_latency(cls_large["predictor"], cls_large["clouds"])})
    emit("timing_serve_bf16", requests=latency)

    # train steps, f32 and bf16 in turn, at the preset's shape and bench.py's
    steps = []
    for n, b in TIMED_TRAIN_SHAPES:
        ds = train_bf16["default"]["trainer"].dataset if n == TRAIN_N else OrientationDataset(
            *synthetic_modelnet(num_points=n, samples_per_class=-(-b * 10 // 42) + 1))
        for mode in ("default", "fused"):
            for dtype in (None, "bfloat16"):
                if n == TRAIN_N and dtype == "bfloat16":
                    trainer = train_bf16[mode]["trainer"]
                else:
                    trainer = Trainer(preset("8dir_kl", num_points=n, batch_size=b,
                                             compute_dtype=dtype), ds, device=dev,
                                      fused_mlp_train=mode == "fused")
                t = step_times(trainer, f"timing_train_bf16 {mode} {dtype} N={n}")
                steps.append({"N": n, "B": b, "mode": mode, "dtype": dtype or "float32", **t})
    emit("timing_train_bf16", steps=steps)

    sources = {
        "sa_mlp_max_bf16": ("pointcloud_orientation_tpu_torch/csrc/sa_mlp_max.cu",
                            "pointcloud_orientation_tpu/ops/pallas_kernels.py:738",
                            serve_bf16["launches"]["sa_mlp_max_bf16"],
                            ("sa1 B=64", "sa2 B=64", "sa3 B=64"),
                            "one bf16 forward at B=64 N=1024: sa1, sa2, sa3",
                            "bf16 8-dir serving, N=1024 B=1/13/64/100 and N=10000 B=16"),
        "sa_mlp_max_bwd_bf16": ("pointcloud_orientation_tpu_torch/csrc/sa_mlp_max_bwd.cu",
                                "pointcloud_orientation_tpu/ops/pallas_kernels.py:762",
                                train_bf16["fused"]["launches"]["sa_mlp_max_bwd_bf16"],
                                tuple(TRAIN_MLP_SHAPES),
                                "one fused bf16 train step at B=16 N=10000: sa1, sa2, sa3",
                                "train bf16 fused, one epoch"),
    }
    summary = []
    for kname, (src, replaces, launches, shapes_, per, path) in sources.items():
        rows = [per_shape[kname][s_] for s_ in shapes_]
        b_ms = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        summary.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape[kname].values()),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": "bytes" if by_bytes * 2 >= b_ms else "operations",
            "library_ms": None, "f32_ms": sum(r["f32_ms"] for r in rows), "per": per,
            "launches_path": path, "shapes": per_shape[kname],
            **({"device_kernels_per_fused_step": sum(r["device_kernels"] for r in rows)}
               if kname == "sa_mlp_max_bwd_bf16" else {}),
        })
    return summary


# ---------------------------------------------------------------------------
# the grid-pruned kNN (topk_min) and the yaw-distribution heads
# ---------------------------------------------------------------------------

# topk_min: (B, S, M, K). The 8-dir sa1 grid shape at N=10,000, an M that is
# not a multiple of 32, M = K, rows of 4,096 (the window of
# PCOT_KNN_GRID_M=4096) and 20,000 entries, both staged in shared memory, and
# the device-memory path (rows beyond the kernel's 57,344 staged entries).
TOPK_SHAPES = {"sa1 B=16 M=1024": (16, 128, 1024, 32), "M=1000": (16, 128, 1000, 32),
               "M=K=32": (16, 128, 32, 32), "M=4096": (16, 128, 4096, 32),
               "M=20000": (4, 128, 20_000, 32),
               "M=230000 device memory": (1, 16, 230_000, 32)}
GRID_N = 10_000
# the heads served at B=16, N=10,000: (case, model, random_flax_variables options)
HEAD_CASES = (("fwd", "pointnet_pp_fwd", {}),
              ("vm tanh", "pointnet_pp_von_mises", {"mu_parameterization": "tanh"}),
              ("vm atan2", "pointnet_pp_von_mises", {"mu_parameterization": "atan2"}),
              ("mvm zero", "pointnet_pp_mvm", {"mu_init": "zero"}),
              ("mvm spread", "pointnet_pp_mvm", {"mu_init": "spread"}))
UNIT_TOL = 1e-5  # unit vectors and mixture weights summing to 1
TRAIN_HEADS = ("multi_8dir", "vm_kl", "mvm_robust", "mvm_debug")
TRAIN_HEADS_GRID = ("vm_kl", "mvm_robust")


def topk_min_case(gen, dev, B, S, M, Kn, case):
    """A candidate tile: "ties" (multiples of 1/8: many exact ties, a row
    with 5 finite entries, an all-inf row, a row with exactly K), "signed"
    (the same rows, the ties drawn from negative values, -0.0 beside 0.0 and
    positive ones) or "random" (uniform distances, the last quarter of each
    row inf, as a window's empty slots)."""
    if case in ("ties", "signed"):
        if case == "signed":
            values = torch.tensor([-2.5, -1.0, -0.0, 0.0, 0.125, 3.0], device=dev)
            d = values[torch.randint(0, len(values), (B, S, M), generator=gen, device=dev)]
        else:
            d = torch.randint(0, 64, (B, S, M), generator=gen, device=dev).float() / 8
        d[0, 0, 5:] = math.inf
        d[0, 1] = math.inf
        d[-1, -1, Kn:] = math.inf
    else:
        d = torch.rand((B, S, M), generator=gen, device=dev)
        d[..., max(Kn, 3 * M // 4):] = math.inf
    return d.contiguous()


def topk_min_cost(B, S, M, Kn) -> tuple[float, float]:
    """Bytes: the tile read once, the indices written once. Operations: one
    compare per entry (selecting K of M needs on the order of M compares)."""
    return 4 * (B * S * M + B * S * Kn), B * S * M


def phase_kernels_topk_min(dev) -> dict:
    """The topk_min kernel bit-equal in indices to its plain version at every
    TOPK_SHAPES shape, on tie-rich tiles with short and empty rows (also with
    negative values and -0.0 beside 0.0) and on random ones."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    results = {}
    for name, (B, S, M, Kn) in TOPK_SHAPES.items():
        for case in ("ties", "signed", "random"):
            d = topk_min_case(gen, dev, B, S, M, Kn, case)
            got = K.topk_min(d, Kn)
            want = K.topk_min_plain(d, Kn)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
                fail(f"topk_min {name} {case}: {tuple(got.shape)} {got.dtype}, differs in "
                     f"{int((got != want).sum()) if got.shape == want.shape else 'shape'}")
            if case != "random" and (bool(got[0, 1].any()) or bool(got[0, 0, 5:].any())):
                fail(f"topk_min {name}: a row past its finite entries is not 0: {got[0, :2]}")
        results[name] = {"max_abs_err": 0.0, "exact": True}
        emit("kernel_check", kernel="topk_min", shape=name, exact=True,
             inputs=["ties", "signed", "random"])
    emit("kernels_topk_min", shapes=list(TOPK_SHAPES), exact=True)
    return {"topk_min": results}


def grid_clouds(b, n, rng) -> np.ndarray:
    """Uniform clouds in [-1, 1]^3 whose first 128 points (the centroids of
    sampling "first") lie in [-0.5, 0.5]^3: every such centroid's K nearest
    are inside its cell cube, so the grid certificate holds."""
    x = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    x[:, :128] *= 0.5
    return x


def two_clusters(b, n, rng) -> np.ndarray:
    """Two boxes, [2, 3]^3 and [-3, -2]^3, half the points each: a box's
    points fill a few cells, so a cell cube holds more than the window's
    1,024 slots and the certificate fails."""
    x = rng.uniform(2, 3, size=(b, n, 3)).astype(np.float32)
    x[:, 1::2] *= -1
    return x


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def max_abs(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(as_tuple(a), as_tuple(b)))


def sets_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows whose neighbour sets differ."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def phase_serve_grid(dev) -> dict:
    """The grid dispatch's serving path: an 8-dir and a vM request at B=16,
    N=10,000 (sampling "first", certifying clouds) under ``"grid"`` and
    under ``"exact"``, counters from 0 around each; sa1's neighbour sets
    against the kNN kernel's; then a cloud that fails the certificate. The
    dispatch is restored to ``"exact"`` whatever happens."""
    rng = np.random.default_rng(SEED + 16)
    x = grid_clouds(16, GRID_N, rng)
    preds = {name: OrientationPredictor(name, v["params"], v["batch_stats"], num_points=GRID_N,
                                        max_batch=16, seed=SEED, device=dev, sampling="first")
             for name, v in (("pointnet_pp_8dir", random_flax_variables(SEED)),
                             ("pointnet_pp_von_mises",
                              random_flax_variables(SEED, "pointnet_pp_von_mises")))}
    out = {"requests": [], "launches": None, "predictor": preds["pointnet_pp_8dir"], "clouds": x}
    try:
        G.set_knn_impl("grid")
        K.reset_launch_counts()
        grid_out = {name: pred(x) for name, pred in preds.items()}
        launches = K.launch_counts()
        out["launches"] = launches
        if launches != expected_launches(topk_min=2, sa_group=2, sa_mlp_max=6):
            fail(f"grid requests: launches {launches}")
        G.set_knn_impl("exact")
        K.reset_launch_counts()
        exact_out = {name: pred(x) for name, pred in preds.items()}
        exact_launches = K.launch_counts()
        if exact_launches != expected_launches(sa_group=4, sa_mlp_max=6):
            fail(f"exact requests: launches {exact_launches}")

        # sa1's neighbours: the grid path's sets against the kNN kernel's
        # (both difference form: equal exactly) and the fused grouping's
        # (matmul form, the exact dispatch's sa1: near-ties may swap a point)
        xyz = torch.from_numpy(x).to(dev)
        c = xyz[:, :128].contiguous()
        cidx = torch.arange(128, dtype=torch.int32, device=dev).expand(16, 128).contiguous()
        G.set_knn_impl("grid")
        grid_idx, ok = G.grid_pruned_core(c, xyz, 32)
        knn_idx = K.knn(c, xyz, 32)
        fused_idx = K.sa_group(xyz, None, cidx, 32)[2]
        vs_knn, vs_fused = sets_differ(grid_idx, knn_idx), sets_differ(grid_idx, fused_idx)
        if not bool(ok) or vs_knn:
            fail(f"grid sa1: certificate {bool(ok)}, {vs_knn} rows differ from the kNN kernel")
        for name in preds:
            err = max_abs(grid_out[name], exact_out[name])
            shapes = [np.shape(o) for o in as_tuple(grid_out[name])]
            finite = all(np.isfinite(o).all() for o in as_tuple(grid_out[name]))
            ok_out = err <= LOGIT_TOL and finite
            out["requests"].append({"model": name, "shapes": shapes,
                                    "max_abs_err_vs_exact": err, "ok": ok_out})
            if not ok_out:
                fail(f"grid request {name}: {err} from the exact dispatch (rows whose sa1 set "
                     f"differs from the fused grouping's: {vs_fused}), finite {finite}")
        emit("serve_grid", B=16, N=GRID_N, launches=launches, exact_launches=exact_launches,
             certificate=bool(ok), sa1_rows_differing_from_knn=vs_knn,
             sa1_rows_differing_from_fused_grouping=vs_fused, requests=out["requests"],
             tol=LOGIT_TOL)

        # a cloud that fails the certificate: the grid stage falls back to
        # the full exact kNN (the kNN kernel), once
        y = two_clusters(16, GRID_N, rng)
        pred = preds["pointnet_pp_8dir"]
        K.reset_launch_counts()
        got = pred(y)
        fb_launches = K.launch_counts()
        if fb_launches != expected_launches(topk_min=1, knn=1, sa_group=1, sa_mlp_max=3):
            fail(f"grid fallback request: launches {fb_launches}")
        yt = torch.from_numpy(y).to(dev)
        cy = yt[:, :128].contiguous()
        fb_ok = bool(G.grid_pruned_core(cy, yt, 32)[1])
        fb_idx = G.grid_pruned_knn(cy, yt, 32)
        knn_y = K.knn(cy, yt, 32)
        if fb_ok or not torch.equal(fb_idx, knn_y):
            fail(f"grid fallback: certificate {fb_ok}, indices equal to the kNN kernel's "
                 f"{torch.equal(fb_idx, knn_y)}")
        # the exact path the fallback takes: sa1 through the kNN kernel
        G.set_knn_impl("exact")
        with mock.patch.object(G, "FUSED_GROUP_MAX_N", GRID_N - 1):
            want = pred(y)
        err = max_abs(got, want)
        default = pred(y)
        vs_fused_y = sets_differ(knn_y, K.sa_group(yt, None, cidx, 32)[2])
        emit("serve_grid_fallback", B=16, N=GRID_N, launches=fb_launches, certificate=fb_ok,
             max_abs_err_vs_exact_knn_path=err,
             max_abs_diff_vs_exact_dispatch=max_abs(got, default),
             sa1_rows_knn_vs_fused_grouping=vs_fused_y, tol=LOGIT_TOL)
        if err > LOGIT_TOL:
            fail(f"grid fallback request: {err} from the exact kNN path")
    finally:
        G.set_knn_impl("exact")
    return out


def phase_serve_heads(dev) -> dict:
    """The heads' serving path at B=16, N=10,000 (random centroids from the
    predictor's seed), counters from 0 around each request: through the
    kernels against the plain versions (same generator state), unit
    forward vectors, mixture weights summing to 1, kappa in range."""
    rng = np.random.default_rng(SEED + 17)
    x = rng.normal(size=(16, GRID_N, 3)).astype(np.float32)
    rows, preds = [], {}
    for case, name, kw in HEAD_CASES:
        v = random_flax_variables(SEED, name, **kw)
        pred = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=GRID_N,
                                    max_batch=16, seed=SEED, device=dev)
        K.reset_launch_counts()
        got = pred(x)
        launches = K.launch_counts()
        if launches != expected_launches(sa_group=2, sa_mlp_max=3):
            fail(f"{case} request: launches {launches}")
        pred.generator.manual_seed(SEED)
        with_kernels = pred(x)
        pred.generator.manual_seed(SEED)
        with mock.patch.object(K, "sa_group", K.sa_group_plain), \
                mock.patch.object(K, "sa_mlp_max", K.sa_mlp_max_plain):
            plain = pred(x)
        err = max_abs(with_kernels, plain)
        outs = as_tuple(got)
        checks = {"finite": all(np.isfinite(o).all() for o in outs),
                  "batch": all(o.shape[0] == 16 for o in outs)}
        if name == "pointnet_pp_fwd":
            checks["unit"] = bool(np.abs(np.linalg.norm(outs[0], axis=-1) - 1).max() <= UNIT_TOL)
        elif name == "pointnet_pp_von_mises":
            checks["mu_in_range"] = bool((np.abs(outs[0]) <= math.pi + 1e-6).all())
            checks["kappa_nonnegative"] = bool((outs[1] >= 0).all())
        else:
            mu, kappa, w = outs
            checks["weights_sum_to_1"] = bool(np.abs(w.sum(-1) - 1).max() <= UNIT_TOL)
            checks["kappa_in_range"] = bool(((kappa > 0) & (kappa <= 80.0)).all())
            checks["shapes"] = mu.shape == kappa.shape == w.shape == (16, 4)
        fwd = pred.forward_vectors(x)
        checks["forward_vectors_unit"] = bool(
            fwd.shape == (16, 3) and np.abs(np.linalg.norm(fwd, axis=-1) - 1).max() <= UNIT_TOL)
        ok = err <= LOGIT_TOL and all(checks.values())
        rows.append({"case": case, "model": name, "launches": launches,
                     "max_abs_err_vs_plain": err, "checks": checks, "ok": ok})
        if not ok:
            fail(f"{case} request: {err} from the plain versions (tol {LOGIT_TOL}), {checks}")
        preds[case] = pred
    emit("serve_heads", B=16, N=GRID_N, requests=rows, tol=LOGIT_TOL, unit_tol=UNIT_TOL)
    return {"predictors": preds, "clouds": x}


def heads_dataset(cfg) -> OrientationDataset:
    """48 clouds of the preset's classes: 3 train steps and 1 val batch."""
    return OrientationDataset(*synthetic_modelnet(
        num_points=TRAIN_N, samples_per_class=48 // len(cfg.classes),
        class_names=list(cfg.classes)))


def train_epoch(name: str, dev, out_dir: str, grid: bool) -> dict:
    """One epoch of a preset at B=16, N=10,000, counters from 0: finite
    losses, f32 parameters and Adam state, and its launches (under the grid
    dispatch one topk_min per forward at sa1, and the kNN kernel whenever
    the certificate fails)."""
    cfg = preset(name, epochs=1, out_dir=out_dir)
    trainer = Trainer(cfg, heads_dataset(cfg), device=dev)
    steps = -(-len(trainer.train_ds) // cfg.batch_size)
    val = -(-len(trainer.val_ds) // cfg.batch_size)
    K.reset_launch_counts()
    trainer.fit(epochs=1, log_every=0)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    forwards = steps + val
    if grid:
        fallbacks = launches["knn"]
        expected = expected_launches(topk_min=forwards, knn=fallbacks, sa_group=forwards,
                                     sa_mlp_max=3 * val, sa_group_scatter=steps)
        count_ok = launches == expected and fallbacks <= forwards
    else:
        expected = expected_launches(sa_group=2 * forwards, sa_mlp_max=3 * val,
                                     sa_group_scatter=steps)
        count_ok = launches == expected
    losses = trainer.step_losses
    f32_state = all(p.dtype == torch.float32 for p in trainer.model.parameters()) and all(
        t.dtype == torch.float32 for st in trainer.optimizer.state.values()
        for t in st.values() if t.dim())
    finite = (len(losses) == steps and all(math.isfinite(v) for v in losses)
              and math.isfinite(trainer.history["val"][0]))
    row = {"preset": name, "knn_impl": "grid" if grid else "exact", "train_steps": steps,
           "val_batches": val, "step_losses": losses, "val_loss": trainer.history["val"][0],
           "val_angular_deg": trainer.history["val_ang"][0], "launches": launches,
           "expected_launches": expected, "params_and_adam_f32": f32_state,
           "timings": trainer.timings}
    emit("train_heads", **row)
    if not (finite and f32_state and count_ok):
        fail(f"train {name} ({row['knn_impl']}): losses {losses}, val {trainer.history['val']}, "
             f"f32 {f32_state}, launches {launches}, expected {expected}")
    return {"trainer": trainer, "launches": launches, "steps": steps}


def phase_train_heads(dev) -> dict:
    """One epoch of multi_8dir, vm_kl, mvm_robust and mvm_debug (its
    debug_log.txt in a temporary directory), then vm_kl and mvm_robust under
    the grid dispatch (restored to "exact" whatever happens)."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name in TRAIN_HEADS:
            out[name] = train_epoch(name, dev, d, grid=False)
        log = os.path.join(d, "debug_log.txt")
        lines = open(log).read().splitlines() if os.path.exists(log) else []
        emit("train_heads_debug_log", lines=len(lines), first=lines[:1])
        if not lines or not lines[0].startswith("epoch=1 batch=0 loss="):
            fail(f"mvm_debug wrote no debug_log.txt entry: {lines[:2]}")
        try:
            G.set_knn_impl("grid")
            for name in TRAIN_HEADS_GRID:
                out[f"{name} grid"] = train_epoch(name, dev, d, grid=True)
        finally:
            G.set_knn_impl("exact")
    return out


# ---------------------------------------------------------------------------
# training the classifier
# ---------------------------------------------------------------------------

CLS_PLAIN = {"fps": K.fps_plain, "ball_query": K.ball_query_plain,
             "sa_mlp_max": K.sa_mlp_max_plain, "sa_mlp_max_bwd": K.sa_mlp_max_bwd_plain}


def cls_train_config() -> TrainConfig:
    """The classifier's training config: no preset names it (nor in the JAX
    package); B=16 and N=1024 are the config's defaults."""
    return TrainConfig(task="classification", model="pointnet_pp_cls", epochs=1)


def phase_train_cls(dev) -> dict:
    """The classifier's training main path: one epoch (3 steps of B=16 and
    1 val batch, N=1024 xyz clouds, full width) through ``Trainer`` in each
    train configuration, counters from 0. A step launches 2 FPS and 2 ball
    queries, and on the fused path 3 MLP forwards and 3 backwards (sa1, sa2
    at K=64, the group-all stage at K=128); a val batch 2 + 2 + 3 forwards.
    Then one step's gradients through the kernels against the plain
    versions."""
    ds = OrientationDataset(*synthetic_modelnet(num_points=CLS_TRAIN_N,
                                                samples_per_class=TRAIN_SAMPLES_PER_CLASS))
    out = {}
    for mode in ("default", "fused"):
        fused = mode == "fused"
        trainer = Trainer(cls_train_config(), ds, device=dev, fused_mlp_train=fused)
        steps = -(-len(trainer.train_ds) // trainer.cfg.batch_size)
        val = -(-len(trainer.val_ds) // trainer.cfg.batch_size)
        K.reset_launch_counts()
        trainer.fit(epochs=1, log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        forwards = steps + val
        expected = expected_launches(fps=2 * forwards, ball_query=2 * forwards,
                                     sa_mlp_max=3 * forwards if fused else 3 * val,
                                     sa_mlp_max_bwd=3 * steps if fused else 0)
        losses = trainer.step_losses
        emit("train_cls", mode=mode, batch=trainer.cfg.batch_size, num_points=CLS_TRAIN_N,
             train_steps=steps, val_batches=val, step_losses=losses,
             val_loss=trainer.history["val"][0], val_angular_deg=trainer.history["val_ang"][0],
             launches=launches, expected_launches=expected, timings=trainer.timings)
        finite = (len(losses) == steps and all(math.isfinite(x) for x in losses)
                  and math.isfinite(trainer.history["val"][0]))
        if not finite or not math.isnan(trainer.history["val_ang"][0]):
            fail(f"train_cls {mode}: losses {losses}, val {trainer.history['val']}, "
                 f"angular {trainer.history['val_ang']} (classification has none)")
        if launches != expected:
            fail(f"train_cls {mode}: launches {launches}, expected {expected}")
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        check = grads_vs_plain(trainer, batch, valid, mode, CLS_PLAIN)
        emit("train_cls_check", mode=mode, grads_vs_plain_worst=check["worst"],
             **{k: v for k, v in check.items() if k != "worst"})
        if not check["ok"]:
            fail(f"train_cls {mode}: gradient of {check['worst']} differs by "
                 f"{check['norm_rel_err']} from the plain path")
        out[mode] = {"trainer": trainer, "launches": launches, "steps": steps}
    return out


def phase_timing_train_cls(train_cls: dict) -> dict:
    """A classifier train step in each configuration: host clock (median
    of 5 after 2 warm-ups), then the device's busy time a step and its idle
    share under the profiler (``train/profile_step.profile_mode``, its trace
    in a temporary directory)."""
    out = {}
    for mode, run in train_cls.items():
        steps = step_times(run["trainer"], f"timing_train_cls {mode}")
        emit("timing_train_cls", mode=mode, batch=16, num_points=CLS_TRAIN_N, **steps)
        with tempfile.TemporaryDirectory() as d:
            prof = profile_mode(run["trainer"], TRAIN_STEP_ITERS, d, mode)
        emit("timing_train_cls_device", batch=16, num_points=CLS_TRAIN_N, **prof)
        out[mode] = {"step": steps, "device": prof}
    return out


def profiled_ms(fn, iters: int = 5) -> float:
    """Device time per call of ``fn`` from the profiler's kernel, copy and
    fill durations, over ``iters`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(us for _, us in device_events(prof)) / 1e3 / iters


def phase_timing_grid(dev, checks: dict, serve_grid: dict, serve_heads: dict,
                      train_heads: dict) -> list:
    """topk_min at its shapes on random distances, and on the tie-rich
    "ties" and "signed" tiles (CUDA events after a device sleep, bound, plain
    version, ``torch.topk``); the grid stage at sa1 (B=16, N=10,000) split
    into index build, window gather and topk_min from the profiler's device
    durations, beside the whole stage and the exact path's sa1; a request
    and a vm_kl train step, exact and grid in alternating pairs, and a
    request of each head (host clock, medians of 5)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    per_shape = {}
    for name, (B, S, M, Kn) in TOPK_SHAPES.items():
        b_ms, b_by = bound_ms(*topk_min_cost(B, S, M, Kn))
        per_case = {}
        for case in ("random", "ties", "signed"):
            d = topk_min_case(gen, dev, B, S, M, Kn, case)
            ms, host_ms = timed(lambda: K.topk_min(d, Kn))
            plain_ms = cuda_ms(lambda: K.topk_min_plain(d, Kn))
            library_ms = cuda_ms(lambda: torch.topk(d, Kn, dim=-1, largest=False, sorted=True))
            per_case[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  share=b_ms / ms, host_ms=host_ms)
        per_shape[name] = dict(**per_case.pop("random"), bound_ms=b_ms, bound_by=b_by,
                               **per_case, **checks["topk_min"][name])
        emit("timing", kernel="topk_min", shape=name, **per_shape[name])

    # the grid stage at sa1 of a B=16, N=10,000 request, part by part
    xyz = torch.from_numpy(serve_grid["clouds"]).to(dev)
    c = xyz[:, :128].contiguous()
    g, r, m = G._KNN_GRID_G, G._KNN_GRID_R, min(G._KNN_GRID_M, GRID_N)
    lo, h, order, pts_s, starts = G.grid_bins(xyz, g)
    _, _, _, dist = G.grid_window(c, lo, h, starts, pts_s, g, r, m)
    parts = {
        "index build (grid_bins)": lambda: G.grid_bins(xyz, g),
        "window gather (grid_window)": lambda: G.grid_window(c, lo, h, starts, pts_s, g, r, m),
        "topk_min": lambda: K.topk_min(dist, 32),
        "whole stage (grid_pruned_knn)": lambda: G.grid_pruned_knn(c, xyz, 32),
        "exact stage (kNN kernel)": lambda: K.knn(c, xyz, 32),
        "exact dispatch's sa1 (sa_group)": lambda: K.sa_group(
            xyz, None, torch.arange(128, dtype=torch.int32, device=dev).expand(16, 128)
            .contiguous(), 32),
    }
    stage = {name: profiled_ms(fn) for name, fn in parts.items()}
    emit("timing_grid_stage", B=16, N=GRID_N, device_ms=stage)

    latency, steps = [], []
    pred, x = serve_grid["predictor"], serve_grid["clouds"]
    trainer = train_heads["vm_kl"]["trainer"]
    try:
        for rnd in range(2):
            for impl in ("exact", "grid"):
                G.set_knn_impl(impl)
                latency.append({"knn_impl": impl, "round": rnd, **request_latency(pred, x)})
                K.reset_launch_counts()
                t = step_times(trainer, f"timing_grid vm_kl {impl}")
                steps.append({"knn_impl": impl, "round": rnd, "launches": K.launch_counts(), **t})
    finally:
        G.set_knn_impl("exact")
    emit("timing_grid", request=latency, vm_kl_step=steps)
    heads = [{"case": case, **request_latency(pred, serve_heads["clouds"])}
             for case, pred in serve_heads["predictors"].items()]
    emit("timing_serve_heads", requests=heads)

    rows = [per_shape["sa1 B=16 M=1024"]]
    return [{
        "name": "topk_min", "route": "cuda",
        "source": "pointcloud_orientation_tpu_torch/csrc/topk_min.cu",
        "replaces": "pointcloud_orientation_tpu/ops/pallas_kernels.py:878",
        "launches": serve_grid["launches"]["topk_min"],
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": rows[0]["bound_by"],
        "library_ms": sum(r["library_ms"] for r in rows),
        "per": "one grid stage: sa1 of an 8-dir request at B=16 N=10000 (S=128, M=1024, K=32)",
        "launches_path": "grid serving: one 8-dir and one vM request at B=16 N=10000",
        "library_call": "torch.topk(d, K, largest=False, sorted=True); its order among "
                        "equal values is not guaranteed",
        "shapes": per_shape,
    }]


# ---------------------------------------------------------------------------
# the MLP forward against the backward's recompute, and the selection
# micro-benchmarks
# ---------------------------------------------------------------------------

# (K, widths) of every stage the MLP kernels run: the 8-dir trunk's three and
# the classifier's three (K=64 at sa2, the group-all's 128 rows)
RECOMPUTE_STAGES = {name: (kn, widths) for name, (_, kn, _, widths) in SA_MLP_SHAPES.items()
                    if not name.startswith("cls train")}  # those repeat the widths above
RECOMPUTE_SEEDS = 4
RECOMPUTE_COLUMNS = 12  # pooled columns sampled a seed
# the neighbours of a near-tie centroid: one row plus this much noise, relative
# (bf16 rounds its inputs to 8 bits, so its rows differ more)
RECOMPUTE_SPREAD = {False: 2.0 ** -12, True: 2.0 ** -6}


def affine_f32(z: float, s: float, t: float) -> np.float32:
    """y = z * s + t in f32, each operation rounded (the kernels' affine)."""
    return np.float32(np.float32(np.float32(z) * np.float32(s)) + np.float32(t))


def mlp_recompute_check(dev, bf16: bool, seeds: int = RECOMPUTE_SEEDS,
                        columns: int = RECOMPUTE_COLUMNS) -> dict:
    """Does ``sa_mlp_max_bwd``'s recompute reproduce ``sa_mlp_max``'s pooled
    value bit for bit? One centroid (B = S = 1) whose K neighbours are near
    ties (one random row plus a little noise), random layers; for sampled
    columns c with a positive pooled value, ``dpooled`` one-hot at c. Where
    the backward routes that cotangent to a single neighbour (one row of
    ``dgrouped`` is non-zero), the last layer's ``dscale[c]`` is the
    recomputed z at the recomputed maximum, and ``relu(affine(z, s, t))``
    must be the pooled value's bits. Returns the counts per stage."""
    gen = torch.Generator(device=dev)
    out = {}
    for name, (kn, widths) in RECOMPUTE_STAGES.items():
        checked = differ = shared = 0
        for seed in range(seeds):
            gen.manual_seed(SEED + 30 + seed)
            base = torch.randn((widths[0],), generator=gen, device=dev)
            noise = torch.randn((1, kn, 1, widths[0]), generator=gen, device=dev)
            g = (base * (1 + RECOMPUTE_SPREAD[bf16] * noise)).contiguous()
            layers = make_layers(widths, gen, dev)
            pooled = K.sa_mlp_max(g, layers, bf16=bf16)[0, 0]
            live = torch.nonzero(pooled > 0).flatten()
            pick = live[torch.randperm(len(live), generator=gen, device=dev)[:columns]]
            for c in pick.tolist():
                dp = torch.zeros((1, 1, widths[-1]), device=dev)
                dp[0, 0, c] = 1.0
                dg, dl = K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16)
                if int((dg[0, :, 0] != 0).any(dim=-1).sum()) != 1:
                    shared += 1  # the recomputed maximum is tied: dscale mixes rows
                    continue
                y = max(affine_f32(float(dl[-1][1][c]), float(layers[-1][1][c]),
                                   float(layers[-1][2][c])), np.float32(0.0))
                checked += 1
                differ += int(np.float32(y).view(np.int32)
                              != np.float32(float(pooled[c])).view(np.int32))
        out[name] = {"checked": checked, "differ": differ, "tied_maximum_skipped": shared}
    return out


def phase_mlp_recompute(dev) -> None:
    """The repair's check: the MLP backward's recomputed maximum reproduces
    the forward's pooled value bit for bit, f32 and bf16, at every stage's
    widths (``mlp_recompute_check``)."""
    for bf16 in (False, True):
        res = mlp_recompute_check(dev, bf16)
        ok = all(r["checked"] > 0 and r["differ"] == 0 for r in res.values())
        emit("mlp_recompute", dtype="bfloat16" if bf16 else "float32", stages=res, ok=ok)
        if not ok:
            fail(f"sa_mlp_max vs the backward's recompute ({'bf16' if bf16 else 'f32'}): {res}")


# The selections' edges (B, S, N, K): a warp a row up to N=1,024 (a lane's
# words: 1 to 32), a block a row above, K=1 and K=N; the last row in
# registers, the first in shared memory and the longest, K=1 and K=32
VPU_EDGE_SHAPES = ([(2, 3, n, k) for n in (1, 31, 32, 33, 1023, 1024, 1025, 10_000)
                    for k in sorted({1, n})]
                   + [(2, 3, n, k) for n in (16_384, 16_385, PV.MAX_N) for k in (1, 32)])


def phase_kernels_vpu_select(dev) -> dict:
    """The five micro-benchmark kernels bit for bit against their plain
    versions: ``ew`` in f32, bf16 and int16 at the JAX file's shape on
    random values and at ``profile_vpu_select.EW_EDGE_LENGTHS`` (tails of 1
    to 7 elements) on its edge values (signed zeros, infinities, NaN,
    subnormals, int16's extremes), 0, 1, 31, 32 (the unrolled kernel) and
    33 rounds; the four selections at the shapes
    they are timed at (``profile_vpu_select.SELECT_SHAPES``) on random and
    tie-rich rows, and at ``VPU_EDGE_SHAPES`` on every kind of
    ``profile_vpu_select.ROW_KINDS`` (``+inf`` runs, all-equal rows, -0.0
    and negative values)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    results = {}
    shape = (PV.B, PV.S, PV.N)
    for dtype in PV.EW_DTYPES:
        view = torch.int32 if dtype == torch.float32 else torch.int16
        inputs = {"random (64, 128, 1024)": PV.ew_input(dtype, shape, gen)}
        inputs.update({f"edge n={n}": PV.ew_edge_input(dtype, n, gen)
                       for n in PV.EW_EDGE_LENGTHS})
        for name, x in inputs.items():
            for reps in PV.EW_EDGE_REPS:
                got, want = PV.ew(x, reps), PV.ew_plain(x, reps)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got.view(view), want.view(view)):
                    fail(f"ew {dtype} {name} reps={reps}: differs from the plain version in "
                         f"{int((got.view(view) != want.view(view)).sum())} elements")
        emit("kernel_check", kernel="ew", dtype=str(dtype), exact=True,
             reps=list(PV.EW_EDGE_REPS), inputs=len(inputs),
             specials=[str(v) for v in PV.EW_SPECIALS[dtype]])
    results["ew"] = {"max_abs_err": 0.0, "exact": True}
    for fn in PV.SELECTIONS:
        cases = [(name, sel_shape, kind) for name, sel_shape in PV.SELECT_SHAPES.items()
                 for kind in ("random", "ties")]
        cases += [(f"B={b} S={s} N={n} K={k}", (b, s, n, k), kind)
                  for b, s, n, k in VPU_EDGE_SHAPES for kind in PV.ROW_KINDS]
        for name, (b, s, n, k), kind in cases:
            d = PV.select_rows(kind, (b, s, n), gen)
            got, want = fn(d, k), PV.PLAIN[fn](d, k)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"{fn.__name__} {name} {kind}: differs from the plain version")
        emit("kernel_check", kernel=fn.__name__, exact=True, cases=len(cases),
             shapes=sorted({name for name, _, _ in cases}),
             inputs=sorted({kind for _, _, kind in cases}))
        results[fn.__name__] = {"max_abs_err": 0.0, "exact": True}
    return results


def phase_vpu_select(dev, checks: dict) -> list:
    """The micro-benchmarks' main path: ``profile_vpu_select.benchmark``,
    the module's ``main`` without its printing, with its launch counters
    set to 0 just before and read just after; every kernel must have run.
    Its rows are the five kernels' timing rows."""
    PV.reset_launch_counts()
    rows = PV.benchmark(dev)
    launches = PV.launch_counts()
    emit("vpu_select", launches=launches)
    if min(launches.values()) == 0:
        fail(f"a micro-benchmark kernel was never launched: {launches}")
    for row in rows:
        emit("timing", **row)
    src = "pointcloud_orientation_tpu_torch/csrc/vpu_select.cu"
    summary = []
    for fn in PV.KERNELS:
        name = fn.__name__
        mine = [r for r in rows if r["kernel"] == name]
        head = mine[0]  # ew: f32; a selection: the JAX file's B=64 N=1024
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"benchmarks/profile_vpu_select.py{PV.REPLACES[fn]}",
            "launches": launches[name], "max_abs_err": checks[name]["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "per": ("one call at (64, 128, 1024) f32, 32 rounds" if name == "ew"
                    else "one call at B=64 S=128 N=1024 K=32"),
            "launches_path": "profile_vpu_select.benchmark (the module's main)",
            "rows": mine,
            **({"library_call": "torch.topk(d, K, largest=False); its order among equal "
                                "values is not guaranteed"} if name == "count_emit" else {}),
        })
    return summary


# ---------------------------------------------------------------------------
# the SO(3) tasks: PointNetPP and the two-axis heads, served and trained
# ---------------------------------------------------------------------------

SO3_N, SO3_B = 1024, 64  # the SO(3) serving requests
SO3_MODELS = (("pointnet_pp", {}), ("pointnet_pp_xyz", {}),
              ("pointnet_pp_xyz_schmidt", {"gram_schmidt": True}))
SO3_BALL = {"sampling": "fps", "grouping": "ball"}  # the trunk heads' FPS/ball modes
SO3_PER_LABEL = ("chair", "sofa")
SO3_INDEX = ("sa_group", "fps", "ball_query")  # index kernels: held bit for bit


def so3_clouds(b, n, seed) -> np.ndarray:
    """``(b, n, 3)`` synthetic ModelNet-like clouds under random SO(3)
    rotations (the port's pipeline draw)."""
    xyz, _, _ = synthetic_modelnet(seed=seed, num_points=n, samples_per_class=-(-b // 6))
    pts = torch.from_numpy(xyz[:b])
    rot = random_so3_matrix(torch.Generator().manual_seed(seed), b)
    return rotate_points(pts, rot).numpy().astype(np.float32)


def index_calls_vs_kernels(pred, x) -> tuple:
    """The request through every kernel's plain version, recording each
    index call (``sa_group``, ``fps``, ``ball_query``); then each index
    kernel on the recorded inputs, bit for bit against the plain result.
    Returns the plain output and the number of index calls held."""
    calls = []

    def recording(name):
        plain = getattr(K, f"{name}_plain")

        def call(*args):
            out = plain(*args)
            calls.append((name, args, out))
            return out
        return call

    pred.generator.manual_seed(SEED)
    with mock.patch.multiple(K, sa_mlp_max=K.sa_mlp_max_plain,
                             **{n: recording(n) for n in SO3_INDEX}):
        plain = pred(x)
    for name, args, want in calls:
        got = getattr(K, name)(*args)
        for a, b in zip(as_tuple(got), as_tuple(want)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"{name} on a {pred.model_name} request: kernel differs from plain")
    return plain, len(calls)


def so3_output_checks(name, kw, outs, b) -> dict:
    """Finite outputs of ``b`` rows of 3; unit heads; Gram-Schmidt's up
    vector unit and orthogonal to the unit forward one."""
    checks = {"finite": all(np.isfinite(o).all() for o in outs),
              "shapes": all(o.shape == (b, 3) for o in outs)}
    if name != "pointnet_pp":
        checks["unit"] = all(np.abs(np.linalg.norm(o, axis=-1) - 1).max() <= UNIT_TOL
                             for o in outs)
    if kw.get("gram_schmidt"):
        checks["orthogonal"] = bool(np.abs((outs[0] * outs[1]).sum(-1)).max() <= UNIT_TOL)
    return checks


def phase_serve_so3(dev) -> dict:
    """The SO(3) serving path: ``pointnet_pp``, ``pointnet_pp_xyz`` and
    ``pointnet_pp_xyz_schmidt`` (Gram-Schmidt) through
    ``OrientationPredictor`` at B=64 N=1024 in f32 and bf16 on SO(3)-rotated
    clouds (2 ``sa_group`` and 3 MLP launches a request), and the Schmidt
    head with FPS and the ball query on one B=16 N=10,000 request (2 FPS, 2
    ball-query and 3 MLP launches), counters from 0 around each request.
    Then each request through the plain versions from the same generator
    state: outputs within LOGIT_TOL (f32) or BF16_LOGIT_TOL (bf16), every
    index kernel bit for bit on the plain path's inputs."""
    x = so3_clouds(SO3_B, SO3_N, SEED + 21)
    x_ball = so3_clouds(16, TRAIN_N, SEED + 22)
    cases = [(name, kw, dtype, x) for name, kw in SO3_MODELS for dtype in (None, "bfloat16")]
    cases.append(("pointnet_pp_xyz_schmidt", {"gram_schmidt": True, **SO3_BALL}, None, x_ball))
    rows, preds, launches = [], {}, {}
    for name, kw, dtype, clouds in cases:
        v = random_flax_variables(SEED, name)
        b, n = clouds.shape[:2]
        pred = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=n,
                                    max_batch=b, seed=SEED, device=dev, dtype=dtype, **kw)
        K.reset_launch_counts()
        got = pred(clouds)
        torch.cuda.synchronize()
        got_launches = K.launch_counts()
        mlp = "sa_mlp_max_bf16" if dtype else "sa_mlp_max"
        if kw.get("grouping") == "ball":
            expected = expected_launches(fps=2, ball_query=2, **{mlp: 3})
        else:
            expected = expected_launches(sa_group=2, **{mlp: 3})
        pred.generator.manual_seed(SEED)
        with_kernels = pred(clouds)
        plain, index_calls = index_calls_vs_kernels(pred, clouds)
        err = max_abs(with_kernels, plain)
        tol = BF16_LOGIT_TOL if dtype else LOGIT_TOL
        outs = as_tuple(got)
        checks = so3_output_checks(name, kw, outs, b)
        fwd = pred.forward_vectors(clouds)
        checks["forward_vectors_unit"] = bool(
            fwd.shape == (b, 3) and np.abs(np.linalg.norm(fwd, axis=-1) - 1).max() <= UNIT_TOL)
        case = f"{name}{' gram_schmidt' if kw.get('gram_schmidt') else ''}" \
               f"{' fps/ball' if kw.get('grouping') else ''} {dtype or 'float32'}"
        ok = got_launches == expected and err <= tol and all(checks.values())
        rows.append({"case": case, "B": b, "N": n, "launches": got_launches,
                     "index_calls_bit_equal": index_calls, "max_abs_err_vs_plain": err,
                     "tol": tol, "checks": checks, "ok": ok})
        if not ok:
            fail(f"serve_so3 {case}: launches {got_launches} (expected {expected}), "
                 f"{err} from the plain versions (tol {tol}), {checks}")
        preds[case] = pred
        launches[case] = got_launches
    emit("serve_so3", requests=rows)
    return {"predictors": preds, "launches": launches, "clouds": {"knn": x, "ball": x_ball}}


def so3_dataset(classes, per_class: int) -> OrientationDataset:
    return OrientationDataset(*synthetic_modelnet(num_points=TRAIN_N, samples_per_class=per_class,
                                                  class_names=list(classes)))


def batches_of(ds, batch_size: int) -> int:
    return -(-len(ds) // batch_size)


def knn_trunk_launches(steps: int, evals: int, fused: bool) -> dict:
    """One epoch's launches on the kNN trunk: 2 groupings a forward, the
    scatter a step; the MLP forward kernel in eval, and on the fused path
    in every step with its backward."""
    return expected_launches(sa_group=2 * (steps + evals),
                             sa_mlp_max=3 * (steps + evals) if fused else 3 * evals,
                             sa_group_scatter=steps, sa_mlp_max_bwd=3 * steps if fused else 0)


def phase_train_so3(dev) -> dict:
    """The SO(3) training path at full width (B=16, N=10,000): one epoch of
    ``pointnet_pp_forward`` in each train configuration (launch counts, a
    step's gradients against the plain versions under the repaired rule, a
    checkpoint round trip); ``axes_all_labels`` (Gram-Schmidt) through
    ``run_per_label`` over two labels, one epoch each (with its prediction
    PLYs), and again with ``resume`` (nothing trains); one step of the Schmidt head with FPS and
    the ball query in each configuration, its gradients against every
    kernel's plain version."""
    out = {}
    cfg = preset("pointnet_pp_forward", epochs=1)
    ds = so3_dataset(cfg.classes, 48)
    for mode in ("default", "fused"):
        fused = mode == "fused"
        trainer = Trainer(cfg, ds, device=dev, fused_mlp_train=fused)
        steps, val = batches_of(trainer.train_ds, 16), batches_of(trainer.val_ds, 16)
        K.reset_launch_counts()
        trainer.fit(epochs=1, log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expected = knn_trunk_launches(steps, val, fused)
        losses = trainer.step_losses
        finite = (len(losses) == steps and all(math.isfinite(v) for v in losses)
                  and math.isfinite(trainer.history["val"][0]))
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        check = grads_vs_plain(trainer, batch, valid, mode, TRAIN_PLAIN)
        with tempfile.TemporaryDirectory() as d:
            other = Trainer(cfg, ds, device=dev, fused_mlp_train=fused)
            epoch = other.restore_checkpoint(trainer.save_checkpoint(d))
            same = all(torch.equal(a, b) for a, b in zip(other.model.state_dict().values(),
                                                         trainer.model.state_dict().values()))
        emit("train_so3", preset="pointnet_pp_forward", mode=mode, train_steps=steps,
             val_batches=val, step_losses=losses, val_loss=trainer.history["val"][0],
             val_angular_deg=trainer.history["val_ang"][0], launches=launches,
             expected_launches=expected, grads_vs_plain=check, checkpoint_equal=same,
             timings=trainer.timings)
        if not (finite and launches == expected and check["ok"] and same and epoch == 1):
            fail(f"train_so3 {mode}: losses {losses}, launches {launches} (expected "
                 f"{expected}), gradient of {check['worst']} {check['norm_rel_err']}, "
                 f"checkpoint equal {same}")
        out[f"forward {mode}"] = {"trainer": trainer, "launches": launches}

    ds = so3_dataset(SO3_PER_LABEL, 24)
    cfg = preset("axes_all_labels", epochs=1, axes_gram_schmidt=True)
    expected = expected_launches()
    for label in SO3_PER_LABEL:
        parts = ds.select_classes([label]).split(cfg.seed)
        steps, evals = batches_of(parts[0], 16), sum(batches_of(p, 16) for p in parts[1:])
        evals += 1  # run_single's prediction PLYs: one request of the test clouds
        for k, v in knn_trunk_launches(steps, evals, False).items():
            expected[k] += v
    with tempfile.TemporaryDirectory() as d:
        K.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            summary = run_per_label(cfg, ds, d, str(dev))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        with open(os.path.join(d, "summary.txt")) as f:
            lines = f.read().splitlines()
        K.reset_launch_counts()
        again = run_per_label(cfg, ds, d, str(dev), resume=True)
        resumed = K.launch_counts()
    ok = (launches == expected and [line.split("\t")[0] for line in lines] == list(SO3_PER_LABEL)
          and all(math.isfinite(v) for v in summary.values()) and again == summary
          and not any(resumed.values()))
    emit("train_so3_per_label", preset="axes_all_labels", labels=list(SO3_PER_LABEL),
         summary_lines=lines, launches=launches, expected_launches=expected,
         resumed_launches={k: v for k, v in resumed.items() if v}, ok=ok)
    if not ok:
        fail(f"axes_all_labels per label: summary {lines}, launches {launches} (expected "
             f"{expected}), resumed {resumed}")
    out["per_label"] = {"launches": launches}

    cfg = TrainConfig(task="axes", model="pointnet_pp_xyz_schmidt", rotation_mode="so3",
                      num_points=TRAIN_N, axes_gram_schmidt=True, classes=SO3_PER_LABEL)
    for mode in ("default", "fused"):
        fused = mode == "fused"
        trainer = Trainer(cfg, ds, device=dev, fused_mlp_train=fused, **SO3_BALL)
        idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
        batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
        K.reset_launch_counts()
        loss = float(trainer.train_step(batch, valid, trainer.generator(0, 98, 0))["loss"])
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expected = expected_launches(fps=2, ball_query=2, sa_mlp_max=3 if fused else 0,
                                     sa_mlp_max_bwd=3 if fused else 0)
        check = grads_vs_plain(trainer, batch, valid, mode, CLS_PLAIN)
        emit("train_so3_ball", mode=mode, loss=loss, launches=launches,
             expected_launches=expected, grads_vs_plain=check)
        if not (math.isfinite(loss) and launches == expected and check["ok"]):
            fail(f"train_so3_ball {mode}: loss {loss}, launches {launches} (expected "
                 f"{expected}), gradient of {check['worst']} {check['norm_rel_err']}")
        out[f"ball {mode}"] = {"trainer": trainer, "launches": launches}
    return out


def phase_timing_so3(serve: dict, serve_bf16: dict, train: dict, serve_so3: dict,
                     train_so3: dict) -> None:
    """The SO(3) paths beside the 8-dir paths of the same shape, in turns
    (8-dir, SO(3), SO(3), 8-dir) in this one phase: request latency (host
    clock, median of 5 after a warm-up) with each request's device time and
    device kernels from the profiler, for the Schmidt head at B=64 N=1024
    in f32 and bf16 and the FPS/ball request at B=16 N=10,000 (against the
    8-dir kNN request at N=10,000); then train steps (median of 5 after 2
    warm-ups) of ``pointnet_pp_forward`` beside 8dir_kl in each
    configuration."""
    preds, clouds = serve_so3["predictors"], serve_so3["clouds"]
    pairs = (("B=64 N=1024 float32", serve["predictors"][1024],
              preds["pointnet_pp_xyz_schmidt gram_schmidt float32"], clouds["knn"]),
             ("B=64 N=1024 bfloat16", serve_bf16["predictors"][1024],
              preds["pointnet_pp_xyz_schmidt gram_schmidt bfloat16"], clouds["knn"]),
             ("B=16 N=10000 fps/ball vs knn", serve["predictors"][10000],
              preds["pointnet_pp_xyz_schmidt gram_schmidt fps/ball float32"], clouds["ball"]))
    requests = []
    for label, base, so3, x in pairs:
        turns = [(name, request_latency(pred, x)["ms_median"])
                 for name, pred in (("8dir", base), ("so3", so3), ("so3", so3), ("8dir", base))]
        row = {"shape": label, "turns_ms": turns}
        for name, pred in (("8dir", base), ("so3", so3)):
            row[name] = {"ms_median": float(np.median([t for n, t in turns if n == name])),
                         "device_ms": profiled_ms(lambda: pred(x)),
                         "device_kernels": device_kernels(lambda: pred(x))}
        requests.append(row)
    steps = {}
    for mode in ("default", "fused"):
        base, so3 = train[mode]["trainer"], train_so3[f"forward {mode}"]["trainer"]
        turns = [(name, step_times(t, f"timing_so3 {name} {mode}")["ms_median"])
                 for name, t in (("8dir_kl", base), ("pointnet_pp_forward", so3),
                                 ("pointnet_pp_forward", so3), ("8dir_kl", base))]
        steps[mode] = {"turns_ms": turns, **{name: float(np.median([t for n, t in turns
                                                                   if n == name]))
                                             for name in ("8dir_kl", "pointnet_pp_forward")}}
    emit("timing_so3", requests=requests,
         train_steps={"batch": 16, "num_points": TRAIN_N, **steps})

# The point transformer (preset ``point_transformer``) and its flash kernels
FLASH_SHAPES = {"preset B=16 N=1024": (16, 4, 1024, 16), "long B=2 N=16384": (2, 4, 16384, 16)}
# the checks' shapes: the timed ones, one 128-row tile, D=8 and D=32, and B*H
# odd with five 128-row tiles (tests/test_torch_cuda.py FLASH_CASES, FLASH_ODD)
FLASH_CHECK_SHAPES = {**FLASH_SHAPES, "one-tile B=3 H=2 N=128": (3, 2, 128, 16),
                      "D=8 B=2 H=3 N=384": (2, 3, 384, 8), "D=32 B=2 H=2 N=640": (2, 2, 640, 32),
                      "odd B=1 H=3 N=640": (1, 3, 640, 16)}
FLASH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernel vs plain version, the largest difference over the largest value of
# the plain output (l: relative, m: over max(1, |m|)): f32 sums in another
# order (and FMA contraction); bf16 also flips roundings of p, ds and the
# outputs (one bf16 step is 2^-8 of a value)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_PLAIN = {"flash_attention_fwd": FA.flash_attention_plain,
               "flash_attention_bwd_dkv": FA.flash_attention_bwd_dkv_plain,
               "flash_attention_bwd_dq": FA.flash_attention_bwd_dq_plain}
FLASH_KERNELS = tuple(FLASH_PLAIN)
PT_B, PT_N = 64, 1024  # serving requests
PT_REQUESTS = 2
PT_DEPTH = 6  # the preset's depth: 6 attention layers, one launch of each kernel a layer
PT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # outputs through the kernels vs the plain versions
PT_GRAD_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
PT_LONG = (2, 16_384)  # the long-context flash step
PT_PLAIN_NS = (2048, 4096, 8192, 12_288, 16_384)  # the plain step's N, until one does not fit


def flash_inputs(shape, dtype, gen, dev):
    """q, k, v and a cotangent (B,H,N,D) of unit normals in ``dtype``."""
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4)]


def flash_cost(kernel, B, H, N, D, bf16) -> tuple:
    """Bytes (inputs read once, outputs written once) and operations of one
    call, per (query, key) pair: the products, 2D operations each (q.k and
    p.v in the forward; q.k, dO.v, p.dO and ds.q in dK/dV; q.k, dO.v and
    ds.k in dQ) at the tensor cores' rate (bf16, or f32 as 3xTF32), a few
    elementwise operations (scale, subtract, multiply) at the f32 rate, and
    one exponential at the SFU rate."""
    pairs = B * H * N * N
    e = 2 if bf16 else 4
    rows, stats = B * H * N * D * e, B * H * N * 4
    products, rest, nbytes = {
        "flash_attention_fwd": (4 * D, 3, 4 * rows + 2 * stats),
        "flash_attention_bwd_dkv": (8 * D, 5, 6 * rows + 3 * stats),
        "flash_attention_bwd_dq": (6 * D, 4, 5 * rows + 3 * stats)}[kernel]
    kw = {"bf16_flops" if bf16 else "f32_products": pairs * products}
    return nbytes, dict(flops=pairs * rest, transcendentals=pairs, **kw)


def flash_errors(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def flash_ptxas() -> dict:
    """The flash kernels' registers and spills from the build's ``ptxas -v``
    lines, by "<kernel> <type> D=<d>"."""
    out = {}
    for name, text in _build.ptxas_summary(_build.LIBRARY.nvcc_log).items():
        hit = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_kernel)I(f|13__nv_bfloat16)Li(\d+)E", name)
        if hit:
            dtype = "float32" if hit.group(2) == "f" else "bfloat16"
            out[f"{hit.group(1)} {dtype} D={hit.group(3)}"] = text
    return dict(sorted(out.items()))


def phase_kernels_flash(dev) -> dict:
    """The three flash kernels against their plain versions at every
    FLASH_CHECK_SHAPES shape, f32 and bf16: the forward's o, l (relative)
    and m, then dK/dV and dQ on the forward's l and m with a random
    cotangent; each kernel's counter must move by one a call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    checks = {k: {} for k in FLASH_KERNELS}
    for name, shape in FLASH_CHECK_SHAPES.items():
        for dname, dtype in FLASH_DTYPES.items():
            q, k, v, do = flash_inputs(shape, dtype, gen, dev)
            scale = 1.0 / math.sqrt(shape[-1])
            before = K.launch_counts()
            o, l, m = K.flash_attention_fwd(q, k, v, scale)
            di = FA.row_di(o, do)
            dk, dv = K.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale)
            dq = K.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale)
            torch.cuda.synchronize()
            moved = {n: K.launch_counts()[n] - before[n] for n in FLASH_KERNELS}
            po, pl, pm = FA.flash_attention_plain(q, k, v, scale)
            pdk, pdv = FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, scale)
            pdq = FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, scale)
            errs = {
                "flash_attention_fwd": {
                    "o": flash_errors([o], [po]),
                    "l": float(((l - pl).abs() / pl).max()),
                    "m": float((m - pm).abs().max()) / max(1.0, float(pm.abs().max()))},
                "flash_attention_bwd_dkv": {"dk": flash_errors([dk], [pdk]),
                                            "dv": flash_errors([dv], [pdv])},
                "flash_attention_bwd_dq": {"dq": flash_errors([dq], [pdq])}}
            abs_errs = {"flash_attention_fwd": float((o.float() - po.float()).abs().max()),
                        "flash_attention_bwd_dkv": max(float((a.float() - b.float()).abs().max())
                                                       for a, b in ((dk, pdk), (dv, pdv))),
                        "flash_attention_bwd_dq": float((dq.float() - pdq.float()).abs().max())}
            for kname in FLASH_KERNELS:
                tol = (FLASH_TOL if kname == "flash_attention_fwd" else FLASH_BWD_TOL)[dname]
                finite = all(bool(torch.isfinite(t).all()) for t in (o, l, m, dk, dv, dq))
                ok = finite and moved[kname] == 1 and max(errs[kname].values()) <= tol
                row = {"rel_err": errs[kname], "max_abs_err": abs_errs[kname], "tol": tol,
                       "launches": moved[kname], "ok": ok}
                checks[kname][f"{name} {dname}"] = row
                emit("kernels_flash", kernel=kname, shape=name, dtype=dname, **row)
                if not ok:
                    fail(f"{kname} {name} {dname}: {row}")
            del q, k, v, do, o, l, m, di, dk, dv, dq, po, pl, pm, pdk, pdv, pdq
    torch.cuda.empty_cache()
    return checks


def transformer_predictor(dev, impl: str, dtype) -> OrientationPredictor:
    v = random_flax_variables(SEED, "point_transformer")
    return OrientationPredictor("point_transformer", v["params"], num_points=PT_N,
                                max_batch=PT_B, seed=SEED, device=dev, attention_impl=impl,
                                dtype=dtype)


def phase_serve_transformer(dev) -> dict:
    """``point_transformer`` served through ``OrientationPredictor`` at
    B=64 N=1024, full width (depth 6, embed 64, 4 heads, FFN 2048), random
    weights from the seed, on both backends in f32 and bf16: the flash
    backend launches the forward kernel once a layer, the plain backend
    nothing; the flash outputs against the same requests through the plain
    versions, and against the plain backend."""
    x = so3_clouds(PT_B, PT_N, SEED + 41)
    rows, preds, launches = [], {}, {}
    for dname in ("float32", "bfloat16"):
        dtype = None if dname == "float32" else dname
        outs = {}
        for impl in ("xla", "flash"):
            pred = transformer_predictor(dev, impl, dtype)
            K.reset_launch_counts()
            for _ in range(PT_REQUESTS):
                got = pred(x)
            torch.cuda.synchronize()
            n = K.launch_counts()
            expected = expected_launches(
                **({"flash_attention_fwd": PT_DEPTH * PT_REQUESTS} if impl == "flash" else {}))
            with mock.patch.multiple(K, **FLASH_PLAIN):
                plain = pred(x)
            err = float(np.abs(got - plain).max())
            fwd = pred.forward_vectors(x)
            ok = bool(n == expected and got.shape == (PT_B, 3) and np.isfinite(got).all()
                      and err <= PT_TOL[dname]
                      and np.abs(np.linalg.norm(fwd, axis=-1) - 1).max() <= UNIT_TOL)
            case = f"{impl} {dname}"
            rows.append({"case": case, "B": PT_B, "N": PT_N, "requests": PT_REQUESTS,
                         "launches": n, "expected_launches": expected,
                         "max_abs_err_vs_plain": err, "tol": PT_TOL[dname], "ok": ok})
            if not ok:
                fail(f"serve_transformer {case}: launches {n} (expected {expected}), {err} "
                     f"from the plain versions (tol {PT_TOL[dname]})")
            outs[impl] = got
            preds[case] = pred
            launches[case] = n
        rows.append({"case": f"flash vs xla {dname}",
                     "max_abs_diff": float(np.abs(outs["flash"] - outs["xla"]).max())})
    emit("serve_transformer", requests=rows)
    return {"predictors": preds, "launches": launches, "clouds": x}


def transformer_dataset(n: int, per_class: int) -> OrientationDataset:
    return OrientationDataset.synthetic(samples_per_class=per_class, num_points=n,
                                        class_names=["chair"])


def phase_train_transformer(dev) -> dict:
    """One epoch of the ``point_transformer`` preset (B=16, N=1024, full
    width) with ``transformer_attention="flash"`` in f32 and bf16, as the
    CLI's synthetic data gives it (64 chairs: 3 steps, 1 val batch): exact
    launches (the forward kernel once a layer a forward, dK/dV and dQ once
    a layer a step), finite losses; one step's gradients through the kernels
    against the plain versions (``utils/grad_check.py``: each attention's
    key bias, zero in exact arithmetic, left out), and a checkpoint round
    trip."""
    ds = transformer_dataset(PT_N, 64)
    out = {}
    for dname in ("float32", "bfloat16"):
        dtype = None if dname == "float32" else dname
        cfg = preset("point_transformer", epochs=1, transformer_attention="flash",
                     compute_dtype=dtype)
        trainer = Trainer(cfg, ds, device=dev)
        steps, val = batches_of(trainer.train_ds, 16), batches_of(trainer.val_ds, 16)
        K.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the flash backend's dropout warning
            trainer.fit(epochs=1, log_every=0)
            torch.cuda.synchronize()
            launches = K.launch_counts()
            expected = expected_launches(flash_attention_fwd=PT_DEPTH * (steps + val),
                                         flash_attention_bwd_dkv=PT_DEPTH * steps,
                                         flash_attention_bwd_dq=PT_DEPTH * steps)
            losses = trainer.step_losses
            idx, valid, _ = next(ds.batches(16, shuffle=True, seed=1))
            batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
            check = grads_vs_plain(trainer, batch, valid, dname, FLASH_PLAIN, PT_GRAD_TOL[dname])
        with tempfile.TemporaryDirectory() as d:
            path = trainer.save_checkpoint(d)
            other = Trainer(cfg, ds, device=dev)
            epoch = other.restore_checkpoint(path)
            same = all(torch.equal(a, b) for a, b in zip(other.model.state_dict().values(),
                                                         trainer.model.state_dict().values()))
        emit("train_transformer", dtype=dname, attention="flash", train_steps=steps,
             val_batches=val, step_losses=losses, val_loss=trainer.history["val"][0],
             launches=launches, expected_launches=expected, timings=trainer.timings,
             grads_vs_plain_worst=check["worst"],
             **{k: v for k, v in check.items() if k not in ("worst", "group_all_shift")},
             checkpoint_equal=same and epoch == 1)
        if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
                and math.isfinite(trainer.history["val"][0])):
            fail(f"train_transformer {dname}: losses {losses}, val {trainer.history['val']}")
        if launches != expected:
            fail(f"train_transformer {dname}: launches {launches}, expected {expected}")
        if not check["ok"]:
            fail(f"train_transformer {dname}: gradient of {check['worst']} differs by "
                 f"{check['norm_rel_err']} from the plain path")
        if not (same and epoch == 1):
            fail(f"train_transformer {dname}: checkpoint round trip")
        out[dname] = {"trainer": trainer, "launches": launches}
    return out


def sdpa_ms(q, k, v, do, scale, backward: bool, iters: int) -> float:
    """The yardstick ``library_ms``: one ``scaled_dot_product_attention``
    call (the forward), or its backward (dq, dk and dv together) on the
    same inputs. Timed here only; the port never calls it."""
    F = torch.nn.functional
    if not backward:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), iters)
    del o, qg, kg, vg
    return ms


def long_step(dev, impl: str, n: int, dtype=None) -> dict:
    """One ``point_transformer`` train step at B=2 and N=n on backend
    ``impl`` (compute type ``dtype``, else f32): step time (median of
    TRAIN_STEP_ITERS after 2 warm-ups) and the peak of
    ``torch.cuda.max_memory_allocated`` over the steps; or ``fits: False``
    when the card runs out of memory."""
    import gc
    B = PT_LONG[0]
    trainer = None
    try:
        cfg = preset("point_transformer", batch_size=B, num_points=n, transformer_attention=impl,
                     compute_dtype=dtype)
        trainer = Trainer(cfg, transformer_dataset(n, 8), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = step_times(trainer, f"timing_transformer {impl} N={n}")
        out = {"N": n, "fits": True, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               **t}
    except torch.cuda.OutOfMemoryError as e:
        out = {"N": n, "fits": False, "error": str(e).splitlines()[0][:200]}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_timing_transformer(dev, checks: dict, serve: dict, train: dict) -> list:
    """The flash kernels at the preset's shape and the long-context one, f32
    and bf16: CUDA events beside the plain versions, the bound (products at
    the tensor cores' rate, exponentials at the SFU rate) and
    ``scaled_dot_product_attention`` as ``library_ms``. Then request latency
    (B=64 N=1024) and the preset's step time (B=16 N=1024) on both backends
    in turns (xla, flash, flash, xla), each request's device time and
    kernels from the profiler; the whole backward (dK/dV and dQ, one call
    each) beside SDPA's; then the long-context step: flash at B=2 and
    every N of PT_PLAIN_NS up to 16,384 (and at 16,384 in bf16), the plain
    backend until it does not fit, each with its step time and peak device
    memory."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 42)
    per = {k: {} for k in FLASH_KERNELS}
    whole_bwd = []
    ptxas = flash_ptxas()
    emit("timing_flash_ptxas", kernels=ptxas)
    for name, shape in FLASH_SHAPES.items():
        long = shape[2] > 4096
        for dname, dtype in FLASH_DTYPES.items():
            q, k, v, do = flash_inputs(shape, dtype, gen, dev)
            scale = 1.0 / math.sqrt(shape[-1])
            o, l, m = K.flash_attention_fwd(q, k, v, scale)
            di = FA.row_di(o, do)
            calls = {
                "flash_attention_fwd": (lambda: K.flash_attention_fwd(q, k, v, scale),
                                        lambda: FA.flash_attention_plain(q, k, v, scale), False),
                "flash_attention_bwd_dkv": (
                    lambda: K.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale),
                    lambda: FA.flash_attention_bwd_dkv_plain(q, k, v, l, m, do, di, scale), True),
                "flash_attention_bwd_dq": (
                    lambda: K.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale),
                    lambda: FA.flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, scale), True)}
            for kname, (kernel, plain, backward) in calls.items():
                ms, host_ms = timed(kernel, iters=5 if long else TIMING_ITERS)
                plain_ms = cuda_ms(plain, iters=3 if long else 10, warmup=1)
                lib_ms = sdpa_ms(q, k, v, do, scale, backward, iters=5 if long else TIMING_ITERS)
                nbytes, ops = flash_cost(kname, *shape, dtype == torch.bfloat16)
                b_ms, b_by = bound_ms(nbytes, **ops)
                kernel_name = kname.replace("flash_attention_", "flash_") + "_kernel"
                row = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                           max_abs_err=checks[kname][f"{name} {dname}"]["max_abs_err"],
                           ptxas=ptxas.get(f"{kernel_name} {dname} D={shape[-1]}"))
                per[kname][f"{name} {dname}"] = row
                emit("timing_flash", kernel=kname, shape=name, dtype=dname, **row)
            bwd_ms, _ = timed(lambda: (calls["flash_attention_bwd_dkv"][0](),
                                       calls["flash_attention_bwd_dq"][0]()),
                              iters=5 if long else TIMING_ITERS)
            sdpa = per["flash_attention_bwd_dq"][f"{name} {dname}"]["library_ms"]
            whole_bwd.append({"shape": name, "dtype": dname, "dkv_plus_dq_ms": bwd_ms,
                             "sdpa_backward_ms": sdpa, "ratio": bwd_ms / sdpa})
            del q, k, v, do, o, l, m, di
            torch.cuda.empty_cache()
    emit("timing_flash_backward", rows=whole_bwd)

    x = serve["clouds"]
    requests = []
    for dname in ("float32", "bfloat16"):
        xla, flash = serve["predictors"][f"xla {dname}"], serve["predictors"][f"flash {dname}"]
        turns = [(n, request_latency(p, x)["ms_median"])
                 for n, p in (("xla", xla), ("flash", flash), ("flash", flash), ("xla", xla))]
        row = {"dtype": dname, "B": PT_B, "N": PT_N, "turns_ms": turns}
        for n, p in (("xla", xla), ("flash", flash)):
            row[n] = {"ms_median": float(np.median([t for m, t in turns if m == n])),
                      "device_ms": profiled_ms(lambda: p(x)),
                      "device_kernels": device_kernels(lambda: p(x))}
        requests.append(row)
    steps = {}
    ds = transformer_dataset(PT_N, 64)
    for dname in ("float32", "bfloat16"):
        dtype = None if dname == "float32" else dname
        flash = train[dname]["trainer"]
        xla = Trainer(preset("point_transformer", compute_dtype=dtype), ds, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            turns = [(n, step_times(t, f"timing_transformer {n} {dname}")["ms_median"])
                     for n, t in (("xla", xla), ("flash", flash), ("flash", flash),
                                  ("xla", xla))]
        steps[dname] = {"turns_ms": turns, **{n: float(np.median([t for m, t in turns if m == n]))
                                             for n in ("xla", "flash")}}
        del xla
    long_steps = {"flash": [long_step(dev, "flash", n) for n in PT_PLAIN_NS],
                  "flash bfloat16": [long_step(dev, "flash", PT_LONG[1], "bfloat16")]}
    long_steps["xla"] = []
    for n in PT_PLAIN_NS:
        long_steps["xla"].append(long_step(dev, "xla", n))
        if not long_steps["xla"][-1]["fits"]:
            break
    fits = [r["N"] for r in long_steps["xla"] if r["fits"]]
    emit("timing_transformer", requests=requests,
         train_steps={"batch": 16, "num_points": PT_N, **steps},
         long_steps={"batch": PT_LONG[0], **long_steps},
         plain_largest_n_that_fits=max(fits) if fits else None)
    if not (long_steps["flash"][-1]["fits"] and long_steps["flash bfloat16"][-1]["fits"]):
        fail(f"timing_transformer: the flash step at B=2 N={PT_PLAIN_NS[-1]} did not fit")

    sources = "pointcloud_orientation_tpu_torch/csrc/flash_attention.cu"
    replaces = {
        "flash_attention_fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
                               "(_flash_attention_impl :589; via "
                               "pointcloud_orientation_tpu/models/point_transformer.py:24)",
        "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                                   "(_flash_attention_bwd_dkv :941)",
        "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                                  "(_flash_attention_bwd_dq :1287)"}
    summary = []
    for kname in FLASH_KERNELS:
        row = per[kname][f"preset B=16 N=1024 float32"]
        launches = {**{f"serve {c}": n[kname] for c, n in serve["launches"].items()},
                    **{f"train {d}": r["launches"][kname] for d, r in train.items()}}
        summary.append({
            "name": kname, "route": "cuda", "source": sources, "replaces": replaces[kname],
            "launches": sum(launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in checks[kname].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "per": "one call at the preset's shape, B=16 H=4 N=1024 D=16, f32 "
                   "(library_ms: scaled_dot_product_attention"
                   + (", its backward computing dq, dk and dv together)"
                      if kname != "flash_attention_fwd" else ")"),
            "launches_transformer": launches, "shapes": per[kname]})
    return summary


# ---------------------------------------------------------------------------
# real data: PLY trees with stored ground truth
# ---------------------------------------------------------------------------

REAL_STEP_TURNS = ("plygt", "synthetic", "synthetic", "plygt")  # step timing, in turns
REAL_TOL = 1e-5  # evaluate's loss against the run's own test pass on the same weights


def write_tree(root: str, pts, labels, names) -> None:
    for i, (cloud, label) in enumerate(zip(pts, labels)):
        os.makedirs(os.path.join(root, names[label]), exist_ok=True)
        write_ply(cloud, os.path.join(root, names[label], f"{names[label]}_{i:03d}.ply"))


def ply_files(root: str) -> list:
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs
                  if f.endswith(".ply"))


def check_run(what: str, out_dir: str, trainer, test_acc, launches, expected) -> dict:
    """A ``run_single`` of the real-data phase: finite losses, exact
    launches, and its prediction PLYs (if any) parse with 4 extra vertices."""
    pred_dir = os.path.join(out_dir, "pred_ply")
    plys = sorted(os.listdir(pred_dir)) if os.path.isdir(pred_dir) else []
    shapes = {read_ply(os.path.join(pred_dir, f)).shape for f in plys}
    parse_ok = all(sh == (trainer.num_points + 4, 3) for sh in shapes)
    losses = trainer.step_losses
    finite = (all(math.isfinite(v) for v in losses) and math.isfinite(test_acc.mean_loss)
              and math.isfinite(trainer.history["val"][0]))
    return {"what": what, "train_steps": len(losses), "step_losses": losses,
            "val_loss": trainer.history["val"][0], "test_loss": test_acc.mean_loss,
            "test_angular_deg": test_acc.mean_angular_error, "launches": launches,
            "expected_launches": expected, "pred_plys": len(plys), "pred_ply_shapes":
            sorted(list(sh) for sh in shapes), "ok": finite and parse_ok and launches == expected}


def phase_real_data(dev, train: dict) -> dict:
    """Real data on the card. A canonical PLY tree of the 6 synthetic
    classes (48 clouds of 10,000 points) is written, rotated by
    ``offline.rotate_tree`` (yaw) and given its three ground-truth passes,
    then read back with its sidecars through the native parser (held
    against the NumPy parser, file for file). The 8dir_kl preset (B=16,
    N=10,000) trains one epoch on the stored targets
    (``rotation_mode="none"``) through ``run_single`` in both train
    configurations: the stored targets in the batch unchanged, exact
    launches (the epoch, the test pass and the two extra requests of the
    prediction PLYs and the 8-direction summary), a step's gradients
    against the plain versions, the PLYs parsed, the step timed in turns
    with the synthetic step at the same shape. The trained weights go out
    as a reference-layout ``.pth`` (``utils/torch_export.py``) and come back
    through ``OrientationPredictor.from_torch_checkpoint`` (the same request
    output, bit for bit) and the ``evaluate`` CLI (``--torch-ckpt``, finite,
    and the run's own test loss). Then one epoch of the mvm preset on the
    same tree (its ``results.txt``), and the classifier one epoch from the
    canonical tree as ``ply:`` (B=16, N=1,024)."""
    t_phase = time.perf_counter()
    out = {"launches": {}}
    t0 = time.perf_counter()
    if not fastply.native_available():  # g++ on native/fastply.cc, or an earlier build loaded
        fail(f"real_data: the native PLY parser did not build: {fastply.build_error()}")
    parser_build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        canonical, rotated = os.path.join(d, "canonical"), os.path.join(d, "rotated")
        t0 = time.perf_counter()
        pts, labels, names = synthetic_modelnet(num_points=TRAIN_N,
                                                samples_per_class=TRAIN_SAMPLES_PER_CLASS)
        write_tree(canonical, pts, labels, names)
        written = [offline.rotate_tree(canonical, rotated, seed=SEED),
                   offline.generate_8dir_gt(rotated), offline.generate_single_peak_gt(rotated),
                   offline.generate_mvm_gt(rotated, rotated)]
        write_s = time.perf_counter() - t0

        fastply.reset_parser_counts()
        t0 = time.perf_counter()
        ds = OrientationDataset.from_ply_tree(rotated, TRAIN_N, load_sidecars=True)
        ingest_s = time.perf_counter() - t0
        parsers = fastply.parser_counts()
        files = ply_files(rotated)
        t0 = time.perf_counter()
        native = fastply.try_read_ply_bulk_native(files)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        numpy_parsed = [read_ply_numpy(f) for f in files]
        numpy_s = time.perf_counter() - t0
        same = native is not None and all(a is not None and np.array_equal(a, b)
                                          for a, b in zip(native, numpy_parsed))
        ingest = {"parser_build_seconds": parser_build_s, "parser_library":
                  str(fastply.build_library()), "files": len(files),
                  "points_per_file": TRAIN_N, "written": written,
                  "write_seconds": write_s, "ingest_seconds": ingest_s, "parsers": parsers,
                  "native_bulk_seconds": native_s, "numpy_seconds": numpy_s,
                  "native_equals_numpy": same, "build_error": fastply.build_error()}
        emit("real_data_ingest", **ingest)
        if parsers != {"native": len(files), "numpy": 0} or not same or len(ds) != len(files):
            fail(f"real_data ingest: parsers {parsers} over {len(files)} files, native equals "
                 f"numpy {same}, build error {fastply.build_error()}")
        out["ingest"] = ingest

        cfg = preset("8dir_kl", epochs=1, rotation_mode="none")
        for mode in ("default", "fused"):
            fused = mode == "fused"
            run_dir = os.path.join(d, f"8dir_kl_{mode}")
            K.reset_launch_counts()
            with contextlib.redirect_stdout(sys.stderr):
                trainer, test_acc = run_single(cfg, ds, run_dir, str(dev), fused)
            torch.cuda.synchronize()
            launches = K.launch_counts()
            n_test = len(trainer.test_ds)
            steps = batches_of(trainer.train_ds, 16)
            # the val and test passes, and one request each for the prediction PLYs and
            # the 8-direction summary
            evals = batches_of(trainer.val_ds, 16) + batches_of(trainer.test_ds, 16) + 2
            run = check_run(f"8dir_kl {mode}", run_dir, trainer, test_acc, launches,
                            knn_trunk_launches(steps, evals, fused))
            run["pred_plys_expected"] = min(10, n_test)
            with open(os.path.join(run_dir, "summary.txt")) as f:
                tail = [ln.split("\t")[0] for ln in f.read().splitlines()[-2:]]
            run["ok"] &= run["pred_plys"] == min(10, n_test) and tail == ["mean_gt_8dir",
                                                                           "mean_pred_8dir"]

            if mode == "default":  # the trained weights in the reference layout, out and back
                pth = os.path.join(d, "best.pth")
                tree = to_flax_variables(trainer.model)
                save_torch_checkpoint(pth, **tree, model=cfg.model)
                clouds = trainer.test_ds.points
                want = OrientationPredictor(cfg.model, tree["params"], tree["batch_stats"],
                                            num_points=TRAIN_N, device=dev)(clouds)
                got = OrientationPredictor.from_torch_checkpoint(pth, cfg.model,
                                                                 num_points=TRAIN_N,
                                                                 device=dev)(clouds)
                with contextlib.redirect_stdout(sys.stderr):
                    ev = EV.main(["--preset", "8dir_kl", "--data", f"plygt:{rotated}",
                                  "--torch-ckpt", pth, "--device", str(dev)])
                bit_equal = bool(np.array_equal(got, want))
                finite = all(math.isfinite(ev[k]) for k in ("loss", "mean_angular_error_deg"))
                rel = abs(ev["loss"] - test_acc.mean_loss) / abs(test_acc.mean_loss)
                ok = bit_equal and finite and ev["count"] == n_test and rel <= REAL_TOL
                emit("real_data_reference_ckpt", request_bit_equal=bit_equal,
                     request_shape=list(got.shape), evaluate=ev,
                     run_test_loss=test_acc.mean_loss, evaluate_rel_err=rel, tol=REAL_TOL,
                     ok=ok)
                if not ok:
                    fail(f"real_data reference checkpoint: request bit-equal {bit_equal}, "
                         f"evaluate {ev}, run test loss {test_acc.mean_loss}")

            # the stored targets reach the batch unchanged
            tds = trainer.train_ds
            idx, valid, _ = next(tds.batches(16, shuffle=True, seed=1))
            batch, valid, _ = trainer.device_batch(tds, idx, valid, trainer.generator(0, 99, 0))
            stored = {k: bool(torch.equal(batch[k].cpu(), torch.from_numpy(v[idx])))
                      for k, v in tds.targets.items()}
            check = grads_vs_plain(trainer, batch, valid, mode, TRAIN_PLAIN)
            emit("real_data_train", mode=mode, **run, stored_targets_equal=stored,
                 grads_vs_plain=check, timings=trainer.timings)
            if not (run["ok"] and all(stored.values()) and check["ok"]):
                fail(f"real_data 8dir_kl {mode}: launches {launches} (expected "
                     f"{run['expected_launches']}), stored targets {stored}, gradient of "
                     f"{check['worst']} {check['norm_rel_err']}, PLYs {run['pred_plys']} "
                     f"{run['pred_ply_shapes']}, summary tail {tail}")
            out["launches"][f"plygt 8dir_kl {mode}"] = launches

            # the plygt step beside the synthetic step at the same shape, in turns
            synth = Trainer(preset("8dir_kl", epochs=1), train[mode]["trainer"].dataset,
                            device=dev, fused_mlp_train=fused)
            turns = [(which, step_times(trainer if which == "plygt" else synth,
                                        f"real_data {which} {mode}")["ms_median"])
                     for which in REAL_STEP_TURNS]
            emit("timing_real_data_step", mode=mode, batch=16, num_points=TRAIN_N,
                 turns_ms=turns, plygt_ms=[t for w, t in turns if w == "plygt"],
                 synthetic_ms=[t for w, t in turns if w == "synthetic"])
            out[f"step {mode}"] = turns

        mvm_dir = os.path.join(d, "mvm")
        K.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            trainer, test_acc = run_single(preset("mvm", epochs=1, rotation_mode="none"), ds,
                                           mvm_dir, str(dev))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        # the prediction PLYs' request, and the polar plots' where matplotlib imports
        evals = (batches_of(trainer.val_ds, 16) + batches_of(trainer.test_ds, 16) + 1
                 + int(have_matplotlib()))
        run = check_run("mvm", mvm_dir, trainer, test_acc, launches,
                        knn_trunk_launches(batches_of(trainer.train_ds, 16), evals, False))
        with open(os.path.join(mvm_dir, "results.txt")) as f:
            results = f.read().splitlines()
        run["ok"] &= (results[0] == "=== Multi-Peak von Mises KL Summary ==="
                      and len(results) == 6 + len(trainer.class_names))
        emit("real_data_mvm", **run, results_txt=results)
        if not run["ok"]:
            fail(f"real_data mvm: launches {launches} (expected {run['expected_launches']}), "
                 f"losses {run['step_losses']}, results.txt {results}")
        out["launches"]["plygt mvm"] = launches

        fastply.reset_parser_counts()
        cls_ds = load_dataset(f"ply:{canonical}", CLS_TRAIN_N)
        cls_parsers = fastply.parser_counts()
        cls_dir = os.path.join(d, "cls")
        K.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            trainer, test_acc = run_single(cls_train_config(), cls_ds, cls_dir, str(dev))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        steps = batches_of(trainer.train_ds, 16)
        forwards = steps + batches_of(trainer.val_ds, 16) + batches_of(trainer.test_ds, 16)
        expected = expected_launches(fps=2 * forwards, ball_query=2 * forwards,
                                     sa_mlp_max=3 * (forwards - steps))
        finite = (all(math.isfinite(v) for v in trainer.step_losses)
                  and math.isfinite(test_acc.mean_loss))
        ok = (finite and launches == expected and cls_parsers == {"native": len(files), "numpy": 0}
              and cls_ds.points.shape == (len(files), CLS_TRAIN_N, 3) and cls_ds.targets is None
              and not os.path.exists(os.path.join(cls_dir, "pred_ply")))
        emit("real_data_cls", data="ply", batch=16, num_points=CLS_TRAIN_N, parsers=cls_parsers,
             step_losses=trainer.step_losses, test_loss=test_acc.mean_loss, launches=launches,
             expected_launches=expected, ok=ok)
        if not ok:
            fail(f"real_data classifier: launches {launches} (expected {expected}), parsers "
                 f"{cls_parsers}, losses {trainer.step_losses}")
        out["launches"]["ply classifier"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit("real_data_done", seconds=out["seconds"])
    return out


TTA_B, TTA_N = 64, 1024
# (case, model, views, predictor options): every head family the JAX
# predictor votes for, 8-dir at V=8 in f32 and bf16 (512 views through the
# grouping and MLP kernels), the trunk heads at V=4, the transformer's
# flash forward at V=2
TTA_CASES = (("8dir f32", "pointnet_pp_8dir", 8, {}),
             ("8dir bf16", "pointnet_pp_8dir", 8, {"dtype": "bfloat16"}),
             ("fwd", "pointnet_pp_fwd", 4, {}),
             ("xyz_schmidt", "pointnet_pp_xyz_schmidt", 4, {}),
             ("von_mises", "pointnet_pp_von_mises", 4, {}),
             ("mvm", "pointnet_pp_mvm", 4, {}),
             ("transformer flash", "point_transformer", 2, {"attention_impl": "flash"}))
# the int8 envelope of tests/test_quantize.py: per-direction probabilities
# and decoded forward vectors against the f32 predictor
INT8_PROB_TOL, INT8_DEG_TOL = 0.01, 2.5
# PointNet: served (model, B, N) and trained (name, B, N); the card's
# outputs and a step's gradients against the port on the CPU, same weights
PN_SERVE = (("pointnet_cls", 64, 1024), ("pointnet", 16, TRAIN_N))
PN_TRAIN = (("simple_pointnet", 16, TRAIN_N), ("pointnet_cls", 16, CLS_TRAIN_N))
PN_TOL = 1e-4  # f32 cuBLAS products (TF32 off) against the CPU's, in another order


def tta_tol(case: str) -> float:
    if case.startswith("transformer"):
        return PT_TOL["float32"]
    return BF16_LOGIT_TOL if "bf16" in case else LOGIT_TOL


def tta_expected(case: str) -> dict:
    """One model call a request, whatever V: the launches of one request."""
    if case.startswith("transformer"):
        return expected_launches(flash_attention_fwd=PT_DEPTH)
    mlp = "sa_mlp_max_bf16" if "bf16" in case else "sa_mlp_max"
    return expected_launches(sa_group=2, **{mlp: 3})


def vm_moment(mu, kappa) -> np.ndarray:
    """The first circular moment ``A(kappa) e^{i mu}`` (f64, on the host)."""
    a = TVM.bessel_ratio(torch.as_tensor(np.asarray(kappa, np.float64))).numpy()
    return np.stack([a * np.cos(mu), a * np.sin(mu)], -1)


def combine_views(model: str, outs: list, angles: np.ndarray, rots: np.ndarray):
    """The JAX predictor's combine of V single-view outputs, in numpy: 8-dir
    slot-rolled softmax mean (log); vectors and the two axes derotated
    (``v @ R``) and averaged; vM the mean first moment; MvM the view-major
    mixture of V*K components, weights over V."""
    V = len(outs)
    if model == "pointnet_pp_8dir":
        step = 8 // V
        probs = [np.roll(np.exp(o - o.max(-1, keepdims=True)) /
                         np.exp(o - o.max(-1, keepdims=True)).sum(-1, keepdims=True),
                         i * step, axis=-1) for i, o in enumerate(outs)]
        return np.log(np.mean(probs, 0) + 1e-12)
    if model == "pointnet_pp_von_mises":
        return np.mean([vm_moment(mu + angles[i], kappa) for i, (mu, kappa) in enumerate(outs)],
                       0)
    if model == "pointnet_pp_mvm":
        mu = np.stack([np.mod(o[0] + angles[i] + np.pi, 2 * np.pi) - np.pi
                       for i, o in enumerate(outs)], 1)
        kappa, w = (np.stack([o[j] for o in outs], 1) for j in (1, 2))
        b = mu.shape[0]
        return mu.reshape(b, -1), kappa.reshape(b, -1), w.reshape(b, -1) / V
    if model == "pointnet_pp_xyz_schmidt":
        return tuple(np.mean([o[j] @ rots[i] for i, o in enumerate(outs)], 0) for j in (0, 1))
    return np.mean([o @ rots[i] for i, o in enumerate(outs)], 0)


def tta_diff(model: str, got, want) -> float:
    """Largest difference: the vM head's by its first moment, the MvM
    head's mu wrapped."""
    if model == "pointnet_pp_von_mises":
        got = vm_moment(*got)
        want = vm_moment(*want) if isinstance(want, tuple) else want
    if model == "pointnet_pp_mvm":
        d = np.mod(got[0] - want[0] + np.pi, 2 * np.pi) - np.pi
        return max(float(np.abs(d).max()), max_abs(got[1:], want[1:]))
    return max_abs(got, want)


def phase_serve_tta(dev) -> dict:
    """Yaw-voting TTA on the card, B=64 N=1,024, random weights from the seed,
    ``sampling="first"`` on the trunk heads. Each family's request: counters
    from 0 around it, exactly one request's launches (one model call on the
    ``(V*B, N, 3)`` views, through the kernels, none on a plain version);
    the request through the plain versions; and its own combine of V
    single-view requests on the same views (``infer.rotate_views`` on the
    card), combined in numpy."""
    x = so3_clouds(TTA_B, TTA_N, SEED + 61)
    rows, launches, preds = [], {}, {}
    for case, model, views, opts in TTA_CASES:
        v = random_flax_variables(SEED, model)
        kw = dict(num_points=TTA_N, max_batch=TTA_B, seed=SEED, device=dev, **opts)
        if model != "point_transformer":
            kw["sampling"] = "first"
        pred = OrientationPredictor(model, v["params"], v["batch_stats"] or None,
                                    tta_views=views, **kw)
        single = OrientationPredictor(model, v["params"], v["batch_stats"] or None, **kw)
        K.reset_launch_counts()
        got = pred(x)
        torch.cuda.synchronize()
        n = K.launch_counts()
        plain_patch = (FLASH_PLAIN if model == "point_transformer" else
                       {"sa_group": K.sa_group_plain, "sa_mlp_max": K.sa_mlp_max_plain})
        with mock.patch.multiple(K, **plain_patch):
            plain = pred(x)
        stacked = infer.rotate_views(torch.from_numpy(x).to(dev), pred._rots).cpu().numpy()
        outs = [single(stacked[i * TTA_B:(i + 1) * TTA_B]) for i in range(views)]
        want = combine_views(model, outs, pred._angles.cpu().numpy(), pred._rots.cpu().numpy())
        tol = tta_tol(case)
        vs_plain, vs_views = tta_diff(model, got, plain), tta_diff(model, got, want)
        outs_ok = all(np.isfinite(o).all() and o.shape[0] == TTA_B for o in as_tuple(got))
        if model == "pointnet_pp_mvm":
            outs_ok = outs_ok and got[0].shape == (TTA_B, 4 * views) and bool(
                np.abs(got[2].sum(-1) - 1).max() <= UNIT_TOL)
        ok = (n == tta_expected(case) and outs_ok and vs_plain <= tol and vs_views <= tol)
        rows.append({"case": case, "model": model, "views": views, "B": TTA_B, "N": TTA_N,
                     "view_batch": views * TTA_B, "launches": n,
                     "expected_launches": tta_expected(case), "max_abs_err_vs_plain": vs_plain,
                     "max_abs_diff_vs_single_views": vs_views, "tol": tol, "ok": ok})
        if not ok:
            fail(f"serve_tta {case}: launches {n} (expected {tta_expected(case)}), {vs_plain} "
                 f"from the plain versions, {vs_views} from {views} single-view requests "
                 f"(tol {tol}), outputs ok {outs_ok}")
        launches[case] = n
        preds[case] = (pred, single)
    emit("serve_tta", requests=rows)
    return {"launches": launches, "predictors": preds, "clouds": x}


def phase_serve_int8(dev) -> dict:
    """int8 weight-only serving of ``pointnet_pp_8dir`` at B=64 N=1,024 from an
    ``.npz`` this phase writes with ``save_quantized_checkpoint``: the int8
    kernels and scales on the card, dequantized there each request; its
    launches (one request's), the request through the plain versions, the
    envelope against the f32 predictor on synthetic clouds, and the weight
    bytes on the card against f32."""
    v = random_flax_variables(SEED)
    xyz, _, _ = synthetic_modelnet(seed=SEED + 67, num_points=TTA_N,
                                   samples_per_class=-(-TTA_B // 6))
    x = np.ascontiguousarray(xyz[:TTA_B], np.float32)
    kw = dict(num_points=TTA_N, max_batch=TTA_B, seed=SEED, device=dev, sampling="first")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pointnet_pp_8dir_int8.npz")
        save_quantized_checkpoint(path, v["params"], v["batch_stats"])
        npz_bytes = os.path.getsize(path)
        p8 = OrientationPredictor.from_quantized_checkpoint(path, "pointnet_pp_8dir", **kw)
    p32 = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"], **kw)
    K.reset_launch_counts()
    got = p8(x)
    torch.cuda.synchronize()
    n = K.launch_counts()
    with mock.patch.multiple(K, sa_group=K.sa_group_plain, sa_mlp_max=K.sa_mlp_max_plain):
        plain = p8(x)
    ref = p32(x)

    def softmax(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    prob_dev = float(np.abs(softmax(got) - softmax(ref)).max())
    cos = np.clip(np.sum(p8.forward_vectors(x) * p32.forward_vectors(x), -1), -1.0, 1.0)
    deg_dev = float(np.degrees(np.arccos(cos)).max())
    b8, b32 = p8.param_bytes(), p32.param_bytes()
    quantized_f32 = b32["module"] - b8["module"]
    vs_plain = float(np.abs(got - plain).max())
    ok = (n == expected_launches(sa_group=2, sa_mlp_max=3) and np.isfinite(got).all()
          and vs_plain <= LOGIT_TOL and prob_dev < INT8_PROB_TOL and deg_dev < INT8_DEG_TOL
          and b8["int8"] * 4 == quantized_f32)
    emit("serve_int8", model="pointnet_pp_8dir", B=TTA_B, N=TTA_N, launches=n,
         max_abs_err_vs_plain=vs_plain, tol=LOGIT_TOL, prob_max_dev_vs_f32=prob_dev,
         prob_tol=INT8_PROB_TOL, deg_max_dev_vs_f32=deg_dev, deg_tol=INT8_DEG_TOL,
         bytes_on_card_int8=b8, bytes_on_card_f32=b32,
         quantized_leaves_f32_bytes=quantized_f32,
         quantized_leaves_shrink=quantized_f32 / max(b8["int8"] + b8["scales"], 1),
         total_shrink=sum(b32.values()) / max(sum(b8.values()), 1), npz_bytes=npz_bytes, ok=ok)
    if not ok:
        fail(f"serve_int8: launches {n}, {vs_plain} from the plain versions, probabilities "
             f"{prob_dev} and {deg_dev} deg from f32, bytes {b8} vs {b32}")
    return {"launches": n, "p8": p8, "p32": p32, "clouds": x}


def pn_step(trainer, batch, valid, masks) -> tuple:
    """One train step of ``trainer`` on ``batch`` with the dropout keep masks
    given (drawn on the host, the same on both devices): loss and gradients
    by parameter name."""
    queue = [m.to(trainer.device) for m in masks]

    def fed(x, p, generator):
        return torch.where(queue.pop(0), x / (1.0 - p), torch.zeros_like(x))

    dev_batch = {k: t.to(trainer.device) for k, t in batch.items()}
    with mock.patch.object(LAYERS, "dropout", fed):
        loss = trainer.train_step(dev_batch, valid.to(trainer.device), None)["loss"]
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    return float(loss), grads


def pn_trainer(name: str, b: int, n: int, dev) -> Trainer:
    """The ``simple_pointnet`` preset, or ``pointnet_cls`` under
    ``classification``, at (b, n), on 48 synthetic clouds (3 train steps
    and 1 val batch): the same flax initialisation on any device."""
    if name == "simple_pointnet":
        cfg = preset("simple_pointnet", batch_size=b, num_points=n, epochs=1)
        ds = OrientationDataset(*synthetic_modelnet(num_points=n, samples_per_class=48,
                                                    class_names=["chair"]))
    else:
        cfg = TrainConfig(task="classification", model="pointnet_cls", batch_size=b,
                          num_points=n, epochs=1)
        ds = OrientationDataset(*synthetic_modelnet(num_points=n, samples_per_class=8))
    return Trainer(cfg, ds, device=str(dev))


def phase_pointnet(dev) -> dict:
    """The PointNet backbones on the card (cuBLAS products with TF32 off;
    none of the port's kernels, so every counter stays 0): ``pointnet_cls``
    served at B=64 N=1,024 and ``pointnet`` (feature transform) at B=16
    N=10,000, each against the port on the CPU with the same weights; the
    ``simple_pointnet`` preset at B=16 N=10,000 and ``pointnet_cls`` under
    ``classification`` at B=16 N=1,024: a step on the card against the same
    step on the CPU in float64 (same initial weights, batch and dropout
    masks): the loss, and every gradient leaf under ``utils/grad_check.py``'s
    rule, its shift leaves held absolutely, within ``GRAD_TOL["default"]``
    or three times the CPU's own float32 step's distance from float64,
    whichever is larger (the feature transform's products make PointNetCls's
    float32 gradients far less exact than a PointNet++ step's); then an
    epoch (3 steps and a val batch), and the step timed."""
    rows, timing, launches = [], {}, {}
    for name, b, n in PN_SERVE:
        v = random_flax_variables(SEED, name)
        x = so3_clouds(b, n, SEED + 71)
        card = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=n,
                                    max_batch=b, seed=SEED, device=dev)
        cpu = OrientationPredictor(name, v["params"], v["batch_stats"], num_points=n,
                                   max_batch=b, seed=SEED, device="cpu")
        K.reset_launch_counts()
        got = card(x)
        torch.cuda.synchronize()
        launches[f"serve {name}"] = K.launch_counts()
        want = cpu(x)
        err = max_abs(got, want)
        close = all(np.allclose(g, w, rtol=PN_TOL, atol=PN_TOL)
                    for g, w in zip(as_tuple(got), as_tuple(want)))
        ok = close and launches[f"serve {name}"] == expected_launches() and all(
            np.isfinite(g).all() for g in as_tuple(got))
        timing[f"serve {name} B={b} N={n}"] = request_latency(card, x)
        rows.append({"what": f"serve {name}", "B": b, "N": n, "max_abs_diff_vs_cpu": err,
                     "scale": max(float(np.abs(w).max()) for w in as_tuple(want)),
                     "shapes": [list(g.shape) for g in as_tuple(got)], "tol": PN_TOL, "ok": ok})
        emit("pointnet_check", **rows[-1])
        if not ok:
            fail(f"pointnet serve {name}: {err} from the CPU (tol {PN_TOL}), launches "
                 f"{launches[f'serve {name}']}")
    for name, b, n in PN_TRAIN:
        card, cpu, cpu64 = (pn_trainer(name, b, n, d) for d in (dev, "cpu", "cpu"))
        cpu64.model.double()
        ds = card.train_ds
        idx, valid, _ = next(ds.batches(b))
        batch, valid, _ = card.device_batch(ds, idx, valid, card.generator(0, 1, 0))
        batch = {"points": batch["points"].cpu(), **({"labels": batch["labels"].cpu()}
                 if name == "pointnet_cls" else {"axes": batch["axes"].cpu()})}
        width = 128 if name == "simple_pointnet" else 256
        masks = [torch.rand((b, width), generator=torch.Generator().manual_seed(SEED + 73))
                 < 1.0 - card.model.P_DROP]
        K.reset_launch_counts()
        loss, grads = pn_step(card, batch, valid, masks)
        torch.cuda.synchronize()
        step_launches = K.launch_counts()
        cpu_loss, cpu_grads = pn_step(cpu, batch, valid, masks)
        loss64, grads64 = pn_step(cpu64, {k: t.double() if t.is_floating_point() else t
                                          for k, t in batch.items()}, valid.double(), masks)
        grads64 = {k: g.float() for k, g in grads64.items()}
        rule = dict(skip=GC.zero_gradient_leaves(card.model),
                    shifts=GC.group_all_shift_leaves(card.model), premise=True)
        own = GC.compare_grads(cpu_grads, grads64, GRAD_TOL["default"], **rule)
        tol = max(GRAD_TOL["default"], 3 * own["norm_rel_err"])
        cmp = GC.compare_grads(grads, grads64, tol, **rule)
        vs_cpu32 = GC.compare_grads(grads, cpu_grads, tol, **rule)
        loss_err = abs(loss - loss64) / max(abs(loss64), 1e-30)
        K.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            hist = card.fit(log_every=0)
        torch.cuda.synchronize()
        epoch_launches = K.launch_counts()
        finite = all(math.isfinite(x) for x in card.step_losses + hist["val"])
        ok = (cmp["ok"] and loss_err <= PN_TOL and finite and step_launches == expected_launches()
              and epoch_launches == expected_launches()
              and len(card.step_losses) == batches_of(card.train_ds, b))
        timing[f"train {name} B={b} N={n}"] = step_times(card, f"pointnet train {name}")
        launches[f"train {name}"] = epoch_launches
        rows.append({"what": f"train {name}", "B": b, "N": n, "loss": loss, "loss_cpu_f32":
                     cpu_loss, "loss_cpu_f64": loss64, "loss_rel_err_vs_f64": loss_err,
                     "grads_vs_cpu_f64": cmp, "cpu_f32_grads_vs_cpu_f64": own,
                     "grads_vs_cpu_f32": {k: vs_cpu32[k] for k in ("worst", "norm_rel_err",
                                                                    "median_norm_rel_err")},
                     "step_losses": card.step_losses, "val_loss": hist["val"][0], "ok": ok})
        emit("pointnet_check", **rows[-1])
        if not ok:
            fail(f"pointnet train {name}: loss {loss} vs {loss64} in f64 on the CPU, grads "
                 f"{cmp}, finite {finite}, launches {step_launches} / {epoch_launches}")
    emit("pointnet", checks=[r["what"] for r in rows], launches=launches)
    return {"timing": timing, "launches": launches}


def phase_timing_serving(dev, card: str, tta: dict, int8: dict, pn: dict) -> None:
    """Requests in turns on one card: 8-dir at V=1 and V=8 (f32, B=64
    N=1,024; the same weights), int8 against f32, and the PointNet requests
    and steps (``phase_pointnet``); host clock around whole requests; with
    the card's name and power limit (``card``, nvidia-smi's)."""
    pred8, single = tta["predictors"]["8dir f32"]
    x = tta["clouds"]
    rows = {}
    for turn in range(2):
        rows[f"8dir V=1 turn {turn}"] = request_latency(single, x)
        rows[f"8dir V=8 turn {turn}"] = request_latency(pred8, x)
        rows[f"8dir f32 turn {turn}"] = request_latency(int8["p32"], int8["clouds"])
        rows[f"8dir int8 turn {turn}"] = request_latency(int8["p8"], int8["clouds"])
    emit("timing_serving", device=card, requests=rows, pointnet=pn["timing"])



# The protocols slice: the Trainer's other paths, the lockstep protocols and
# ensemble serving, at full width on PointNetPP8Dir (8dir_kl, f32, B=16,
# N=1,024) on synthetic clouds, and gradient accumulation on the point
# transformer's flash backend.
PR_N = 1024
PR_EPOCHS = 3
PR_SEEDS = (1, 2, 3)
PR_PER_LABEL = (("chair", 24), ("bottle", 40))  # train splits of 16 and 28: 1 and 2 steps
ENS_B, ENS_S = 64, 3
ENS_TOL = {"pointnet_pp_8dir": 1e-6, "pointnet_pp_von_mises": 1e-6, "pointnet_pp_mvm": 1e-5}
ACCUM_MICRO = 4
ACCUM_TOL = 1e-5  # relative in norm, leaf by leaf


def protocol_cfg(**kw):
    return preset("8dir_kl", **{"num_points": PR_N, "epochs": PR_EPOCHS, **kw})


def protocol_dataset() -> OrientationDataset:
    return OrientationDataset(*synthetic_modelnet(num_points=PR_N, samples_per_class=8))


def per_label_dataset() -> OrientationDataset:
    """Two labels of unequal size (24 chairs, 40 bottles)."""
    ds = OrientationDataset(*synthetic_modelnet(num_points=PR_N, samples_per_class=40,
                                                class_names=[c for c, _ in PR_PER_LABEL]))
    keep = np.ones(len(ds), bool)
    for label, n in PR_PER_LABEL:
        keep[np.nonzero(ds.labels == ds.class_names.index(label))[0][n:]] = False
    return ds.subset(np.nonzero(keep)[0])


def trainer_state(trainer) -> tuple:
    """Weights and statistics, optimizer state and step, on the host."""
    opt = trainer.optimizer.state_dict()["state"]
    return ({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.detach().cpu().clone() for k, v in s.items()} for i, s in opt.items()},
            trainer.step)


def same_state(a: tuple, b: tuple) -> bool:
    return (a[2] == b[2] and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(a[1][i][k], b[1][i][k]) for i in a[1] for k in a[1][i]))


def same_record(a, b) -> bool:
    """Equal, NaN equal to NaN (an uniform class has no angular error)."""
    try:
        np.testing.assert_equal(a, b)
    except AssertionError:
        return False
    return True


def same_tree(a, b) -> bool:
    """Two nested dicts of arrays with the same keys and equal arrays, bit
    for bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    return np.array_equal(np.asarray(a), np.asarray(b))


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def requesting_after(trainer, epoch: int, guard):
    """Make ``guard.request()`` fire once ``trainer`` finishes ``epoch``: the
    signal a preempted job gets, at a known point."""
    run_epoch = trainer.run_epoch

    def wrapped(e):
        out = run_epoch(e)
        if e == epoch:
            guard.request()
        return out

    trainer.run_epoch = wrapped


def sequential_run(cfg, ds, dev) -> tuple:
    """A plain ``Trainer`` run of ``cfg`` with its test pass: (trainer, test
    accumulator, launches)."""
    t = Trainer(cfg, ds, device=dev)
    K.reset_launch_counts()
    t.fit(log_every=0)
    test = t.test()
    torch.cuda.synchronize()
    return t, test, K.launch_counts()


def phase_protocols(dev) -> dict:
    """The Trainer's other paths and the protocols on the card (8dir_kl, f32,
    B=16, N=1,024, synthetic clouds), every check failing the run:

    * ``schedule``: the cosine schedule with a warmup epoch under Adam and
      under SGD: every step's learning rate equals the port's schedule
      function at the count before it, finite losses, exact launches;
    * ``preemption``: ``checkpoint_every=1``, asynchronous writes, a
      ``PreemptionGuard`` requested after epoch 2. ``epoch_1.pt`` is
      written by the writer thread alone (the preemption save drains it and
      rewrites ``epoch_2.pt`` in the caller's thread, as the JAX ``fit``
      does); both files byte for byte the uninterrupted run's synchronous
      saves. Resumed from the asynchronous ``epoch_1.pt`` to epoch 4: the
      history, weights, statistics and optimizer state bit-equal to the
      uninterrupted run (the path has no float atomics: ``sa_scatter``
      sorts);
    * ``per_label``: two labels of unequal size (1 and 2 steps an epoch) in
      lockstep, each label's results bit-equal to its own sequential run,
      the launches the sum of theirs;
    * ``multi_seed``: three seeds preempted after epoch 2 and resumed from
      the protocol checkpoint, each seed's results and returned best-val
      weights bit-equal to its sequential run's, the resumed run's
      launches those of its last epoch and test pass for each seed;
    * ``ensembles``: 8-dir from that checkpoint
      (``from_protocol_checkpoint``), vM and MvM from ``from_seed_sweep``
      over random flax weights, S=3, B=64 N=1,024: each request equal to
      the host's combine of its S single members' outputs, its launches S
      times a single request's;
    * ``accumulation``: ``make_accum_train_step`` on the point transformer
      with flash attention, B=16, 4 microbatches: its gradient against the
      whole-batch step's within 1e-5 relative in norm, leaf by leaf (the
      key biases, zero in exact arithmetic, held absolutely), exact
      launches."""
    out = {"launches": {}}
    ds = protocol_dataset()
    steps = val = None

    for opt in ("adam", "sgd"):
        cfg = protocol_cfg(lr_schedule="cosine", warmup_epochs=1, optimizer=opt)
        t = Trainer(cfg, ds, device=dev)
        steps, val = batches_of(t.train_ds, 16), batches_of(t.val_ds, 16)
        seen = []
        real = t.optimizer.step

        def stepping(*a, _seen=seen, _real=real, _t=t, **k):
            _seen.append(_t.optimizer.param_groups[0]["lr"])
            return _real(*a, **k)

        t.optimizer.step = stepping
        K.reset_launch_counts()
        hist = t.fit(log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expected = knn_trunk_launches(steps * PR_EPOCHS, val * PR_EPOCHS, False)
        want = [t.lr_schedule(i) for i in range(steps * PR_EPOCHS)]
        ok = (seen == want and seen[0] == 0.0 and max(seen) == cfg.lr and launches == expected
              and isinstance(t.optimizer, torch.optim.SGD if opt == "sgd" else torch.optim.Adam)
              and all(math.isfinite(x) for x in hist["train"] + hist["val"] + t.step_losses))
        emit("protocols_schedule", optimizer=opt, lrs=seen, train=hist["train"], val=hist["val"],
             launches=launches, expected_launches=expected, ok=ok)
        if not ok:
            fail(f"protocols schedule {opt}: lrs {seen} (schedule {want}), launches {launches} "
                 f"(expected {expected}), history {hist}")
        out["launches"][f"schedule {opt}"] = launches

    cfg = protocol_cfg(epochs=4, checkpoint_every=1, async_checkpoint=True)
    writes = []
    write = TR.write_torch_file

    def recording(payload, path):
        writes.append((os.path.basename(path), threading.current_thread().name))
        write(payload, path)

    with tempfile.TemporaryDirectory() as d, \
            mock.patch.object(TR, "write_torch_file", recording):
        full = Trainer(cfg.replace(async_checkpoint=False), ds, device=dev)
        full.fit(log_every=0, checkpoint_dir=os.path.join(d, "full"))
        writes.clear()
        run = Trainer(cfg, ds, device=dev)
        ckpt = os.path.join(d, "run")
        with PreemptionGuard() as guard:
            requesting_after(run, 2, guard)
            K.reset_launch_counts()
            with contextlib.redirect_stdout(sys.stderr):
                run.fit(log_every=0, checkpoint_dir=ckpt, preemption_guard=guard)
        async_file = [(f, name.startswith("checkpoint")) for f, name in writes] == [
            ("epoch_1.pt", True), ("epoch_2.pt", True), ("epoch_2.pt", False)]
        same_bytes = {}
        for f in ("epoch_1.pt", "epoch_2.pt"):
            with open(os.path.join(ckpt, f), "rb") as a, \
                    open(os.path.join(d, "full", f), "rb") as b:
                same_bytes[f] = a.read() == b.read()
        files = sorted(os.listdir(ckpt))
        resumed = Trainer(cfg, ds, device=dev)
        resumed.restore_checkpoint(os.path.join(ckpt, "epoch_1.pt"))
        resumed.fit(start_epoch=2, log_every=0)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    history_equal = resumed.history == full.history
    state_equal = same_state(trainer_state(resumed), trainer_state(full))
    ok = (async_file and all(same_bytes.values()) and files == ["epoch_1.pt", "epoch_2.pt"]
          and len(run.history["val"]) == 2 and history_equal and state_equal
          and launches == knn_trunk_launches(steps * 5, val * 5, False))
    emit("protocols_preemption", stopped_after=run.epoch, files=files, writes=writes,
         resumed_from="epoch_1.pt", bytes_equal_uninterrupted_sync=same_bytes,
         history_equal=history_equal, state_equal=state_equal,
         val=resumed.history["val"], launches=launches, ok=ok)
    if not ok:
        fail(f"protocols preemption: writes {writes}, bytes equal {same_bytes}, files {files}, "
             f"history {resumed.history} vs {full.history}, state equal {state_equal}, "
             f"launches {launches}")
    out["launches"]["preempt and resume"] = launches

    lds = per_label_dataset()
    cfg = protocol_cfg(classes=tuple(c for c, _ in PR_PER_LABEL))
    seq, seq_launches = {}, {}
    for label, _ in PR_PER_LABEL:
        t, test, n = sequential_run(cfg.replace(classes=(label,), per_label=False),
                                    lds.select_classes([label]), dev)
        seq[label] = (t, test)
        seq_launches = add_launches(seq_launches, n)
    K.reset_launch_counts()
    res = run_per_label_vmapped(cfg, lds, log_every=0, device=str(dev))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rows = {}
    for label, (t, test) in seq.items():
        rows[label] = {"steps_an_epoch": batches_of(t.train_ds, 16),
                       "equal": same_record(res[label]["history"], t.history)
                       and res[label]["best_val"] == t.best_val
                       and res[label]["test_loss"] == test.mean_loss,
                       "val": res[label]["history"]["val"], "test_loss": res[label]["test_loss"]}
    ok = all(r["equal"] for r in rows.values()) and launches == {
        k: seq_launches.get(k, 0) for k in launches}
    emit("protocols_per_label", labels=rows, launches=launches,
         sequential_launches_summed=seq_launches, ok=ok)
    if not ok:
        fail(f"protocols per_label: {rows}, launches {launches} vs {seq_launches}")
    out["launches"]["per_label lockstep"] = launches

    seq = {s: sequential_run(protocol_cfg(seed=s), ds, dev)[:2] for s in PR_SEEDS}
    resumed_expected = {}
    for t, _ in seq.values():  # epoch 3 of each seed, then its test pass
        resumed_expected = add_launches(resumed_expected, knn_trunk_launches(
            batches_of(t.train_ds, 16) * (PR_EPOCHS - 2),
            batches_of(t.val_ds, 16) * (PR_EPOCHS - 2) + batches_of(t.test_ds, 16), False))
    d = tempfile.mkdtemp()
    out["tmp"] = d
    cfg = protocol_cfg(checkpoint_every=1)
    with PreemptionGuard() as guard:
        real_init = Trainer.__init__
        first = []

        def init(self, *a, **k):
            real_init(self, *a, **k)
            if not first:
                first.append(self)
                requesting_after(self, 2, guard)

        with mock.patch.object(Trainer, "__init__", init), \
                contextlib.redirect_stdout(sys.stderr):
            stopped = run_multi_seed(cfg, ds, list(PR_SEEDS), log_every=0, device=str(dev),
                                     checkpoint_dir=d, preemption_guard=guard)
    step = os.path.join(d, "step_2")
    K.reset_launch_counts()
    res = run_multi_seed(cfg, ds, list(PR_SEEDS), log_every=0, device=str(dev),
                         checkpoint_dir=d, resume_from=step, return_params=True)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rows = {s: {"equal": same_record(res[s]["history"], t.history)
                and res[s]["best_val"] == t.best_val and res[s]["test_loss"] == test.mean_loss,
                "weights_equal": same_tree(
                    {k: res[s][k] for k in ("params", "batch_stats")},
                    to_flax_variables(t.model)),  # both the best-val weights
                "val": res[s]["history"]["val"], "test_loss": res[s]["test_loss"]}
            for s, (t, test) in seq.items()}
    saved = sorted(os.listdir(d))
    resumed_expected = {k: resumed_expected.get(k, 0) for k in launches}
    ok = (stopped is None and saved == ["step_1", "step_2"] and launches == resumed_expected
          and all(r["equal"] and r["weights_equal"] for r in rows.values()))
    emit("protocols_multi_seed", seeds=list(PR_SEEDS), preempted_returned_none=stopped is None,
         saved=saved, seeds_results=rows, launches_resumed=launches,
         expected_launches_resumed=resumed_expected, ok=ok)
    if not ok:
        fail(f"protocols multi_seed: stopped {stopped}, saved {saved}, {rows}, launches "
             f"{launches} vs {resumed_expected}")
    out["launches"]["multi_seed resumed"] = launches
    out["step"] = step

    x = so3_clouds(ENS_B, PR_N, SEED + 81)
    out["ensembles"] = {}
    kw = dict(num_points=PR_N, max_batch=ENS_B, seed=SEED, device=dev)
    for model in ENS_TOL:
        if model == "pointnet_pp_8dir":
            ens = OrientationPredictor.from_protocol_checkpoint(step, model, **kw)
            singles = [OrientationPredictor.from_protocol_checkpoint(step, model, members=[i],
                                                                     **kw)
                       for i in range(ENS_S)]
        else:
            members = []
            for i in range(ENS_S):
                v = random_flax_variables(SEED + 83 + i, model)
                members.append({"params": v["params"], "batch_stats": v["batch_stats"]})
            ens = OrientationPredictor.from_seed_sweep(model, members, **kw)
            singles = [OrientationPredictor.from_seed_sweep(model, [m], **kw) for m in members]
        K.reset_launch_counts()
        got = ens(x)
        torch.cuda.synchronize()
        n_ens = K.launch_counts()
        outs = []
        for p in singles:
            K.reset_launch_counts()
            outs.append(p(x))
            torch.cuda.synchronize()
        n_one = K.launch_counts()
        want = combine_members(model, outs)
        diff = tta_diff(model, got, want)
        finite = all(np.isfinite(o).all() and o.shape[0] == ENS_B for o in as_tuple(got))
        ok = (finite and diff <= ENS_TOL[model] and ens.ensemble_size == ENS_S
              and n_ens == {k: ENS_S * v for k, v in n_one.items()} and any(n_one.values()))
        emit("protocols_ensemble", model=model, members=ENS_S, B=ENS_B, N=PR_N,
             max_abs_diff_vs_host_combine=diff, tol=ENS_TOL[model], launches=n_ens,
             single_member_launches=n_one, ok=ok)
        if not ok:
            fail(f"protocols ensemble {model}: {diff} from the host combine (tol "
                 f"{ENS_TOL[model]}), launches {n_ens} vs {ENS_S} x {n_one}, finite {finite}")
        out["launches"][f"ensemble {model}"] = n_ens
        out["ensembles"][model] = (ens, singles[0])
    out["clouds"] = x

    tds = transformer_dataset(PR_N, 64)
    t = Trainer(preset("point_transformer", transformer_attention="flash"), tds, device=dev)
    idx, valid, _ = next(tds.batches(16))
    batch, _, _ = t.device_batch(tds, idx, valid, t.generator(0, 96, 0))
    xb, target = batch["points"], batch["forward"]
    grads, counts = {}, {}
    for n_micro in (1, ACCUM_MICRO):
        opt = torch.optim.SGD(t.model.parameters(), lr=0.0)  # the weights stay as they are
        step_fn = make_accum_train_step(t.model, opt, n_micro)
        K.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the flash backend's dropout warning
            loss = float(step_fn(xb, target))
        torch.cuda.synchronize()
        counts[n_micro] = K.launch_counts()
        grads[n_micro] = ({n: p.grad.detach().clone() for n, p in t.model.named_parameters()},
                          loss)
    skip = GC.zero_gradient_leaves(t.model)
    worst, worst_name, key_bias = 0.0, None, 0.0
    for name, g in grads[ACCUM_MICRO][0].items():
        w = grads[1][0][name]
        if name in skip:
            key_bias = max(key_bias, float((g - w).abs().max()))
            continue
        err = float((g - w).norm()) / max(float(w.norm()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    expected = {m: expected_launches(flash_attention_fwd=PT_DEPTH * m,
                                     flash_attention_bwd_dkv=PT_DEPTH * m,
                                     flash_attention_bwd_dq=PT_DEPTH * m)
                for m in (1, ACCUM_MICRO)}
    loss_err = abs(grads[ACCUM_MICRO][1] - grads[1][1]) / abs(grads[1][1])
    ok = (worst <= ACCUM_TOL and key_bias <= 1e-6 and loss_err <= ACCUM_TOL
          and counts == expected)
    emit("protocols_accumulation", B=16, N=PR_N, n_micro=ACCUM_MICRO, attention="flash",
         worst_leaf=worst_name, norm_rel_err=worst, tol=ACCUM_TOL, key_bias_max_abs=key_bias,
         loss_rel_err=loss_err, launches=counts, expected_launches=expected, ok=ok)
    if not ok:
        fail(f"protocols accumulation: {worst_name} {worst} (tol {ACCUM_TOL}), key bias "
             f"{key_bias}, loss {loss_err}, launches {counts} vs {expected}")
    out["launches"]["accumulated step"] = counts[ACCUM_MICRO]
    emit("protocols", paths=sorted(out["launches"]), launches=out["launches"])
    return out


def combine_members(model: str, outs: list):
    """The ensemble combine of S single-member outputs, on the host: 8-dir
    the log of the mean softmax; vM the mean first moment; MvM the
    member-major mixture of S*K components, weights over S."""
    if model == "pointnet_pp_8dir":
        probs = [np.exp(o - o.max(-1, keepdims=True)) for o in outs]
        return np.log(np.mean([p / p.sum(-1, keepdims=True) for p in probs], 0) + 1e-12)
    if model == "pointnet_pp_von_mises":
        return np.mean([vm_moment(mu, kappa) for mu, kappa in outs], 0)
    b = outs[0][0].shape[0]
    mu, kappa, w = (np.stack([o[j] for o in outs], 1).reshape(b, -1) for j in range(3))
    return mu, kappa, w / len(outs)


def phase_timing_protocols(dev, card: str, protocols: dict) -> None:
    """Times of the protocols slice, with the card's name and power limit
    (``card``, nvidia-smi's): ensemble requests at S=1 and S=3 (B=64
    N=1,024, in turns); the per-member epoch in lockstep (3 seeds, each
    member's epoch in turn) against one sequential trainer's epoch (8dir_kl,
    B=16 N=1,024, 48 clouds; host clock, synchronised, 3 epochs each after
    one); and the caller's stall of a synchronous checkpoint against an
    asynchronous one (host copy, then the write on a background thread),
    and the background write's own time."""
    x = protocols["clouds"]
    requests = {}
    for model, (ens, single) in protocols["ensembles"].items():
        for turn, (what, p) in enumerate((("S=1", single), ("S=3", ens), ("S=3", ens),
                                          ("S=1", single))):
            requests[f"{model} {what} turn {turn}"] = request_latency(p, x)
    ds = protocol_dataset()
    members = [Trainer(protocol_cfg(seed=s), ds, device=dev) for s in PR_SEEDS]
    alone = Trainer(protocol_cfg(seed=PR_SEEDS[0]), ds, device=dev)

    def epochs(trainers, first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(first, first + 3):
            for tr in trainers:
                tr.run_epoch(e)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    for tr in members + [alone]:
        tr.run_epoch(1)  # warm-up
    lockstep = [epochs(members, 2), epochs(members, 5)]
    sequential = [epochs([alone], 2), epochs([alone], 5)]
    stalls = {"sync_ms": [], "async_ms": [], "async_write_ms": []}
    with tempfile.TemporaryDirectory() as d:
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alone.save_checkpoint(os.path.join(d, f"s{i}"))
            stalls["sync_ms"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alone.save_checkpoint(os.path.join(d, f"a{i}"), asynchronous=True)
            t1 = time.perf_counter()
            alone.wait_for_checkpoints()
            stalls["async_ms"].append((t1 - t0) * 1e3)
            stalls["async_write_ms"].append((time.perf_counter() - t1) * 1e3)
    emit("timing_protocols", device=card, ensemble_requests=requests,
         lockstep_epoch_s_per_member=[v / len(members) for v in lockstep],
         lockstep_epoch_s=lockstep, sequential_epoch_s=sequential, members=len(members),
         checkpoint=stalls, checkpoint_bytes=os.path.getsize(os.path.join(
             protocols["tmp"], "step_2", "carry.pt")) // len(members))
    shutil.rmtree(protocols["tmp"], ignore_errors=True)


def main() -> None:
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    checks = phase_kernels(dev)
    checks.update(phase_kernels_select(dev))
    checks.update(phase_kernels_bwd(dev))
    checks.update(phase_kernels_bf16(dev))
    phase_mlp_recompute(dev)
    checks.update(phase_kernels_vpu_select(dev))
    serve = phase_serve(dev)
    serve_bf16 = phase_serve_bf16(dev)
    cls = phase_serve_cls(dev)
    cls_large = phase_serve_cls_large(dev)
    large = phase_large(dev)
    train = phase_train(dev)
    train_bf16 = phase_train_bf16(dev)
    checks.update(phase_kernels_topk_min(dev))
    serve_grid = phase_serve_grid(dev)
    serve_heads = phase_serve_heads(dev)
    train_heads = phase_train_heads(dev)
    train_cls = phase_train_cls(dev)
    serve_so3 = phase_serve_so3(dev)
    train_so3 = phase_train_so3(dev)
    checks.update(phase_kernels_flash(dev))
    serve_transformer = phase_serve_transformer(dev)
    train_transformer = phase_train_transformer(dev)
    real_data = phase_real_data(dev, train)
    serve_tta = phase_serve_tta(dev)
    serve_int8 = phase_serve_int8(dev)
    pointnet = phase_pointnet(dev)
    protocols = phase_protocols(dev)
    summary = phase_timing(dev, checks, serve)
    summary += phase_timing_train(dev, checks, train)
    summary += phase_timing_select(dev, checks, cls, large)
    summary += phase_timing_bf16(dev, checks, serve_bf16, train_bf16, cls_large)
    summary += phase_timing_grid(dev, checks, serve_grid, serve_heads, train_heads)
    summary += phase_vpu_select(dev, checks)
    phase_timing_train_cls(train_cls)
    phase_timing_so3(serve, serve_bf16, train, serve_so3, train_so3)
    flash_rows = phase_timing_transformer(dev, checks, serve_transformer, train_transformer)
    phase_timing_serving(dev, info["nvidia_smi"], serve_tta, serve_int8, pointnet)
    phase_timing_protocols(dev, info["nvidia_smi"], protocols)
    so3_paths = {**{f"serve {case}": n for case, n in serve_so3["launches"].items()},
                 **{f"train {path}": run["launches"] for path, run in train_so3.items()}}
    for row in summary:  # the classifier's and the SO(3) paths, beside each row's own path
        if row["name"] in CLS_PLAIN:
            row["launches_train_cls"] = {mode: run["launches"][row["name"]]
                                         for mode, run in train_cls.items()}
        so3 = {path: n[row["name"]] for path, n in so3_paths.items() if n.get(row["name"])}
        if so3:
            row["launches_so3"] = so3
        real = {path: n[row["name"]] for path, n in real_data["launches"].items()
                if n.get(row["name"])}
        if real:
            row["launches_real_data"] = real
    for row in summary + flash_rows:  # TTA's and int8's requests, beside each row's own path
        tta = {case: n[row["name"]] for case, n in serve_tta["launches"].items()
               if n.get(row["name"])}
        if tta:
            row["launches_tta"] = tta
        if serve_int8["launches"].get(row["name"]):
            row["launches_int8"] = {"8dir B=64 N=1024": serve_int8["launches"][row["name"]]}
        paths = {path: n[row["name"]] for path, n in protocols["launches"].items()
                 if n.get(row["name"])}
        if paths:
            row["launches_protocols"] = paths
    summary += flash_rows
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": summary,
                      "total_seconds": round(time.perf_counter() - T_START, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
