"""Design measurements behind the port's kernels, on one NVIDIA card.

    python3 chip_sweep.py [select] [mlp] [ball] [scatter] [flash --against FILE]

(no sweep named: the first four). Builds, beside the shipped library, variants of the
shipped sources that differ in one choice each (one nvcc per variant,
started together, into ``build/sweep/``), and times them on the same inputs
in turns:

- ``select``: the selection of ``csrc/sa_group.cu`` and ``csrc/knn.cu``.
  On the same distance tiles (the grouping's shapes: sa1 B=64 N=1024, sa1
  B=16 N=10,000, sa2 B=64 N=128, and the kNN kernel's B=16 N=16,384 and
  N=20,480; S=128 or 32, K=32) the four micro-benchmark selections of
  ``csrc/vpu_select.cu`` (``sel_argmin`` is the K-pass design the grouping
  used before), ``topk_min``'s threshold select, and the shipped
  ``sa_group``/``knn`` kernels on the clouds the tiles come from
  (``sa_group`` also in its block design at every N, without the warp
  design it takes up to N=1,024, and with its warp design held to 3 or 4
  blocks an SM), and the variants of the four selections
  (``vpu_variants``).
- ``mlp``: ``csrc/sa_mlp_max.cu`` with the backward's arithmetic (shipped)
  against the forward before it (the tensor cores' accumulation chained over
  the contraction, ``a * s + t`` contracted to an FMA) and against the
  repair's first form (the f32 step's B fragments split up front): times at
  every forward shape of ``chip_smoke.py``, f32 and bf16, and
  ``chip_smoke.mlp_recompute_check`` on both, the cases where the backward's
  recomputed maximum does not reproduce the pooled value.
- ``ball``: ``csrc/ball_query.cu`` at every ``chip_smoke.BALL_SHAPES``
  shape: the staged path's centroids a block (4, 8 or 32 warps, a
  centroid each) and the 32-point groups a warp tests at once, the split
  scan taken nowhere and everywhere, its warps a block and groups a round.
- ``scatter``: ``csrc/sa_scatter.cu`` at ``chip_smoke.SCATTER_SHAPE``, on
  the grouped cotangent's column slice (row stride 131: scalar loads) and
  on a contiguous cotangent (float4 loads): the slots whose loads are in
  flight together, a cloud's rows over 4 blocks or 16, and scalar loads
  where float4 loads apply.
- ``flash``: the three flash attention kernels of the shipped library
  against those of another ``flash_attention.cu`` given by ``--against``
  (an earlier tree's, unpacked with ``git archive``), built alone: both
  held to the plain versions at every ``chip_smoke.FLASH_SHAPES`` shape,
  f32 and bf16, then timed in turns.

A variant is the shipped source with a few lines replaced by their text, so
it is made only when its sweep runs, and that sweep stops (naming the line)
once the shipped source no longer holds the text. Importing this module
reads no source. Prints one JSON line per measurement, the card's name and
power limit, and ``{"ok": true}`` last. Imports only the port, torch, numpy
and ``chip_smoke``. Exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as CS
from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV
from pointcloud_orientation_tpu_torch.ops import _build, cuda_kernels as K
from pointcloud_orientation_tpu_torch.ops import flash_attention as FA
from pointcloud_orientation_tpu_torch.ops import geometry as G

OUT = _build.BUILD_ROOT.parent / "sweep"
SWEEPS = ("select", "mlp", "ball", "scatter", "flash")
DEFAULT_SWEEPS = SWEEPS[:4]
# sources whose variants build alone: their wrappers call no other entry point
STANDALONE = ("vpu_select.cu", "ball_query.cu", "sa_scatter.cu", "flash_attention.cu")


def patched(text: str, *edits: tuple[str, str]) -> str:
    for old, new in edits:
        if old not in text:
            CS.fail(f"variant edit not found in the shipped source: {old!r}")
        text = text.replace(old, new)
    return text


# sa_mlp_max.cu's f32 step as shipped: B split a column tile at a time, each
# tile's MMAs into a zeroed part added to the sum
SHIPPED_F32_STEP = """#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      unsigned bhi[2], blo[2];
      split_tf32(__float_as_uint(w[nt * 8]), bhi[0], blo[0]);
      split_tf32(__float_as_uint(w[4 * ldw + nt * 8]), bhi[1], blo[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, alo[mt], bhi[0], bhi[1]);
        mma_tf32(part, ahi[mt], blo[0], blo[1]);
        mma_tf32(part, ahi[mt], bhi[0], bhi[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }
    }"""
# every B fragment split up front, as before the repair
SPLIT_B_UP_FRONT = """    unsigned bhi[4][2], blo[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      split_tf32(__float_as_uint(w[nt * 8]), bhi[nt][0], blo[nt][0]);
      split_tf32(__float_as_uint(w[4 * ldw + nt * 8]), bhi[nt][1], blo[nt][1]);
    }
"""


def mlp_variants(fwd: str) -> dict:
    """The forward's variants of the ``mlp`` sweep, from its shipped text."""
    # the repaired arithmetic with every B fragment split up front (the first
    # form of the repair: 84 bytes of spills at 128 registers)
    repair_up_front = patched(fwd, (SHIPPED_F32_STEP, SPLIT_B_UP_FRONT + """#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, alo[mt], bhi[nt][0], bhi[nt][1]);
        mma_tf32(part, ahi[mt], blo[nt][0], blo[nt][1]);
        mma_tf32(part, ahi[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }"""))
    # the forward before its repair: each MMA chaining the tensor cores' own
    # accumulation over the contraction, and y = a * s + t, which nvcc
    # contracts to an FMA (the backward forms it in two roundings)
    old_forward = patched(
        fwd,
        (SHIPPED_F32_STEP, SPLIT_B_UP_FRONT + """#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);"""),
        ("""      for (int mt = 0; mt < 2; ++mt) {  // as the f32 step: a zeroed part, then an f32 add
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, r[mt], b0, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }""",
         "      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], r[mt], b0, b1);"),
        ("affine(a[0], s0, t0)", "a[0] * s0 + t0"), ("affine(a[1], s1, t1)", "a[1] * s1 + t1"),
        ("affine(a[2], s0, t0)", "a[2] * s0 + t0"), ("affine(a[3], s1, t1)", "a[3] * s1 + t1"),
        ("affine(acc[mt][nt][2 * h + j], scj, shj)", "acc[mt][nt][2 * h + j] * scj + shj"))
    return {"old forward": old_forward, "repair, B split up front": repair_up_front}


def group_variants(group: str) -> dict:
    """The grouping's variants of the ``select`` sweep: its block design (one
    block a centroid) at every N, in place of one warp a centroid up to
    N=1,024; and the warp design held to fewer registers, for 3 or 4 blocks
    an SM."""
    out = {"sa_group block design": patched(group, ("constexpr int kWarpMaxN = 1024;",
                                                    "constexpr int kWarpMaxN = 0;"))}
    for blocks in (3, 4):
        out[f"sa_group warp design, {blocks} blocks an SM"] = patched(
            group, ("__launch_bounds__(kThreads)\nsa_group_warp_kernel",
                    f"__launch_bounds__(kThreads, {blocks})\nsa_group_warp_kernel"))
    return out


def vpu_variants(vpu: str) -> dict:
    """The micro-benchmark selections' variants of the ``select`` sweep,
    each named by its kernel first (``build_all`` builds a text that two
    kernels share once). ``count_emit`` and ``radix_count``: R = 1 to 4
    bits of the threshold a count pass over the row (the warp and the block
    designs alike). ``count_emit`` also: R = 1, 3, 4 over the bucket's
    list, the lists' caps halved and doubled, one count chain a candidate
    in place of two (no spill, more registers), and no list (passes over
    the row to the last bit). ``radix_count`` also: the TPU kernel's
    formulation, 31 one-bit passes over the whole row and no list.
    ``sel_mintie``: 1 (a rescan after each win), 2, 3, 4 or 6 least keys a
    thread, in both designs, and ``sel_argmin`` the same and with
    ``sel_mintie``'s two reductions a pass in place of the packed argmin."""
    out = {}
    for bits in (1, 2, 3, 4):
        for kernel in ("count_emit", "radix_count"):
            out[f"{kernel} R={bits}"] = patched(
                vpu, *consts(kEmitBitsWarp=bits, kEmitBitsBlock=bits))
    for bits in (1, 3, 4):
        out[f"count_emit list R={bits}"] = patched(vpu, *consts(kEmitBitsList=bits))
    out["count_emit caps halved"] = patched(vpu, *consts(kEmitCapWarp=32, kEmitCapBlock=256))
    out["count_emit caps doubled"] = patched(vpu, *consts(kEmitCapWarp=128, kEmitCapBlock=1024))
    out["count_emit one count chain"] = patched(
        vpu, ("        c1[j] += x1 < cand[j];", "        c0[j] += x1 < cand[j];"))
    out["count_emit no list"] = patched(
        vpu, ("threshold_passes<R, kRowWarps>(v, K, 0, kCap, s, red);",
              "threshold_passes<R, kRowWarps>(v, K, 0, -1, s, red);"))
    out["radix_count TPU 31 one-bit passes, no list"] = patched(
        vpu, *consts(kEmitBitsWarp=1, kEmitBitsBlock=1),
        ("threshold_passes<R, kRowWarps>(v, K, 0, kCap, s, red);",
         "threshold_passes<R, kRowWarps>(v, K, 0, -1, s, red);"))
    for keep in (1, 2, 3, 4, 6):
        for kernel in ("sel_mintie", "sel_argmin"):
            out[f"{kernel} keep={keep}"] = patched(
                vpu, *consts(kMintieKeepWarp=keep, kMintieKeepBlock=keep))
    out["sel_argmin two reductions"] = patched(
        vpu, ("using ArgminKernels = KPassKernels<true>;",
              "using ArgminKernels = KPassKernels<false>;"))
    return out


def consts(**values) -> list:
    """Edits that give each named ``constexpr int`` its value (the rest of
    the shipped line becomes a comment)."""
    return [(f"constexpr int {name} = ", f"constexpr int {name} = {v}; //")
            for name, v in values.items()]


def ball_variants(ball: str) -> dict:
    """``csrc/ball_query.cu``'s variants of the ``ball`` sweep."""
    split_rule = "if (N > kTileMax && centroids < (long)kSplitCentroidsPerSm * sms) {"
    out = {}
    for cpb in (4, 8, 32):
        out[f"ball staged, {cpb} a block"] = patched(
            ball, *consts(kWarpCentroids=cpb, kStagedThreads=max(512, 32 * cpb)))
    for groups in (2, 4):
        out[f"ball staged, {groups} groups at once"] = patched(
            ball, *consts(kWarpGroups=groups))
    out["ball split nowhere"] = patched(ball, (split_rule, "if (false) {"))
    out["ball split everywhere"] = patched(ball, (split_rule, "if (true) {"))
    for warps in (8, 32):
        out[f"ball split {warps} warps"] = patched(ball, *consts(kSplitWarps=warps))
    for groups in (2, 8):
        out[f"ball split {groups} groups"] = patched(ball, *consts(kSplitGroups=groups))
    out["ball split 32 warps, 2 groups"] = patched(ball, *consts(kSplitWarps=32, kSplitGroups=2))
    return out


def scatter_variants(scatter: str) -> dict:
    """``csrc/sa_scatter.cu``'s variants of the ``scatter`` sweep."""
    out = {}
    for unroll in (1, 2, 8):
        out[f"scatter {unroll} slots in flight"] = patched(scatter, *consts(kUnroll=unroll))
    out["scatter rows over 4 blocks"] = patched(scatter, *consts(kBlocksTarget=64))
    out["scatter rows over 16 blocks"] = patched(
        scatter, *consts(kBlocksTarget=528, kMaxRowGroups=16))
    out["scatter scalar loads"] = patched(
        scatter, ("const int vec4 = row_stride % 4 == 0",
                  "const int vec4 = 0 && row_stride % 4 == 0"))
    return out


def build_all(sweeps, against=None) -> dict:
    """One nvcc for the whole library with each variant of a library source
    the chosen sweeps need, all started together; ``against``: the flash
    sweep's other ``flash_attention.cu``."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    variants = {}  # name -> (file, text)
    if "flash" in sweeps:
        variants["flash against"] = ("flash_attention.cu", against.read_text())
    if "mlp" in sweeps:
        fwd = (_build.CSRC / "sa_mlp_max.cu").read_text()
        variants.update({name: ("sa_mlp_max.cu", text) for name, text in mlp_variants(fwd).items()})
    if "select" in sweeps:
        group = (_build.CSRC / "sa_group.cu").read_text()
        variants.update({name: ("sa_group.cu", text)
                         for name, text in group_variants(group).items()})
        vpu = (_build.CSRC / "vpu_select.cu").read_text()
        variants.update({name: ("vpu_select.cu", text)
                         for name, text in vpu_variants(vpu).items()})
    for sweep, file, make in (("ball", "ball_query.cu", ball_variants),
                              ("scatter", "sa_scatter.cu", scatter_variants)):
        if sweep in sweeps:
            text = (_build.CSRC / file).read_text()
            variants.update({name: (file, t) for name, t in make(text).items()})
    jobs, first = {}, {}  # first: (file, text) -> the variant that builds it
    for name, (file, text) in variants.items():
        if first.setdefault((file, text), name) != name:
            continue  # built once, under its first name
        variant = OUT / name.replace(" ", "_").replace(",", "") / file
        variant.parent.mkdir(parents=True, exist_ok=True)
        variant.write_text(text)
        others = [] if file in STANDALONE else [
            str(p) for p in sorted(_build.CSRC.glob("*.cu")) if p.name != file]
        # csrc/ on the include path: a variant finds the shipped headers there
        jobs[name] = (variant.parent / "lib.so", ["-I", str(_build.CSRC), *others, str(variant)])
    procs = {name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(so), *srcs],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (so, srcs) in jobs.items()}
    _build.load_library()  # the shipped library, meanwhile
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            CS.fail(f"nvcc failed for the variant {name}:\n{log[-4000:]}")
        if variants[name][0] in STANDALONE:
            CS.emit("sweep_build", variant=name, ptxas=_build.ptxas_summary(log))
        cdll = ctypes.CDLL(str(jobs[name][0]))
        for fn_name, argtypes in _build.SIGNATURES.items():
            if hasattr(cdll, fn_name):
                fn = getattr(cdll, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = cdll
    return {name: built[first[variant]] for name, variant in variants.items()}


# (B, S, N, K, D, distance form) of the selection sweep: the grouping's
# (matmul form; D feature channels gathered) and the kNN kernel's
# (difference form)
SELECT_SWEEP = {"sa1 B=64 N=1024": (64, 128, 1024, 32, 0, "matmul"),
                "sa1 B=16 N=10000": (16, 128, 10_000, 32, 0, "matmul"),
                "sa2 B=64 N=128": (64, 32, 128, 32, 128, "matmul"),
                "knn B=16 N=16384": (16, 128, 16_384, 32, 0, "difference"),
                "knn B=16 N=20480": (16, 128, 20_480, 32, 0, "difference")}


def sweep_select(dev, libs) -> None:
    """Each selection on the same distance tile, in turns (two rounds, the
    order reversed in the second), and the shipped grouping or kNN kernel
    on the cloud the tile comes from (the grouping also in its block design
    at every N). Tiles are clamped at 0 (the radix kernels order
    non-negative bit patterns); the threshold select's indices are held
    equal to the K-pass kernel's, and both groupings' to the plain
    version's."""
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 22)
    for name, (b, s, n, k, dim, form) in SELECT_SWEEP.items():
        xyz = CS.unit_cloud(b, n, gen, dev, False)
        feats = torch.randn((b, n, dim), generator=gen, device=dev) if dim else None
        cidx = G.random_sample_indices(gen, b, n, s, dev).to(torch.int32).contiguous()
        new_xyz = G.index_points(xyz, cidx).contiguous()
        distance = G.square_distance if form == "matmul" else G.diff_square_distance
        d = distance(new_xyz, xyz).clamp_min(0.0).contiguous()
        if not torch.equal(K.topk_min(d, k), PV.sel_argmin(d, k).transpose(1, 2)):
            CS.fail(f"select sweep {name}: topk_min and the K argmin passes differ")
        fns = {fn.__name__: (lambda fn=fn: fn(d, k)) for fn in PV.SELECTIONS}
        for label in [v for v in libs if v.split()[0] in {f.__name__ for f in PV.SELECTIONS}]:
            fn = getattr(PV, label.split()[0])

            def variant(fn=fn, lib=libs[label]):
                with mock.patch.object(PV, "load_library", lambda: lib):
                    return fn(d, k)

            if not torch.equal(variant(), fn(d, k)):
                CS.fail(f"select sweep {name}: {label} differs from the shipped kernel")
            fns[label] = variant
        fns["topk_min"] = lambda: K.topk_min(d, k)
        if form == "matmul":
            want = K.sa_group_plain(xyz, feats, cidx, k)[2]
            fns["sa_group (shipped, whole kernel)"] = lambda: K.sa_group(xyz, feats, cidx, k)
            for label in [v for v in libs if v.startswith("sa_group")]:
                def grouping(lib=libs[label]):
                    with mock.patch.object(K, "load_library", lambda: lib):
                        return K.sa_group(xyz, feats, cidx, k)

                fns[f"{label} (whole kernel)"] = grouping
            for label, fn in fns.items():
                if label.startswith("sa_group") and not torch.equal(fn()[2], want):
                    CS.fail(f"select sweep {name}: {label} differs from the plain grouping")
        else:
            fns["knn (shipped, whole kernel)"] = lambda: K.knn(new_xyz, xyz, k)
        ms = {label: [] for label in fns}
        for rnd in range(2):
            for label in (list(fns) if rnd == 0 else list(fns)[::-1]):
                ms[label].append(CS.cuda_ms(fns[label]))
        CS.emit("sweep_select", shape=name, B=b, S=s, N=n, K=k, D=dim, distance_form=form,
                ms=ms)


def sweep_mlp(dev, libs) -> None:
    """The shipped forward against the one before its repair: times at
    every SA_MLP_SHAPES shape, f32 and bf16, in turns (two rounds), then
    the recompute check on each."""
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 23)
    cases = {name: (torch.randn((b, kn, s, w[0]), generator=gen, device=dev),
                    CS.make_layers(w, gen, dev))
             for name, (b, kn, s, w) in CS.SA_MLP_SHAPES.items()}
    variants = {"shipped": _build.load_library(), "old forward": libs["old forward"],
                "repair, B split up front": libs["repair, B split up front"]}
    for rnd in range(2):
        for label in (variants if rnd == 0 else list(variants)[::-1]):
            with mock.patch.object(K, "load_library", lambda lib=variants[label]: lib):
                ms = {f"{name} {'bf16' if bf16 else 'f32'}":
                      CS.cuda_ms(lambda: K.sa_mlp_max(g, layers, bf16=bf16))
                      for name, (g, layers) in cases.items() for bf16 in (False, True)}
            CS.emit("sweep_mlp_ms", forward=label, round=rnd, ms=ms)
    for label in ("shipped", "old forward"):
        with mock.patch.object(K, "load_library", lambda lib=variants[label]: lib):
            for bf16 in (False, True):
                CS.emit("sweep_mlp_recompute", forward=label,
                        dtype="bfloat16" if bf16 else "float32",
                        stages=CS.mlp_recompute_check(dev, bf16))


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Each function's CUDA-event time, ms, in turns: the order reversed
    every other round."""
    ms = {label: [] for label in fns}
    for rnd in range(rounds):
        for label in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            ms[label].append(CS.cuda_ms(fns[label]))
    return ms


def with_library(fn, lib):
    """``fn`` run with ``lib`` in place of the shipped library."""
    def run():
        with mock.patch.object(K, "load_library", lambda: lib):
            return fn()
    return run


def sweep_ball(dev, libs) -> None:
    """The shipped ball query and its variants at every BALL_SHAPES shape
    (random clouds): each index for index equal to the plain version, then
    timed in turns (two rounds)."""
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 24)
    for name, shape in CS.BALL_SHAPES.items():
        args = CS.select_inputs("ball_query", shape, gen, dev, "random")
        want = K.ball_query_plain(*args)
        fns = {"shipped": lambda: K.ball_query(*args)}
        fns.update({label: with_library(lambda: K.ball_query(*args), lib)
                    for label, lib in libs.items() if label.startswith("ball ")})
        for label, fn in fns.items():
            if not torch.equal(fn(), want):
                CS.fail(f"ball sweep {name}: {label} differs from the plain version")
        CS.emit("sweep_ball", shape=name, B=shape[0], S=shape[1], N=shape[2], K=shape[3],
                matmul_form=shape[5], ms=in_turns(fns))


def sweep_scatter(dev, libs) -> None:
    """The shipped scatter and its variants at SCATTER_SHAPE on the
    grouping's indices, on the grouped cotangent's column slice and on a
    contiguous cotangent: every variant bit-equal to the shipped kernel
    (one summation order), the shipped one within 1e-5 of the plain
    version; then timed in turns (two rounds)."""
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 25)
    B, N, S, Kn, D = CS.SCATTER_SHAPE
    xyz, feats, cidx = CS.sa_group_inputs(CS.SCATTER_SHAPE, gen, dev, tiled=False)
    idx = K.sa_group(xyz, feats, cidx, Kn)[2]
    full = torch.randn((B, Kn, S, 3 + D), generator=gen, device=dev)
    for layout, dg in (("column slice, row stride 131", full[..., 3:]),
                       ("contiguous", full[..., 3:].contiguous())):
        shipped = K.sa_group_scatter(idx, dg, N)
        if not torch.allclose(shipped, K.sa_group_scatter_plain(idx, dg, N),
                              rtol=CS.SCATTER_TOL, atol=CS.SCATTER_TOL):
            CS.fail(f"scatter sweep {layout}: the shipped kernel is off the plain version")
        fns = {"shipped": lambda: K.sa_group_scatter(idx, dg, N)}
        fns.update({label: with_library(lambda: K.sa_group_scatter(idx, dg, N), lib)
                    for label, lib in libs.items() if label.startswith("scatter ")})
        for label, fn in fns.items():
            if not torch.equal(fn(), shipped):
                CS.fail(f"scatter sweep {layout}: {label} differs from the shipped kernel")
        CS.emit("sweep_scatter", layout=layout, B=B, N=N, S=S, K=Kn, D=D, ms=in_turns(fns))


def sweep_flash(dev, libs) -> None:
    """The shipped flash kernels and the ``--against`` build's at every
    FLASH_SHAPES shape, f32 and bf16: each kernel of both held to its plain
    version with chip_smoke's gates (o 1e-5 / 1e-2, l and m 1e-5, dK/dV and
    dQ 1e-4 / 2e-2, on the same library's l and m), then timed in turns (two
    rounds), each kernel and the whole backward (dK/dV and dQ); then
    requests and the long-context step through each build."""
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 26)
    builds = {"shipped": _build.load_library(), "against": libs["flash against"]}
    for name, shape in CS.FLASH_SHAPES.items():
        for dname, dtype in CS.FLASH_DTYPES.items():
            q, k, v, do = CS.flash_inputs(shape, dtype, gen, dev)
            scale = 1.0 / shape[-1] ** 0.5
            po, pl, pm = FA.flash_attention_plain(q, k, v, scale)
            fns, errs = {}, {}
            for label, lib in builds.items():
                o, l, m = with_library(lambda: K.flash_attention_fwd(q, k, v, scale), lib)()
                di = FA.row_di(o, do)
                args = (q, k, v, l, m, do, di, scale)
                bwd = [*with_library(lambda: K.flash_attention_bwd_dkv(*args), lib)(),
                       with_library(lambda: K.flash_attention_bwd_dq(*args), lib)()]
                want = [*FA.flash_attention_bwd_dkv_plain(*args),
                        FA.flash_attention_bwd_dq_plain(*args)]
                errs[label] = {"o": CS.flash_errors([o], [po]),
                               "l": float(((l - pl).abs() / pl).max()),
                               "m": float((m - pm).abs().max()) / max(1.0, float(pm.abs().max())),
                               **{n: CS.flash_errors([a], [b])
                                  for n, a, b in zip(("dk", "dv", "dq"), bwd, want)}}
                fwd_tol, bwd_tol = CS.FLASH_TOL[dname], CS.FLASH_BWD_TOL[dname]
                e = errs[label]
                if (e["o"] > fwd_tol or max(e["l"], e["m"]) > 1e-5
                        or max(e["dk"], e["dv"], e["dq"]) > bwd_tol):
                    CS.fail(f"flash sweep {name} {dname}: {label} is off the plain versions: "
                            f"{errs[label]}")
                fns[f"{label} forward"] = with_library(
                    lambda: K.flash_attention_fwd(q, k, v, scale), lib)
                fns[f"{label} dK/dV"] = with_library(
                    lambda args=args: K.flash_attention_bwd_dkv(*args), lib)
                fns[f"{label} dQ"] = with_library(
                    lambda args=args: K.flash_attention_bwd_dq(*args), lib)
                fns[f"{label} backward"] = with_library(
                    lambda args=args: (K.flash_attention_bwd_dkv(*args),
                                       K.flash_attention_bwd_dq(*args)), lib)
            CS.emit("sweep_flash", shape=name, dtype=dname, rel_err=errs, ms=in_turns(fns))
            del q, k, v, do, po, pl, pm, fns
            torch.cuda.empty_cache()
    # end to end, each build in turns (shipped, against, against, shipped):
    # flash requests at B=64 N=1,024 and the long-context step at B=2
    # N=16,384, f32 and bf16
    x = CS.so3_clouds(CS.PT_B, CS.PT_N, CS.SEED + 41)
    order = ("shipped", "against", "against", "shipped")
    for dname in CS.FLASH_DTYPES:
        dtype = None if dname == "float32" else dname
        pred = CS.transformer_predictor(dev, "flash", dtype)
        requests = [(label, with_library(lambda: CS.request_latency(pred, x),
                                         builds[label])()["ms_median"]) for label in order]
        steps = [(label, with_library(lambda: CS.long_step(dev, "flash", CS.PT_LONG[1], dtype),
                                      builds[label])()) for label in order]
        CS.emit("sweep_flash_end_to_end", dtype=dname,
                request_ms={"B": CS.PT_B, "N": CS.PT_N, "turns": requests},
                long_step={"B": CS.PT_LONG[0], "N": CS.PT_LONG[1],
                           "turns": [(label, r.get("ms_median"), r.get("peak_gib"))
                                     for label, r in steps]})
        del pred


def main(argv) -> None:
    against = None
    if "--against" in argv:
        i = argv.index("--against")
        against = Path(argv[i + 1]) if i + 1 < len(argv) else None
        argv = argv[:i] + argv[i + 2:]
    sweeps = argv or DEFAULT_SWEEPS
    if set(sweeps) - set(SWEEPS):
        CS.fail(f"unknown sweeps {sorted(set(sweeps) - set(SWEEPS))}; choose from {SWEEPS}")
    if ("flash" in sweeps) != (against is not None and against.is_file()):
        CS.fail("the flash sweep needs --against FILE, another flash_attention.cu, and only it")
    info = CS.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = build_all(sweeps, against)
    if "select" in sweeps:
        sweep_select(dev, libs)
    if "mlp" in sweeps:
        sweep_mlp(dev, libs)
    if "ball" in sweeps:
        sweep_ball(dev, libs)
    if "scatter" in sweeps:
        sweep_scatter(dev, libs)
    if "flash" in sweeps:
        sweep_flash(dev, libs)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1:])
