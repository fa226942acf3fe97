"""Design measurements behind the FPS and MLP-backward kernels, on one NVIDIA card.

    python3 chip_sweep.py

Builds, beside the shipped library, variants of the shipped sources that
differ in one choice each, and times them on the same inputs in turns:

- ``csrc/fps.cu``'s shape choice: at the classifier's first stage (N=1024,
  B=64) one block of 256 threads a cloud against 128, 64 and 32 threads
  (one warp) a cloud and against a cluster of 2 blocks; at B=16 N=10,000 the
  cluster of 8 against clusters of 1, 2 and 4; at B=2 N=40,000 the cluster
  of 16 against 8. Every variant's indices are held equal to ``fps_plain``.
- ``csrc/sa_mlp_max_bwd.cu``'s accumulation: the shipped kernel (each MMA
  step into a zeroed accumulator, added to the running sum in f32) against
  the MMAs chaining their own accumulation: kernel times at the training
  shapes, the f32 kernel's error against float64 beside the plain f32
  version's, and ``chip_smoke.py``'s per-call check of a fused bf16 train
  step over 12 trajectories (6 seeds, 2 batches each).
- ``cuda_kernels.BWD_CHUNK_BLOCKS``, the blocks the backward's split-K dW
  aims at: 132, 264 and 528.

Prints one JSON line per measurement, the card's name and power limit, and
``{"ok": true}`` last. Imports only the port, torch, numpy and
``chip_smoke``. Exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import torch

import chip_smoke as CS
from pointcloud_orientation_tpu_torch.ops import _build, cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, preset

OUT = _build.BUILD_ROOT.parent / "sweep"
FPS_SRC = (_build.CSRC / "fps.cu").read_text()
BWD_SRC = (_build.CSRC / "sa_mlp_max_bwd.cu").read_text()


def patched(text: str, *edits: tuple[str, str]) -> str:
    for old, new in edits:
        if old not in text:
            CS.fail(f"variant edit not found in the shipped source: {old!r}")
        text = text.replace(old, new)
    return text


def fps_dispatch(line: str) -> tuple[str, str]:
    """The dispatch line for slices of up to 1,024 points, replaced."""
    return ("if (slice <= 1024) return launch_block<4, 256>", f"if (slice <= 1024) return {line}")


def min_slice(n: int) -> tuple[str, str]:
    return ("constexpr int kMinSlice = 1024;", f"constexpr int kMinSlice = {n};")


FPS_VARIANTS = {
    "shipped": FPS_SRC,
    "128 threads": patched(FPS_SRC, fps_dispatch("launch_block<8, 256>")),
    "64 threads": patched(FPS_SRC, fps_dispatch("launch_block<16, 256>")),
    "one warp": patched(FPS_SRC, fps_dispatch("launch_block<32, 256>")),
    "cluster 2 at N=1024": patched(FPS_SRC, min_slice(256)),
    "min slice 2500": patched(FPS_SRC, min_slice(2500)),
    "min slice 5000": patched(FPS_SRC, min_slice(5000)),
    "no cluster below the registers' need": patched(FPS_SRC, min_slice(1 << 29)),
}
# (B, N, npoint) and the variants timed there (the shipped kernel always)
FPS_SWEEP = {
    (64, 1024, 512): ("128 threads", "64 threads", "one warp", "cluster 2 at N=1024"),
    (16, 10000, 512): ("min slice 2500", "min slice 5000", "no cluster below the registers' need"),
    (2, 40000, 512): ("min slice 2500",),
}

CHAINED_BWD = patched(
    BWD_SRC,
    ("float part[4] = {0.f, 0.f, 0.f, 0.f};", "float (&part)[4] = acc[mt][nt];"),
    ("#pragma unroll\n          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];\n", ""))


def build_all() -> dict:
    """One nvcc per FPS variant and one for the whole library with the
    chained backward, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    jobs = {}
    for name, text in FPS_VARIANTS.items():
        src = OUT / f"fps_{len(jobs)}.cu"
        src.write_text(text)
        jobs[name] = (src.with_suffix(".so"), [str(src)])
    chained = OUT / "sa_mlp_max_bwd.cu"
    chained.write_text(CHAINED_BWD)
    others = [str(p) for p in sorted(_build.CSRC.glob("*.cu")) if p.name != "sa_mlp_max_bwd.cu"]
    jobs["chained backward"] = (OUT / "lib_chained.so", others + [str(chained)])
    procs = {name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(so), *srcs],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (so, srcs) in jobs.items()}
    _build.load_library()  # the shipped library, meanwhile
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            CS.fail(f"nvcc failed for the variant {name}:\n{log[-4000:]}")
        cdll = ctypes.CDLL(str(jobs[name][0]))
        for fn_name, argtypes in _build.SIGNATURES.items():
            if hasattr(cdll, fn_name):
                fn = getattr(cdll, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = cdll
    return libs


def fps_call(cdll, xyz, seeds, npoint):
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    err = cdll.pcot_fps_f32(xyz.data_ptr(), seeds.data_ptr(), out.data_ptr(), None, B, N, npoint,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        CS.fail(f"fps variant: CUDA error {err} at {(B, N, npoint)}")
    return out


def sweep_fps(dev, libs) -> None:
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 20)
    for shape, names in FPS_SWEEP.items():
        B, N, npoint = shape
        xyz = CS.unit_cloud(B, N, gen, dev, False)
        seeds = torch.zeros((B,), dtype=torch.int32, device=dev)
        want = K.fps_plain(xyz, seeds, npoint)
        ms = {name: [] for name in ("shipped", *names)}
        for rnd in range(2):  # in turns, the order reversed in the second round
            for name in (list(ms) if rnd == 0 else list(ms)[::-1]):
                cdll = libs[name]
                if not torch.equal(fps_call(cdll, xyz, seeds, npoint), want):
                    CS.fail(f"fps variant {name} differs from fps_plain at {shape}")
                ms[name].append(CS.cuda_ms(lambda: fps_call(cdll, xyz, seeds, npoint), iters=10))
        CS.emit("sweep_fps", shape=list(shape), ms=ms, equal_to_plain=True)


def bwd_times(dev, cases) -> dict:
    out = {}
    for name, (g, layers, dp) in cases.items():
        for bf16 in (False, True):
            out[f"{name} {'bf16' if bf16 else 'f32'}"] = CS.cuda_ms(
                lambda: K.sa_mlp_max_bwd(g, layers, dp, bf16=bf16), iters=10)
    return out


def fused_bf16_checks(dev) -> list:
    """chip_smoke's per-call check of a fused bf16 step (each backward call
    against the bf16 plain version on its inputs) after one epoch, over 6
    seeds and 2 batches each."""
    ds = CS.train_dataset()
    errs = []
    for seed in (42, 1, 2, 3, 4, 5):
        trainer = Trainer(preset("8dir_kl", epochs=1, compute_dtype="bfloat16", seed=seed), ds,
                          device=dev, fused_mlp_train=True)
        trainer.fit(epochs=1, log_every=0)
        for batch_seed in (1, 2):
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            idx, valid, _ = next(ds.batches(16, shuffle=True, seed=batch_seed))
            batch, valid, _ = trainer.device_batch(ds, idx, valid, trainer.generator(0, 99, 0))
            errs.append(CS.bf16_bwd_calls(trainer, batch, valid)["norm_rel_err"])
            trainer.model.load_state_dict(state)
    return errs


def sweep_bwd(dev, libs) -> None:
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 21)
    cases = {}
    for name, (B, Kn, S, widths) in CS.TRAIN_MLP_SHAPES.items():
        cases[name] = (torch.randn((B, Kn, S, widths[0]), generator=gen, device=dev),
                       CS.make_layers(widths, gen, dev),
                       torch.randn((B, S, widths[-1]), generator=gen, device=dev))
    shipped = _build.load_library()
    variants = {"shipped": shipped, "chained": libs["chained backward"]}
    for rnd in range(2):
        for name in (variants if rnd == 0 else list(variants)[::-1]):
            with mock.patch.object(K, "load_library", lambda lib=variants[name]: lib):
                CS.emit("sweep_bwd_ms", accumulation=name, round=rnd, ms=bwd_times(dev, cases))
    for name, cdll in variants.items():
        with mock.patch.object(K, "load_library", lambda lib=cdll: lib):
            vs = {shape: CS.vs_f64(K.sa_mlp_max_bwd(g, layers, dp),
                                   K.sa_mlp_max_bwd_plain(g, layers, dp), g, layers, dp)
                  for shape, (g, layers, dp) in cases.items()}
            errs = fused_bf16_checks(dev)
        CS.emit("sweep_bwd_accuracy", accumulation=name, f32_vs_f64=vs,
                fused_bf16_step_norm_rel_err=errs, gate=CS.BF16_GRAD_TOL["fused"],
                calls_over_gate=[sum(e[i] > CS.BF16_GRAD_TOL["fused"] for e in errs)
                                 for i in range(3)],
                largest_by_call=[max(e[i] for e in errs) for i in range(3)])
    for rnd in range(2):
        targets = (132, 264, 528) if rnd == 0 else (528, 264, 132)
        for blocks in targets:
            with mock.patch.object(K, "BWD_CHUNK_BLOCKS", blocks):
                CS.emit("sweep_bwd_chunks", blocks=blocks, round=rnd, ms=bwd_times(dev, cases))


def main() -> None:
    info = CS.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = build_all()
    sweep_fps(dev, libs)
    sweep_bwd(dev, libs)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
