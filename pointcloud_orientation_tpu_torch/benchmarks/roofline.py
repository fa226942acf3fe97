"""The card's published peaks, the least time a kernel could take, and a
device timer: the one bound formula of ``chip_smoke.py``, ``chip_sweep.py``
and :mod:`.profile_vpu_select`.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W): HBM3 at 3.35 TB/s; outside the tensor cores f32
at 67 TFLOP/s and bf16 at 133.8 TFLOP/s (the "NVIDIA H100 Tensor Core GPU
Architecture" whitepaper's "Peak BF16 (non-Tensor)" for the SXM5 part,
twice the f32 rate, from packed bf16x2 instructions); in the tensor cores
bf16 at 989 TFLOP/s and TF32 at 495 TFLOP/s (f32 accumulation).
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_VECTOR_FLOPS = 133.8e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# f32-grade products as 3xTF32: three TF32 products each
PEAK_F32_PRODUCT_FLOPS = PEAK_TF32_FLOPS / 3
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's SM clock: a sleep at least this long


def bound_ms(nbytes: float, flops: float = 0.0, bf16_flops: float = 0.0,
             f32_products: float = 0.0, bf16_vector_flops: float = 0.0) -> Tuple[float, str]:
    """The larger of the bytes' time (each input read once, each output
    written once) and the operations' time, with its name: ``flops`` at the
    f32 peak (integer operations too: the card runs them at most at that
    rate, so the bound it gives them is never above their true one),
    ``bf16_vector_flops`` (bf16 arithmetic outside the tensor cores) at the
    non-tensor bf16 peak, ``bf16_flops`` (products of bf16 operands) at the
    bf16 tensor-core peak, ``f32_products`` (f32 matrix products) at a third
    of the TF32 tensor-core peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + bf16_vector_flops / PEAK_BF16_VECTOR_FLOPS
             + bf16_flops / PEAK_BF16_FLOPS + f32_products / PEAK_F32_PRODUCT_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> Tuple[float, float]:
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


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    return timed(fn, iters, warmup)[0]
