"""The selection micro-benchmarks, asked of the H100.

    python -m pointcloud_orientation_tpu_torch.benchmarks.profile_vpu_select

The JAX package's ``benchmarks/profile_vpu_select.py`` (this module keeps
its name) answered two design questions of ``sa_group``'s selection on the
TPU v5e: does its vector unit (VPU) run bf16 elementwise work at twice the
f32 rate, and which formulation of "the K nearest of a row" costs least
there. The v5e's answer was K argmin passes. This card has no VPU: its CUDA
cores run elementwise work and its warps' shuffles, ballots and barriers the
reductions, so the five kernels are ported as kernels designed for it
(``csrc/vpu_select.cu``), and the question is asked again here and in
``chip_sweep.py``, beside ``topk_min``'s threshold select on the grouping's
distance tiles:

- :func:`ew` 32 rounds of ``x = max(x + x, x * x)`` on ``(B, S, N)``, f32,
  bf16 (rounded after every operation) or int16 (wrapping);
- :func:`sel_argmin` K argmin-and-mask passes, and :func:`sel_mintie` K
  passes of a minimum and its lowest tied lane: ``(B, K, S)`` int32, the
  row's K nearest, nearest first, lowest lane on ties (a stable sort's first
  K on rows without NaN);
- :func:`radix_count` the bit pattern of each row's K-th smallest value by
  count passes (on the TPU 31, one a bit), ``(B, 1, S)`` int32
  (``d >= 0``);
- :func:`count_emit` the count passes, then the lanes below that threshold
  and the first ties, ``(B, K, S)`` int32 in ascending lane order.

Each wrapper takes its plain PyTorch version (same module) only for CPU
tensors; for CUDA tensors it launches its kernel or raises, and counts the
launch in ``<wrapper>.launches``. The plain versions repeat the TPU kernels'
steps (the masked ``+inf`` included), so on the CPU they are bit-equal to
the Pallas kernels (``tests/test_torch_vpu_select.py``).

:func:`main` times every kernel at the JAX file's shape (B=64, S=128,
N=1024, K=32) and the selections also at the training grouping's B=16,
N=10,000, and prints one JSON line each: device ms, bound ms, plain ms and
the library call's ms. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import _build
from ..ops._build import load_library
from .roofline import bound_ms, device_ms

B, S, N, K = 64, 128, 1024, 32  # the JAX file's shapes
REPS = 32  # elementwise rounds, as the JAX file's REPS
# (B, S, N, K) the selections are timed at: the JAX file's, and the
# training grouping's sa1 (B=16, N=10,000)
SELECT_SHAPES = {"B=64 N=1024": (B, S, N, K), "B=16 N=10000": (16, S, 10_000, K)}
EW_DTYPES = (torch.float32, torch.bfloat16, torch.int16)
MAX_N = 49_152  # a row in the kernels' shared memory (192 KB)

_EW_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ew_plain(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """``reps`` rounds of ``torch.maximum(x + x, x * x)`` in ``x``'s dtype."""
    for _ in range(reps):
        x = torch.maximum(x + x, x * x)
    return x


def _lanes(d: torch.Tensor) -> torch.Tensor:
    return torch.arange(d.shape[-1], device=d.device)


def sel_argmin_plain(d: torch.Tensor, k: int) -> torch.Tensor:
    """K passes: the first lane of each row's minimum, then that lane set to
    ``+inf``. ``(B, S, N)`` -> ``(B, K, S)`` int32."""
    d = d.clone()
    lane = _lanes(d)
    cols = []
    for _ in range(k):
        col = torch.argmin(d, dim=-1)
        cols.append(col)
        d = torch.where(lane == col[..., None], torch.full_like(d, float("inf")), d)
    return torch.stack(cols, dim=1).to(torch.int32)


def sel_mintie_plain(d: torch.Tensor, k: int) -> torch.Tensor:
    """K passes: each row's minimum, the lowest lane holding it, then that
    lane set to ``+inf``. ``(B, S, N)`` -> ``(B, K, S)`` int32."""
    d = d.clone()
    n = d.shape[-1]
    lane = _lanes(d)
    cols = []
    for _ in range(k):
        m = d.amin(dim=-1, keepdim=True)
        col = torch.where(d == m, lane, torch.full_like(lane, n)).amin(dim=-1)
        cols.append(col)
        d = torch.where(lane == col[..., None], torch.full_like(d, float("inf")), d)
    return torch.stack(cols, dim=1).to(torch.int32)


def _radix_prefix(bits: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, S)``: the largest prefix, bit 30 down to 0, with fewer than
    ``k`` entries of ``bits`` (int32) below it."""
    prefix = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=bits.device)
    for b in range(30, -1, -1):
        cand = prefix | (1 << b)
        cnt = (bits < cand[..., None]).sum(dim=-1)
        prefix = torch.where(cnt >= k, prefix, cand)
    return prefix


def radix_count_plain(d: torch.Tensor, k: int) -> torch.Tensor:
    """31 count passes over the f32 bit patterns as int32: ``(B, 1, S)``
    int32, each row's K-th smallest pattern (``torch.kthvalue``'s value's
    bits where ``d >= 0``)."""
    return _radix_prefix(d.contiguous().view(torch.int32), k)[:, None, :]


def count_emit_plain(d: torch.Tensor, k: int) -> torch.Tensor:
    """The count passes, then the mask (every pattern below the K-th, and
    the ties in lane order while the count stays within K) and its lanes in
    ascending lane order: ``(B, K, S)`` int32; slots past the lanes
    selected are 0."""
    bits = d.contiguous().view(torch.int32)
    prefix = _radix_prefix(bits, k)[..., None]
    below = bits < prefix
    tie = bits == prefix
    n_below = below.sum(dim=-1, keepdim=True)
    mask = below | (tie & (tie.cumsum(dim=-1) <= k - n_below))
    rank = mask.cumsum(dim=-1)  # 1, 2, ... on the lanes selected
    slot = torch.where(mask & (rank <= k), rank - 1, torch.full_like(rank, k))
    lanes = _lanes(d).expand_as(bits)
    out = torch.zeros((*bits.shape[:-1], k + 1), dtype=torch.long, device=d.device)
    out.scatter_(-1, slot, lanes)  # slot k collects the lanes not selected
    return out[..., :k].transpose(1, 2).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ew(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """``reps`` rounds of ``max(x + x, x * x)`` elementwise, in ``x``'s dtype
    (float32, bfloat16: every operation rounded to bf16; int16: wrapping;
    NaN propagates through the max). ``x`` contiguous."""
    if x.dtype not in _EW_KIND:
        raise TypeError(f"ew takes float32, bfloat16 or int16, got {x.dtype}")
    if reps < 0:
        raise ValueError(f"reps={reps} must be >= 0")
    if x.device.type == "cpu":
        return ew_plain(x, reps)
    if x.device.type != "cuda":
        raise ValueError(f"ew runs on cpu or cuda tensors, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() < 1:
        raise ValueError("ew takes a non-empty contiguous tensor at a 16-byte aligned address")
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.pcot_vpu_ew(x.data_ptr(), out.data_ptr(), x.numel(), _EW_KIND[x.dtype], reps,
                              _stream(x.device))
    _raise_on(err, f"ew launch ({tuple(x.shape)} {x.dtype})")
    ew.launches += 1
    return out


def _select(wrapper: Callable, plain: Callable, d: torch.Tensor, k: int,
            rows_out: Optional[int]) -> torch.Tensor:
    name = wrapper.__name__
    if d.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 distances, got {d.dtype}")
    if d.dim() != 3:
        raise ValueError(f"d must be (B, S, N), got {tuple(d.shape)}")
    b, s, n = d.shape
    if not 1 <= k <= n:
        raise ValueError(f"K={k} must lie in [1, N={n}]")
    if d.device.type == "cpu":
        return plain(d, k)
    if d.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {d.device}")
    if n > MAX_N or b * s > 2 ** 31 - 1 or not d.is_contiguous():
        raise ValueError(f"{name} takes contiguous rows of at most {MAX_N} entries, "
                         f"got {tuple(d.shape)} (contiguous: {d.is_contiguous()})")
    out = torch.empty((b, rows_out or k, s), dtype=torch.int32, device=d.device)
    lib = load_library()
    with torch.cuda.device(d.device):
        err = getattr(lib, f"pcot_vpu_{name}")(d.data_ptr(), out.data_ptr(), b, s, n, k,
                                               _stream(d.device))
    _raise_on(err, f"{name} launch (B={b}, S={s}, N={n}, K={k})")
    wrapper.launches += 1
    return out


def sel_argmin(d: torch.Tensor, k: int) -> torch.Tensor:
    """The K nearest lanes of each row of ``d (B,S,N)`` f32 by K argmin
    passes: ``(B, K, S)`` int32."""
    return _select(sel_argmin, sel_argmin_plain, d, k, None)


def sel_mintie(d: torch.Tensor, k: int) -> torch.Tensor:
    """The same by K passes of a minimum and its lowest tied lane."""
    return _select(sel_mintie, sel_mintie_plain, d, k, None)


def radix_count(d: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's K-th smallest bit pattern (``d >= 0``): ``(B, 1, S)`` int32."""
    return _select(radix_count, radix_count_plain, d, k, 1)


def count_emit(d: torch.Tensor, k: int) -> torch.Tensor:
    """The lanes of the K smallest bit patterns (ties: the first in lane
    order), ascending: ``(B, K, S)`` int32."""
    return _select(count_emit, count_emit_plain, d, k, None)


KERNELS = (ew, sel_argmin, sel_mintie, radix_count, count_emit)
SELECTIONS = (sel_argmin, sel_mintie, radix_count, count_emit)
PLAIN = {ew: ew_plain, sel_argmin: sel_argmin_plain, sel_mintie: sel_mintie_plain,
         radix_count: radix_count_plain, count_emit: count_emit_plain}
# the one PyTorch call computing each selection (None: there is none for ew)
LIBRARY = {
    sel_argmin: lambda d, k: torch.sort(d, dim=-1, stable=True),
    sel_mintie: lambda d, k: torch.sort(d, dim=-1, stable=True),
    radix_count: lambda d, k: torch.kthvalue(d, k, dim=-1),
    # its order among equal values is not guaranteed
    count_emit: lambda d, k: torch.topk(d, k, dim=-1, largest=False, sorted=False),
}
# where each kernel's TPU counterpart is, in the JAX package's file
REPLACES = {ew: ":58", sel_argmin: ":86", sel_mintie: ":97", radix_count: ":109",
            count_emit: ":123"}

for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------


def cost(name: str, b: int, s: int, n: int, k: int = K,
         dtype: torch.dtype = torch.float32, reps: int = REPS) -> Tuple[float, Dict[str, float]]:
    """(bytes, operations by ``roofline.bound_ms``'s kind) the kernel
    ``name`` must move and do: the input read once and the output written
    once; ``ew`` 3 operations a round an element (bf16 at the non-tensor bf16
    rate; f32 and int16 at the f32 rate); a selection about one compare an
    entry (``radix_count``, ``count_emit``: the K-th smallest needs on the
    order of N compares a row, not the count passes they make)."""
    if name == "ew":
        itemsize = torch.empty((), dtype=dtype).element_size()
        ops = 3.0 * reps * b * s * n
        kind = "bf16_vector_flops" if dtype == torch.bfloat16 else "flops"
        return 2.0 * itemsize * b * s * n, {kind: ops}
    out_rows = 1 if name == "radix_count" else k
    return 4.0 * (b * s * n + b * out_rows * s), {"flops": float(b * s * n)}


def bound(name: str, b: int, s: int, n: int, k: int = K,
          dtype: torch.dtype = torch.float32) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations") of ``cost``'s work at the card's
    peaks (``roofline.bound_ms``)."""
    nbytes, ops = cost(name, b, s, n, k, dtype)
    return bound_ms(nbytes, **ops)


def ew_input(dtype: torch.dtype, shape, gen: torch.Generator) -> torch.Tensor:
    """Random values of ``dtype``: normal ones (float) or any int16."""
    dev = gen.device
    if dtype == torch.int16:
        return torch.randint(-2 ** 15, 2 ** 15, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int16)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# ew's edge values: signed zeros, infinities, NaN and subnormals (f32's
# least, bf16's least and largest), or int16's extremes and the values whose
# square or double wraps
EW_SPECIALS = {
    torch.float32: (0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.4e-45, -1.4e-45,
                    1.1754942e-38, 2.0, 1.0, -1.0, 0.5, 3.4e38),
    torch.bfloat16: (0.0, -0.0, float("inf"), float("-inf"), float("nan"), 9.2e-41, -9.2e-41,
                     1.1663108e-38, 2.0, 1.0, -1.0, 0.5, 3.3e38),
    torch.int16: (0, -1, 1, 2, -2, 181, -181, 182, 255, 256, -32768, 32767, 16384, -16384),
}
# ew's edge lengths: a tail of 1 to 7 elements past whole 16-byte vectors
# (f32 4 a vector, bf16 and int16 8), below one vector, a few blocks, and
# more vectors than the persistent grid has threads
EW_EDGE_LENGTHS = tuple(range(1, 18)) + tuple(4096 * 8 + t for t in range(8)) + (B * S * N + 7,)
EW_EDGE_REPS = (0, 1, 31, 32, 33)


def ew_edge_input(dtype: torch.dtype, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` values of ``dtype``: ``ew_input``'s, with the first entries and
    about one in eight of the rest replaced by ``EW_SPECIALS``."""
    x = ew_input(dtype, (n,), gen)
    specials = torch.tensor(EW_SPECIALS[dtype], dtype=dtype, device=x.device)
    pick = torch.randint(0, len(specials), (n,), generator=gen, device=x.device)
    at = torch.rand((n,), generator=gen, device=x.device) < 0.125
    m = min(n, len(specials))
    at[:m] = True
    pick[:m] = torch.arange(m, device=x.device)
    return torch.where(at, specials[pick], x).contiguous()


ROW_KINDS = ("random", "ties", "inf", "equal", "signed")


def select_rows(kind: str, shape, gen: torch.Generator) -> torch.Tensor:
    """(B, S, N) f32 rows of a kind the selections are checked on:
    "random" uniform in [0, 1), as the JAX file draws them; "ties" a quarter
    of each row's values cycled to N, so each value repeats; "inf" runs of
    7 ``+inf`` entries in every 21 (a row of 7 or fewer entries is all
    ``+inf``); "equal" every entry 0.5; "signed" uniform in (-1, 1) with a
    quarter of the entries -0.0 and a quarter +0.0 (bit patterns below zero
    for the radix kernels, equal values for the K-pass ones)."""
    b, s, n = shape
    dev = gen.device
    if kind == "ties":
        base = torch.rand((b, s, max(1, n // 4)), generator=gen, device=dev)
        return base.repeat(1, 1, -(-n // base.shape[-1]))[..., :n].contiguous()
    if kind == "equal":
        return torch.full((b, s, n), 0.5, device=dev)
    d = torch.rand((b, s, n), generator=gen, device=dev)
    if kind == "inf":
        return d.masked_fill(torch.arange(n, device=dev) // 7 % 3 == 0, float("inf"))
    if kind == "signed":
        zero = torch.randint(0, 4, (b, s, n), generator=gen, device=dev)
        d = torch.where(zero == 0, -0.0, torch.where(zero == 1, 0.0, 2 * d - 1))
        return d.contiguous()
    if kind != "random":
        raise ValueError(f"unknown row kind {kind!r}; choose from {ROW_KINDS}")
    return d


# the ew kernel's instantiation for the benchmark's rounds, by dtype: the
# round's type in its mangled name, elements a 16-byte vector
_EW_SASS = {torch.float32: ("EwF32", 4), torch.bfloat16: ("EwBf16x2", 8),
            torch.int16: ("EwI16x2", 8)}
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_FUNCTION = re.compile(r"Function : (\S+)")


def _cuobjdump() -> Optional[str]:
    for path in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "cuobjdump"),
                 shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump"):
        if path and os.path.exists(path):
            return path
    return None


def sass_loop(sass: str) -> Tuple[int, Dict[str, int]]:
    """The instructions of one function's SASS (``cuobjdump -sass`` text)
    inside its longest loop, from a backward branch's target to the branch:
    their count and their count by opcode (modifiers dropped)."""
    insns, labels = [], {}
    for line in sass.splitlines():
        m = _SASS_LABEL.match(line)
        if m:
            labels[m.group(1)] = None  # the next instruction's address
            continue
        m = _SASS_INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name, at in labels.items():
            if at is None:
                labels[name] = addr
        text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2))
        insns.append((addr, text.split()[0].split(".")[0], text))
    best = None
    for addr, op, text in insns:
        if op != "BRA":
            continue
        tm = re.search(r"(\.L_x_\d+)", text)
        target = labels.get(tm.group(1)) if tm else int(text.split()[-1], 16)
        if target is None or target > addr:
            continue
        if best is None or addr - target > best[1] - best[0]:
            best = (target, addr)
    if best is None:
        return 0, {}
    ops: Dict[str, int] = {}
    for addr, op, _ in insns:
        if best[0] <= addr <= best[1]:
            ops[op] = ops.get(op, 0) + 1
    return sum(ops.values()), dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def ew_sass(dtype: torch.dtype) -> Optional[dict]:
    """The built ``ew`` kernel for the benchmark's ``REPS`` rounds in
    ``dtype``, read from the library's SASS: the grid-stride loop's
    instructions (one 16-byte vector, ``REPS`` rounds) by opcode and per
    element-round. None when ``cuobjdump`` is missing or the library is not
    built."""
    tool = _cuobjdump()
    if tool is None or _build.LIBRARY.path is None:
        return None
    text = subprocess.run([tool, "-sass", str(_build.LIBRARY.path)], capture_output=True,
                          text=True).stdout
    op_name, per_vector = _EW_SASS[dtype]
    parts = _SASS_FUNCTION.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if "ew_kernel" in name and op_name in name and f"Li{REPS}E" in name:
            count, ops = sass_loop(body)
            return {"function": name, "loop_instructions": count, "loop_ops": ops,
                    "per_element_round": count / (REPS * per_vector)}
    return None


def sm_clock_mhz() -> Tuple[Optional[float], Optional[float]]:
    """(current, maximum) SM clock in MHz from ``nvidia-smi``; None where
    it gives none."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits", "--id=0"],
                       capture_output=True, text=True)
    try:
        cur, mx = (float(v) for v in r.stdout.strip().split(","))
        return cur, mx
    except ValueError:
        return None, None


def issue_floor_ms(per_element_round: float, elements: int, reps: int, sms: int,
                   clock_mhz: float) -> float:
    """The least time ``reps`` rounds over ``elements`` take at
    ``per_element_round`` instructions each, issued at 4 warp instructions
    (128 thread instructions) a clock an SM."""
    return per_element_round * elements * reps / (128.0 * sms * clock_mhz * 1e6) * 1e3


def benchmark(dev: torch.device, iters: int = 20, seed: int = 0) -> List[dict]:
    """Every kernel at its shapes on ``dev`` (a CUDA device): device ms,
    bound, plain ms and the library call's ms, one dict each. ``ew`` at the
    JAX file's (B, S, N) in each dtype; the selections at
    ``SELECT_SHAPES`` on uniform distances in [0, 1), as the JAX file draws
    them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for dtype in EW_DTYPES:
        x = ew_input(dtype, (B, S, N), gen)
        b_ms, b_by = bound("ew", B, S, N, dtype=dtype)
        ms = device_ms(lambda: ew(x), iters)
        clock, max_clock = sm_clock_mhz()
        plain_ms = device_ms(lambda: ew_plain(x), max(1, iters // 4))
        sass = ew_sass(dtype)
        floor = None
        if sass is not None and max_clock:
            floor = issue_floor_ms(sass["per_element_round"], B * S * N, REPS,
                                   torch.cuda.get_device_properties(dev).multi_processor_count,
                                   max_clock)
        rows.append({"kernel": "ew", "dtype": str(dtype).split(".")[-1], "shape": [B, S, N],
                     "reps": REPS, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms, "plain_ms": plain_ms, "library_ms": None,
                     "sass": sass, "sm_clock_mhz": clock, "max_sm_clock_mhz": max_clock,
                     "issue_floor_ms": floor})
    for shape_name, (b, s, n, k) in SELECT_SHAPES.items():
        d = torch.rand((b, s, n), generator=gen, device=dev)
        for fn in SELECTIONS:
            b_ms, b_by = bound(fn.__name__, b, s, n, k)
            ms = device_ms(lambda: fn(d, k), iters)
            plain_ms = device_ms(lambda: PLAIN[fn](d, k), 2, warmup=1)
            library_ms = device_ms(lambda: LIBRARY[fn](d, k), iters)
            rows.append({"kernel": fn.__name__, "shape": shape_name, "B": b, "S": s, "N": n,
                         "K": k, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                         "share": b_ms / ms, "plain_ms": plain_ms, "library_ms": library_ms})
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_vpu_select: no CUDA device; it times the kernels on the card",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    for row in benchmark(dev):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
