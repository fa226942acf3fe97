"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

One ``nvcc`` a source compiles every ``csrc/*.cu`` (with the ``csrc/*.cuh``
headers they include), all started together, and one more links the objects
into one shared library with a plain C interface (no PyTorch headers, so it
builds in seconds). The library lands in
``build/pcot_torch_kernels/<hash>/libpcot_kernels.so`` at the root of the
checkout, keyed by the sources, the flags and
``nvcc --version``; a second call in the same process, or a later process on
the same tree, loads it without building. Nothing here runs at import time:
the build starts when the first CUDA tensor reaches a kernel wrapper.

Each C entry point takes ``void*`` pointers, ``int`` sizes and the CUDA
stream, and returns ``cudaGetLastError()`` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "pcot_torch_kernels"
LIB_NAME = "libpcot_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# one source to an object (the link adds -shared)
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes of each C entry point in csrc/
SIGNATURES = {
    # xyz, feats, cidx, new_xyz, grouped, idx, B, N, S, K, D, stream
    "pcot_sa_group_f32": [_P] * 6 + [_I] * 5 + [_P],
    # grouped, out, B, K, S, n_layers, (w, s, t) x 4, c0..c4, bf16, stream
    "pcot_sa_mlp_max_f32": [_P, _P] + [_I] * 4 + [_P] * 12 + [_I] * 6 + [_P],
    # idx, dg, out, B, N, S, K, D, row_stride, stream
    "pcot_sa_scatter_f32": [_P] * 3 + [_I] * 6 + [_P],
    # grouped, dpooled, dgrouped, scratch, scratch_floats, chunk_rows, B, K, S,
    # n_layers, (w, s, t) x 4, (dw, ds, dt) x 4, c0..c4, bf16, stream
    "pcot_sa_mlp_max_bwd_f32": [_P] * 4 + [_I] * 6 + [_P] * 24 + [_I] * 6 + [_P],
    # new_xyz, xyz, idx, B, N, S, K, stream
    "pcot_knn_f32": [_P] * 3 + [_I] * 4 + [_P],
    # xyz, seeds, out, dist, B, N, npoint, stream
    "pcot_fps_f32": [_P] * 4 + [_I] * 3 + [_P],
    # new_xyz, xyz, idx, B, N, S, K, radius_sq, matmul_form, stream
    "pcot_ball_query_f32": [_P] * 3 + [_I] * 4 + [_F, _I, _P],
    # d, idx, rows, M, K, stream
    "pcot_topk_min_f32": [_P, _P] + [_I] * 3 + [_P],
    # x, out, n, kind (0 f32, 1 bf16, 2 int16), reps, stream
    "pcot_vpu_ew": [_P, _P, ctypes.c_longlong, _I, _I, _P],
    # q, k, v, o, l, m, B, H, N, D, bf16, sm_scale, stream
    "pcot_flash_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, l, m, dout, di, dk, dv, B, H, N, D, bf16, sm_scale, stream
    "pcot_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_F, _P],
    # q, k, v, l, m, dout, di, dq, B, H, N, D, bf16, sm_scale, stream
    "pcot_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _P],
    # d, out, B, S, N, K, stream (each of the four selections)
    **{f"pcot_vpu_{name}": [_P, _P] + [_I] * 4 + [_P]
       for name in ("sel_argmin", "sel_mintie", "radix_count", "count_emit")},
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        DEFAULT_NVCC,
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built")


class _Library:
    """The loaded library and what its build printed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.cdll = None
        self.path = None
        self.build_seconds = None  # None when an earlier build was reused
        self.nvcc_log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self.cdll is None:
                self._load()
            return self.cdll

    def _load(self) -> None:
        nvcc = nvcc_path()
        ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
        if ver.returncode != 0:
            raise BuildError(f"{nvcc} --version failed:\n{ver.stderr}")
        sources = sorted(CSRC.glob("*.cu"))
        if not sources:
            raise BuildError(f"no CUDA sources under {CSRC}")
        h = hashlib.sha256(ver.stdout.encode() + " ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
            h.update(src.name.encode() + src.read_bytes())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        lib = out_dir / LIB_NAME
        log = out_dir / "nvcc.log"
        if not lib.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
            t0 = time.perf_counter()
            try:
                text = _compile_and_link(nvcc, sources, objs, tmp)
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            self.build_seconds = time.perf_counter() - t0
            log.write_text(text)
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        self.nvcc_log = log.read_text() if log.exists() else ""
        cdll = ctypes.CDLL(str(lib))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.path = lib
        self.cdll = cdll


def _compile_and_link(nvcc: str, sources, objs, lib: Path) -> str:
    """Compile each source to its object, every nvcc started at once, then
    link the objects into ``lib``; returns what they printed (ptxas -v).
    Raises ``BuildError`` with the output of every command that failed."""
    cmds = [[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{out}"
              for cmd, proc, out in zip(cmds, procs, outs) if proc.returncode != 0]
    if failed:
        raise BuildError("\n".join(failed))
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib), *map(str, objs)]
    r = subprocess.run(link, capture_output=True, text=True)
    if r.returncode != 0:
        lib.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed with code {r.returncode}: {' '.join(link)}\n"
                         f"{r.stdout}{r.stderr}")
    return "".join(outs) + r.stdout + r.stderr


LIBRARY = _Library()


def load_library() -> ctypes.CDLL:
    """Build on first use, then return the loaded library."""
    return LIBRARY.load()


def ptxas_lines(log: str) -> list[str]:
    """The ``ptxas -v`` lines of a build log: registers, shared memory,
    spills, one group per kernel."""
    return [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
