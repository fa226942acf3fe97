"""ctypes bridge to the native ASCII-PLY parser, built from the repository's
``native/fastply.cc``.

Counterpart of ``pointcloud_orientation_tpu/data/fastply.py``. The library
is built here rather than loaded from ``native/``: the first parse runs
``g++ -O3 -shared -fPIC -pthread`` on ``native/fastply.cc`` into
``build/fastply/<hash>/libfastply.so`` at the root of the checkout, keyed by
the source, the flags and ``g++ --version``; a later process on the same tree
loads it without building. A parser that cannot be built is not hidden: the
first attempt warns with the compiler's message, :func:`build_error` keeps
it, and every file then goes to the NumPy parser, which
:func:`parser_counts` counts. A file the native parser rejects falls back to
the NumPy parser for that file alone, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "fastply.cc"
BUILD_ROOT = _ROOT / "build" / "fastply"
LIB_NAME = "libfastply.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


class FastPlyBuildError(RuntimeError):
    """No C++ compiler, no source, or the compiler refused it."""


_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None
_counts = {"native": 0, "numpy": 0}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise FastPlyBuildError("no C++ compiler: g++ is not on PATH and $CXX is unset")
    return cxx


def build_library() -> Path:
    """Build the parser's shared library if this tree has none yet; return
    its path. Raises :class:`FastPlyBuildError` with the compiler's output."""
    if not SOURCE.is_file():
        raise FastPlyBuildError(f"no parser source at {SOURCE}")
    cxx = _compiler()
    ver = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    if ver.returncode != 0:
        raise FastPlyBuildError(f"{cxx} --version failed:\n{ver.stderr}")
    h = hashlib.sha256(ver.stdout.encode() + " ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise FastPlyBuildError(f"{' '.join(cmd)} failed with code {r.returncode}:\n"
                                f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (FastPlyBuildError, OSError) as e:
            _error = str(e)
            warnings.warn(f"the native PLY parser is unavailable, the NumPy parser reads "
                          f"every file: {_error}", RuntimeWarning, stacklevel=3)
            return None
        lib.fastply_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_longlong)]
        lib.fastply_read.restype = ctypes.POINTER(ctypes.c_float)
        lib.fastply_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.fastply_free.restype = None
        lib.fastply_read_bulk.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),                 # paths
            ctypes.c_longlong,                               # n
            ctypes.c_int,                                    # nthreads
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out pointers
            ctypes.POINTER(ctypes.c_longlong),               # out n_vertices
            ctypes.POINTER(ctypes.c_longlong),               # out n_channels
        ]
        lib.fastply_read_bulk.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native parser is built and loaded (builds it if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native parser could not be built or loaded, else None."""
    _load()
    return _error


def parser_counts() -> dict:
    """Files parsed since the last :func:`reset_parser_counts`, by parser:
    ``{"native": n, "numpy": m}``."""
    return dict(_counts)


def reset_parser_counts() -> None:
    _counts.update(native=0, numpy=0)


def count_numpy(n: int) -> None:
    _counts["numpy"] += n


def _take(ptr, n: int, c: int, lib) -> Optional[np.ndarray]:
    if not ptr or n <= 0 or c <= 0:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(n, c)).copy()
    finally:
        lib.fastply_free(ptr)
    _counts["native"] += 1
    return arr.astype(np.float32, copy=False)


def try_read_ply_native(path: str) -> Optional[np.ndarray]:
    """One file through the native parser; None if the parser is
    unavailable or rejects the file."""
    lib = _load()
    if lib is None:
        return None
    n, c = ctypes.c_longlong(0), ctypes.c_longlong(0)
    ptr = lib.fastply_read(str(path).encode(), ctypes.byref(n), ctypes.byref(c))
    return _take(ptr, n.value, c.value, lib)


def try_read_ply_bulk_native(paths, nthreads: int = 0) -> Optional[List[Optional[np.ndarray]]]:
    """Many files through the native thread pool (the GIL released);
    ``nthreads=0`` takes every core. Returns a list aligned with ``paths``,
    None where the parser rejected a file (the caller falls back for that
    file), or None if the parser is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)()
    c_ns = (ctypes.c_longlong * n)()
    c_cs = (ctypes.c_longlong * n)()
    lib.fastply_read_bulk(c_paths, n, nthreads, c_outs, c_ns, c_cs)
    return [_take(c_outs[i], c_ns[i], c_cs[i], lib) for i in range(n)]
