"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles every ``csrc/*.cu`` into one shared library with
a plain C interface — seconds to build, where a source that includes
PyTorch's headers takes minutes.  The library lands in
``build/dsort_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing file.  Pointers and the stream cross as ``c_void_p``, sizes as
``c_int`` / ``c_longlong``.

Nothing here runs at import: the first kernel launch calls `library()`.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dsort_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: C entry points and their argument types (x, rows, row_len, ..., stream).
SIGNATURES = {
    "dsort_bitonic_tile_i32": (_P, _LL, _LL, _I, _LL, _P),
    "dsort_bitonic_tile_i64": (_P, _LL, _LL, _I, _LL, _P),
    "dsort_bitonic_global_stage_i32": (_P, _LL, _LL, _LL, _LL, _P),
    "dsort_bitonic_global_stage_i64": (_P, _LL, _LL, _LL, _LL, _P),
    "dsort_bitonic_tile_merge_i32": (_P, _LL, _LL, _I, _LL, _P),
    "dsort_bitonic_tile_merge_i64": (_P, _LL, _LL, _I, _LL, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds the last compiling `build()` spent in nvcc (None: nothing compiled).
last_build_s: float | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of dsort_tpu_torch are built from source at first use"
        )
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for this source hash exists;
    returns its path."""
    global last_build_s
    out = BUILD_DIR / f"libdsort_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
