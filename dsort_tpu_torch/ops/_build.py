"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles every ``csrc/*.cu`` to an object, one nvcc per source,
all started together; one ``nvcc -shared`` links them into a single library
with a plain C interface — seconds to build, where a source that includes
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_BITONIC = {
    # (keys, ranks or NULL, rows, row_len, T | k, k_start | k | j[, stages], stream)
    "tile": (_P, _P, _LL, _LL, _I, _LL, _P),
    "global_stage": (_P, _P, _LL, _LL, _LL, _LL, _I, _P),
    "tile_merge": (_P, _P, _LL, _LL, _I, _LL, _P),
}
#: C entry points and their argument types.
SIGNATURES = {
    **{
        f"dsort_bitonic_{name}_{suffix}": argtypes
        for name, argtypes in _BITONIC.items() for suffix in ("i32", "i64")
    },
    # (key bytes, ranked) -> S_max of the global-stage kernel
    "dsort_bitonic_global_stages_max": (_I, _I),
    # (xs, starts, lens, payload, wk, wt, wv, P, n_local, slot, row_bytes,
    #  host caps, stream)
    **{
        f"dsort_ring_exchange_{suffix}": (
            _P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL,
            ctypes.POINTER(ctypes.c_longlong), _P,
        )
        for suffix in ("i32", "i64")
    },
    # (ws, tags, out, rows, total, tag_stride, row_bytes, stream)
    "dsort_gather_rows": (_P, _P, _P, _LL, _LL, _LL, _LL, _P),
    # (keys, tiles, T, cluster, stream) / (keys, index, tiles, T, cluster, stream)
    **{f"dsort_tile_sort_{s}": (_P, _LL, _I, _I, _P) for s in ("i32", "i64")},
    **{f"dsort_tile_sort_kv_{s}": (_P, _P, _LL, _I, _I, _P) for s in ("i32", "i64")},
    # (x, n, shift, bits, out, stream)
    **{
        f"dsort_radix_histogram_{s}": (_P, _LL, _I, _I, _P, _P)
        for s in ("i32", "i64", "u32", "u64")
    },
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


def _check(cmd: list[str], rc: int, out: str, err: str, *tmp: Path) -> None:
    """Raise with nvcc's output on a non-zero exit, removing ``tmp``."""
    if rc != 0:
        for t in tmp:
            t.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for this source hash exists;
    returns its path."""
    global last_build_s
    digest = _digest()
    out = BUILD_DIR / f"libdsort_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources(), objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate() for proc in procs]  # waits for all of them
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, outputs):
        _check(cmd, proc.returncode, stdout, stderr, *objs)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_s = time.perf_counter() - t0
    _check(cmd, proc.returncode, proc.stdout, proc.stderr, tmp, *objs)
    for obj in objs:
        obj.unlink()
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
