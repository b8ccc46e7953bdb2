"""Times S1 (`tile_sort_kernel`) in each cluster form at the default tile
of 32,768 keys, on one GPU.

A form is C CTAs a tile, 1, 2, 4 or 8, each holding T / C keys in L / E
threads: E = 32 keys a thread at one CTA, 16 otherwise (the library's rule,
``csrc/tile_sort.cu``).  The script reaches every form through the
library's C entry, which takes the cluster size, and checks each against
`tile_sort_plain` before it times it.  Shapes are the ``pallas`` path's:
8 x 2^23 int32 keys and 8 x 2^21 int64 (an int64 tile needs at least two
CTAs' shared memory)::

    python3 -m dsort_tpu_torch.tools.s1_forms [--bounds 1024 512 256]

Prints, per key type, each form's median ms over 7 launches by CUDA events,
timed twice in turns (forward, then back), and the card's name and power
limit.  ``--bounds`` instead builds ``csrc/tile_sort.cu`` alone once per
launch bound named (the source's ``__launch_bounds__(kTileThreads)`` on
S1 replaced), prints each build's registers and spills (``-Xptxas -v``),
and times, in turns over the builds, the forms whose threads fit the
bound.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

import numpy as np
import torch

from dsort_tpu_torch.ops import _build
from dsort_tpu_torch.ops import pallas_sort as ps

TILE_ROWS = 256
SHAPES = {torch.int32: (8, 1 << 23), torch.int64: (8, 1 << 21)}
FORMS = {torch.int32: (1, 2, 4, 8), torch.int64: (2, 4, 8)}


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launch(lib, x: torch.Tensor, c: int) -> None:
    """S1 over every tile of ``x`` with ``c`` CTAs a tile."""
    tile = TILE_ROWS * ps.LANES
    entry = getattr(lib, "dsort_tile_sort_" + ("i32" if x.dtype == torch.int32 else "i64"))
    err = entry(x.data_ptr(), x.numel() // tile, tile, c,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_sort C={c}: CUDA error {err}")


def threads(c: int) -> int:
    """Threads a CTA of form ``c``: its share over 32 keys at one CTA, 16
    otherwise."""
    return TILE_ROWS * ps.LANES // c // (32 if c == 1 else 16)


def bound_library(bound: int) -> ctypes.CDLL:
    """S1's source built alone under ``__launch_bounds__(bound)``; prints the
    registers and spills of each of its tile_sort_kernel instantiations."""
    out = _build.BUILD_DIR / f"s1_bound_{bound}"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "tile_sort.cu").read_text()
    old = "__launch_bounds__(kTileThreads) tile_sort_kernel"
    if old not in src:
        raise RuntimeError("tile_sort.cu: S1's launch bound not found")
    new = f"__launch_bounds__({bound}) tile_sort_kernel"
    (out / "tile_sort.cu").write_text(src.replace(old, new))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
           str(out / "lib.so"), str(out / "tile_sort.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"tile_sort_kernelI([il])Li(\d+)E", line)  # mangled <K, E>
        if m and "Compiling entry" in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info).groups()
            key = "int32" if m[1] == "i" else "int64"
            print(f"bound {bound} tile_sort_kernel<{key}, E={m[2]}>: {regs} registers, "
                  f"spill stores/loads {spill[0]}/{spill[1]} bytes", flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for suffix in ("i32", "i64"):
        fn = getattr(lib, f"dsort_tile_sort_{suffix}")
        fn.argtypes = list(_build.SIGNATURES[f"dsort_tile_sort_{suffix}"])
        fn.restype = ctypes.c_int
    return lib


def time_forms(lib, dtype: torch.dtype, forms=None, seed: int = 0) -> dict[int, list[float]]:
    """{C: [ms, ms]} of each form on one set of random keys, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, SHAPES[dtype], dtype=dtype, device="cuda", generator=gen)
    want = ps.tile_sort_plain(x.clone(), TILE_ROWS)
    forms = FORMS[dtype] if forms is None else forms
    for c in forms:
        got = x.clone()
        launch(lib, got, c)
        if not torch.equal(got, want):
            raise AssertionError(f"tile_sort {dtype} C={c}: disagrees with its plain version")
    times = {c: [] for c in forms}
    for c in forms + forms[::-1]:
        times[c].append(cuda_ms(lambda: launch(lib, x, c)))
    return times


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bounds", type=int, nargs="+", metavar="THREADS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("s1_forms needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if not args.bounds:
        lib = ps._library()
        for dtype in SHAPES:
            times = time_forms(lib, dtype)
            print(f"forms tile_sort_kernel {dtype} {SHAPES[dtype]}: " + ", ".join(
                f"C={c} ({threads(c)} threads) {a:.4f} / {b:.4f} ms"
                for c, (a, b) in times.items()) + f" [{card}]", flush=True)
        return 0
    libs = {bound: bound_library(bound) for bound in args.bounds}
    for dtype in SHAPES:
        for bound in args.bounds + args.bounds[::-1]:
            forms = tuple(c for c in FORMS[dtype] if threads(c) <= bound)
            times = time_forms(libs[bound], dtype, forms)
            print(f"bound {bound} tile_sort_kernel {dtype} {SHAPES[dtype]}: " + ", ".join(
                f"C={c} ({threads(c)} threads) {a:.4f} / {b:.4f} ms"
                for c, (a, b) in times.items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
