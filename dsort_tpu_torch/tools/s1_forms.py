"""Times S1 (`tile_sort_kernel`) in each cluster form at the default tile
of 32,768 keys, on one GPU; with ``--kv``, S2 (`tile_sort_kv_kernel`).

A form is C CTAs a tile, 1, 2, 4 or 8, each holding T / C keys in L / E
threads: E = 32 keys a thread at one CTA, 16 otherwise (the library's rule,
``csrc/tile_sort.cu``).  The script reaches every form through the
library's C entry, which takes the cluster size, and checks each against
`tile_sort_plain` before it times it.  Shapes are the ``pallas`` path's:
8 x 2^23 int32 keys and 8 x 2^21 int64 (an int64 tile needs at least two
CTAs' shared memory)::

    python3 -m dsort_tpu_torch.tools.s1_forms [--bounds 1024 512 256 | --kv]

Prints, per key type, each form's median ms over 7 launches by CUDA events,
timed twice in turns (forward, then back), and the card's name and power
limit.  ``--bounds`` instead builds ``csrc/tile_sort.cu`` alone once per
launch bound named (the source's ``__launch_bounds__(kTileThreads)`` on
S1 replaced), prints each build's registers and spills (``-Xptxas -v``),
and times, in turns over the builds, the forms whose threads fit the
bound.  ``--kv`` builds ``csrc/tile_sort.cu`` alone once per S2 keys a
thread (E = 8 and 16: the source's ``kKvKeys`` replaced), prints their
registers and spills, and times S2 at C = 4 and 8 CTAs a tile on the 2^23
records' tiles (2^23 int32 or int64 keys with an int32 index, checked
against `tile_sort_kv_plain`), in turns over the builds.
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
KV_PAIRS = 1 << 23  # the 2^23 records' pairs: 256 tiles
KV_FORMS = (4, 8)


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


def variant_library(tag: str, old: str, new: str, kernel: str) -> ctypes.CDLL:
    """``csrc/tile_sort.cu`` built alone with ``old`` replaced by ``new``;
    prints the registers and spills of each instantiation of ``kernel``."""
    out = _build.BUILD_DIR / ("tile_sort_" + re.sub(r"\W+", "_", tag))
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "tile_sort.cu").read_text()
    if old not in src:
        raise RuntimeError(f"tile_sort.cu: {old!r} not found")
    (out / "tile_sort.cu").write_text(src.replace(old, new))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
           str(out / "lib.so"), str(out / "tile_sort.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        m = re.search(kernel + r"I([il])Li(\d+)E", line)  # mangled <K, E>
        if m and "Compiling entry" in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info).groups()
            key = "int32" if m[1] == "i" else "int64"
            print(f"{tag} {kernel}<{key}, E={m[2]}>: {regs} registers, "
                  f"spill stores/loads {spill[0]}/{spill[1]} bytes", flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("dsort_tile_sort_"):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def bound_library(bound: int) -> ctypes.CDLL:
    """S1's source built alone under ``__launch_bounds__(bound)``."""
    return variant_library(f"bound {bound}", "__launch_bounds__(kTileThreads) tile_sort_kernel",
                           f"__launch_bounds__({bound}) tile_sort_kernel", "tile_sort_kernel")


def kv_library(keys: int) -> ctypes.CDLL:
    """S2's source built alone with ``keys`` pairs a thread."""
    return variant_library(f"kv E={keys}", "constexpr int kKvKeys = 16;",
                           f"constexpr int kKvKeys = {keys};", "tile_sort_kv_kernel")


def time_kv_forms(libs: dict, dtype: torch.dtype, seed: int = 0) -> dict:
    """{(E, C): [ms, ms]} of S2 for each build E and form C on one set of
    random keys and a permuted index, in turns over the builds."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    info = torch.iinfo(dtype)
    tile = TILE_ROWS * ps.LANES
    x = torch.randint(info.min, info.max, (KV_PAIRS,), dtype=dtype, device="cuda", generator=gen)
    v = torch.randperm(KV_PAIRS, device="cuda", dtype=torch.int32, generator=gen)
    want = ps.tile_sort_kv_plain(x.clone(), v.clone(), TILE_ROWS)
    suffix = "i32" if dtype == torch.int32 else "i64"

    def launch_kv(lib, gx, gv, c):
        err = getattr(lib, f"dsort_tile_sort_kv_{suffix}")(
            gx.data_ptr(), gv.data_ptr(), KV_PAIRS // tile, tile, c,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"tile_sort_kv C={c}: CUDA error {err}")

    for e, lib in libs.items():
        for c in KV_FORMS:
            gx, gv = x.clone(), v.clone()
            launch_kv(lib, gx, gv, c)
            if not (torch.equal(gx, want[0]) and torch.equal(gv, want[1])):
                raise AssertionError(f"tile_sort_kv {dtype} E={e} C={c}: disagrees with its plain "
                                     "version")
    times = {(e, c): [] for e in libs for c in KV_FORMS}
    order = list(libs) + list(libs)[::-1]
    for e in order:
        for c in KV_FORMS:
            gx, gv = x.clone(), v.clone()
            times[(e, c)].append(cuda_ms(lambda: launch_kv(libs[e], gx, gv, c)))
    return times


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
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--bounds", type=int, nargs="+", metavar="THREADS")
    mode.add_argument("--kv", action="store_true", help="S2's forms E x C")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("s1_forms needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.kv:
        libs = {e: kv_library(e) for e in (8, 16)}
        for dtype in SHAPES:
            times = time_kv_forms(libs, dtype)
            print(f"forms tile_sort_kv_kernel {dtype}+int32 n=2^23: " + ", ".join(
                f"E={e} C={c} ({TILE_ROWS * ps.LANES // c // e} threads) {a:.4f} / {b:.4f} ms"
                for (e, c), (a, b) in times.items()) + f" [{card}]", flush=True)
        return 0
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
