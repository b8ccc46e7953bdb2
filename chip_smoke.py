#!/usr/bin/env python3
"""Build and drive dsort_tpu_torch on one NVIDIA GPU, and check every result.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. build the CUDA kernels from ``dsort_tpu_torch/csrc/`` (timed);
2. hold each kernel bit-for-bit against its plain PyTorch version at the
   main path's shapes, for int32 and int64 keys;
3. whole sorts: ``block_sort`` at 2^24 and 2^26 int32 and 2^24 int64, and
   ``block_merge_runs`` at the post-exchange shape, each equal to torch.sort;
4. the main path, ``SampleSort(VirtualMesh(8)).sort`` under the default
   ``auto`` kernels: 2^26 uniform int32 (launch counts reset just before and
   read just after), 2^24 zipf int64 (must take the capacity retry), 2^20
   float32 with NaN/±0.0/±inf, and ``cli run`` on a 10^6-line text file;
   each output equal to numpy's;
5. timings at the main path's shapes: each kernel, its plain version and
   the nearest torch call (``library_ms``), the bound, and the end-to-end
   sort against torch.sort.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and last ``{"ok": true, "device": {...}}``.  Needs one GPU; exits
non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
P = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores (data sheet)
SOURCE = "dsort_tpu_torch/csrc/block_sort.cu"
REPLACES = {
    "bitonic_tile_kernel":
        "dsort_tpu/ops/block_sort.py:419 (K1 _tile_sort_cm_kernel), "
        ":440 (K1b _sort_levels_kernel)",
    "bitonic_global_stage_kernel":
        "dsort_tpu/ops/block_sort.py:466 (K2 _cross_kernel), "
        ":722 (K2c _orbit_kernel)",
    "bitonic_tile_merge_kernel":
        "dsort_tpu/ops/block_sort.py:567 (K2a _span_low_kernel), "
        ":493 (K2b/K3 _span_tail_kernel)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn()``, which ends in a device sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(n: int, itemsize: int, compare_exchanges: int) -> tuple[float, str]:
    """Least time for the work: each key read and written once over HBM, or
    a min and a max per compare-exchange at the ALU peak, the larger."""
    by_bytes = 2 * n * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * compare_exchanges / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def random_keys(rng, shape, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def ordered_float_reference(x: np.ndarray) -> np.ndarray:
    """numpy float32 sort in the total order the package documents: -0.0
    before +0.0, NaNs last and canonical."""
    b = x.view(np.int32)
    top = np.int32(np.iinfo(np.int32).max)
    s = np.where(b < 0, b ^ top, b)
    s = np.where(np.isnan(x), top, s)
    s.sort()
    out = np.where(s < 0, s ^ top, s).view(np.float32)
    return np.where(s == top, np.float32(np.nan), out)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}")
    )


def profile_sort(fn, card: str) -> None:
    """One traced run of ``fn``: device time by kernel or copy, and the
    device's busy share of the wall time (torch.profiler over CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for ms, _ in by_name.values())
    log(f"trace SampleSort int32 n=2^26: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall) [{card}]")
    for name, (ms, count) in rows[:10]:
        log(f"  device {ms:9.3f} ms  x{count:<4d} {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.ops import _build
    from dsort_tpu_torch.ops import block_sort as tb
    from dsort_tpu_torch.ops.float_order import float_to_ordered_int
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort, cap_pair_policy
    from dsort_tpu_torch.utils.metrics import Metrics

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {nvcc}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    T = tb.TILE

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    nvcc = "reused" if _build.last_build_s is None else f"nvcc {_build.last_build_s:.2f} s"
    _build.library()
    log(f"build: {lib_path.name} {nvcc}, total with load {time.perf_counter() - t0:.2f} s")

    # 2. kernel vs plain at the main path's shapes ---------------------------
    n32, n64 = 1 << 26, 1 << 24
    shapes = {np.int32: (P, n32 // P), np.int64: (P, n64 // P)}
    err = dict.fromkeys(tb.WRAPPERS, 0.0)
    for dtype, (rows, row_len) in shapes.items():
        x = torch.from_numpy(random_keys(rng, (rows, row_len), dtype)).to(dev)
        checks = [
            ("bitonic_tile_kernel", lambda t: tb.bitonic_tile(t, T),
             lambda t: tb.tile_sort_plain(t, T)),
            ("bitonic_tile_kernel", lambda t: tb.bitonic_tile(t, T, 512),
             lambda t: tb.tile_sort_plain(t, T, 512)),
            ("bitonic_global_stage_kernel",
             lambda t: tb.bitonic_global_stage(t, row_len, row_len // 2),
             lambda t: tb.global_stage_plain(t, row_len, row_len // 2)),
            ("bitonic_global_stage_kernel",
             lambda t: tb.bitonic_global_stage(t, row_len // 2, T),
             lambda t: tb.global_stage_plain(t, row_len // 2, T)),
            ("bitonic_tile_merge_kernel", lambda t: tb.bitonic_tile_merge(t, T, row_len),
             lambda t: tb.tile_merge_plain(t, T, row_len)),
        ]
        for name, kernel, plain in checks:
            got, want = kernel(x.clone()), plain(x.clone())
            torch.cuda.synchronize()
            e = float((got.double() - want.double()).abs().max())
            same = torch.equal(got, want)
            log(f"check {name} {np.dtype(dtype).name} {rows}x{row_len}: "
                f"bit-identical={same} max_abs_err={e}")
            if not same:
                raise AssertionError(f"{name} disagrees with its plain version")
            err[name] = max(err[name], e)
        del x, got, want

    # 3. whole sorts against torch.sort ---------------------------------------
    for dtype, n in ((np.int32, 1 << 24), (np.int32, n32), (np.int64, n64)):
        x = torch.from_numpy(random_keys(rng, n, dtype)).to(dev)
        if not torch.equal(tb.block_sort(x), torch.sort(x).values):
            raise AssertionError(f"block_sort {np.dtype(dtype).name} 2^{n.bit_length() - 1}")
        log(f"block_sort {np.dtype(dtype).name} n=2^{n.bit_length() - 1}: equal to torch.sort")
    cap = cap_pair_policy(n32 // P, 1.3, P)
    runs = torch.sort(torch.from_numpy(random_keys(rng, (P, P, cap), np.int32)).to(dev)).values
    if not torch.equal(tb.block_merge_runs(runs), torch.sort(runs.view(P, -1)).values):
        raise AssertionError("block_merge_runs at the post-exchange shape")
    log(f"block_merge_runs {P}x{P}x{cap} int32: equal to torch.sort")
    del x, runs

    # 4. the main path ----------------------------------------------------------
    mesh = VirtualMesh(P)
    ss = SampleSort(mesh)

    def drive(label, data, reference, metrics=None):
        tb.reset_launch_counts()
        t0 = time.perf_counter()
        out = ss.sort(data, metrics)
        wall = time.perf_counter() - t0
        counts = tb.launch_counts()
        if not same_bits(out, reference):
            raise AssertionError(f"{label}: output differs from numpy")
        if not all(counts.values()):
            raise AssertionError(f"{label}: a kernel was not launched: {counts}")
        log(f"main {label}: equal to numpy, {wall * 1e3:.1f} ms wall, launches {counts}")
        keys = data
        if data.dtype.kind == "f":  # sort_ranges takes the mapped keys
            keys = float_to_ordered_int(torch.from_numpy(data)).numpy()
        log(f"  per-shard counts {[len(r) for r in ss.sort_ranges(keys)]}")
        return counts

    x32 = random_keys(rng, n32, np.int32)
    main_launches = drive("uniform int32 n=2^26", x32, np.sort(x32))

    z = np.minimum(rng.zipf(1.3, n64), np.iinfo(np.int64).max).astype(np.int64)
    m = Metrics()
    drive("zipf(1.3) int64 n=2^24", z, np.sort(z), m)
    retries = m.counters.get("capacity_retries", 0)
    log(f"  capacity_retries={retries}")
    if retries < 1:
        raise AssertionError("zipf int64 did not take the capacity retry")

    f = (rng.standard_normal(1 << 20) * 1e3).astype(np.float32)
    specials = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45, -1e-45],
                        np.float32)
    f[rng.choice(f.size, 4096, replace=False)] = np.resize(specials, 4096)
    drive("float32 with NaN/±0/±inf n=2^20", f, ordered_float_reference(f))
    if not np.array_equal(ss.sort(f), np.sort(f), equal_nan=True):
        raise AssertionError("float32 values differ from np.sort")

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    xt = random_keys(rng, 10**6, np.int32)
    src, dst = work / "input.txt", work / "output.txt"
    src.write_text("".join(f"{v}\n" for v in xt.tolist()))
    tb.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main(["run", str(src), "-o", str(dst)]) != 0:
        raise AssertionError("cli run failed")
    wall = time.perf_counter() - t0
    counts = tb.launch_counts()
    if dst.read_bytes() != "".join(f"{v}\n" for v in np.sort(xt).tolist()).encode():
        raise AssertionError("cli output differs from the numpy-formatted sorted file")
    if not all(counts.values()):
        raise AssertionError(f"cli run: a kernel was not launched: {counts}")
    log(f"main cli run 10^6 lines: byte-identical, {wall * 1e3:.1f} ms wall, launches {counts}")

    # 5. timings at the main path's shapes (int32, 2^26 keys) -----------------
    rows, row_len = shapes[np.int32]
    n = rows * row_len
    x = torch.from_numpy(random_keys(rng, (rows, row_len), np.int32)).to(dev)
    log_t = T.bit_length() - 1
    stages_tile = log_t * (log_t + 1) // 2  # levels 2..T, log2(k) stages each
    timed = {
        "bitonic_tile_kernel": (
            lambda: tb.bitonic_tile(x, T), lambda: tb.tile_sort_plain(x, T),
            lambda: torch.sort(x.view(-1, T), dim=-1), n // 2 * stages_tile,
        ),
        "bitonic_global_stage_kernel": (
            lambda: tb.bitonic_global_stage(x, row_len, row_len // 2),
            lambda: tb.global_stage_plain(x, row_len, row_len // 2), None, n // 2,
        ),
        "bitonic_tile_merge_kernel": (
            lambda: tb.bitonic_tile_merge(x, T, row_len),
            lambda: tb.tile_merge_plain(x, T, row_len), None,
            n // 2 * log_t,
        ),
    }
    kernels = []
    for name, (kernel, plain, library, cmpx) in timed.items():
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=5, warmup=1)
        library_ms = cuda_ms(library) if library is not None else None
        b_ms, b_by = bound_ms(n, 4, cmpx)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": main_launches[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
        })
        log(f"time {name} int32 {rows}x{row_len}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    xf = torch.from_numpy(x32).to(dev)
    bs_ms = cuda_ms(lambda: tb.block_sort(xf), reps=5)
    ts_ms = cuda_ms(lambda: torch.sort(xf), reps=5)
    e2e_ms = host_ms(lambda: ss.sort(x32))
    log(f"time block_sort int32 n=2^26: {bs_ms:.3f} ms ({n32 / bs_ms / 1e6:.3f} Gkeys/s), "
        f"torch.sort {ts_ms:.3f} ms ({n32 / ts_ms / 1e6:.3f} Gkeys/s) [{card}]")
    log(f"time SampleSort(VirtualMesh(8)).sort int32 n=2^26 host-to-host: {e2e_ms:.3f} ms "
        f"({n32 / e2e_ms / 1e6:.3f} Gkeys/s), library_ms (torch.sort on device) "
        f"{ts_ms:.3f} ms [{card}]")

    m = Metrics()
    ss.sort(x32, m)
    log(f"phases SampleSort int32 n=2^26: {json.dumps(m.summary())} [{card}]")
    profile_sort(lambda: ss.sort(x32), card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
