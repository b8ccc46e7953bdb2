"""Times R1 (`ring_exchange_kernel`, keys alone), R2's exchange
(`ring_exchange_kernel+kv`) and S3 (`radix_histogram_kernel`) in several
builds of their sources, on one GPU, each kernel on its own.

A build is ``csrc/ring_exchange.cu`` or ``csrc/tile_sort.cu`` compiled alone
into a library of its own, either as the package has it, with one of its
form constants replaced (``--forms``: R1's vectors a lane, S3's loads a
thread and its histogram copies a block), or from
another checkout's ``dsort_tpu_torch/csrc/`` (``--against DIR``, for
example the parent commit unpacked).  The shapes are ``chip_smoke.py``
phase 5's: the ring plan of 2^26 uniform int32 keys on 8 virtual shards,
the plan of 2^23 TeraSort records, and the 8-bit digit histogram of 2^26
int32 keys::

    python3 -m dsort_tpu_torch.tools.r1_s3_forms [--against DIR] [--forms] [--only R1|S3]

Each build is first held bit for bit against the plain version.  Then,
in turns over the builds (forward, then back, ``--rounds`` times), each is
timed alone: 50 launches back to back between one pair of CUDA events,
divided by 50, each launch allocating its output as the package's wrapper
does (the old S3 on a zeroed output, the new one zeroing its own).  Prints
each build's registers and spills (``-Xptxas -v``), each reading, their
medians and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from dsort_tpu_torch.ops import _build
from dsort_tpu_torch.ops import pallas_sort as ps
from dsort_tpu_torch.ops import ring_kernel as rk

P = 8
LAUNCHES = 50
#: Forms: (file, kernel, {constant of the package's source: its value}).
FORMS = (
    ("ring_exchange.cu", "R1", {"kRingItems": 2}),
    ("ring_exchange.cu", "R1", {"kRingItems": 8}),
    ("tile_sort.cu", "S3", {"kHistItems": 2}),
    ("tile_sort.cu", "S3", {"kHistItems": 4}),
    ("tile_sort.cu", "S3", {"kHistSmemBytes": 1024}),  # one copy a block at 8 bits
)


def alone_ms(fn, launches: int = LAUNCHES, warmup: int = 3) -> float:
    """Device ms of one ``fn()`` among ``launches`` back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def build(tag: str, source: Path, consts: dict | None = None) -> ctypes.CDLL:
    """``source`` (with its headers beside it) built alone under ``tag``,
    with each ``constexpr`` named in ``consts`` set to its value; prints the
    registers, stack frame and spills of its R1 / R2 / S3 kernels."""
    out = _build.BUILD_DIR / "forms" / re.sub(r"\W+", "_", tag)
    out.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    for const, value in (consts or {}).items():
        text, hits = re.subn(rf"(constexpr (?:int|long long) {const} = )[^;]+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise RuntimeError(f"{source.name}: constexpr {const} not found once")
    (out / source.name).write_text(text)
    for header in source.parent.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
           str(out / "lib.so"), str(out / source.name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stdout}\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(_Z\w*(ring_exchange\w*kernel|radix_histogram"
                      r"_kernel)\w*)'", line)
        if m:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            frame = re.search(r"(\d+) bytes stack frame", info)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
            print(f"{tag} {m[1]}: {regs[1] if regs else '?'} registers, stack frame "
                  f"{frame[1] if frame else '?'} bytes, spill stores/loads "
                  f"{'/'.join(spill.groups()) if spill else '?'} bytes", flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def exchange(lib, xs, starts, lens, caps, payload=None):
    """R1 (or R2's exchange with ``payload``) through ``lib``, allocating as
    `ring_kernel.ring_exchange` does."""
    p, n_local = xs.shape
    p2, slot = rk._ceil_pow2(p), rk._slot_len(caps)
    total = sum(caps)
    wk = torch.empty((p, p2 * slot), dtype=xs.dtype, device=xs.device)
    wt = wv = None
    row_bytes = 0
    if payload is not None:
        row_bytes = payload.shape[2]
        wt = torch.empty((p, p2 * slot), dtype=torch.int32, device=xs.device)
        wv = torch.empty((p, total, row_bytes), dtype=torch.uint8, device=xs.device)
    fn = getattr(lib, "dsort_ring_exchange_" + ("i32" if xs.dtype == torch.int32 else "i64"))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(xs.data_ptr(), starts.data_ptr(), lens.data_ptr(), ptr(payload), wk.data_ptr(),
             ptr(wt), ptr(wv), p, n_local, slot, row_bytes, (ctypes.c_longlong * p)(*caps),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_exchange: CUDA error {err}")
    return wk, wt, wv


def histogram(lib, zeroes_itself: bool, x, shift: int = 0, bits: int = 8):
    """S3 through ``lib``: on a zeroed output for a build that adds to one,
    on an empty one for a build that zeroes its own."""
    alloc = torch.empty if zeroes_itself else torch.zeros
    out = alloc(1 << bits, dtype=torch.int32, device=x.device)
    err = lib.dsort_radix_histogram_i32(x.data_ptr(), x.numel(), shift, bits, out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"radix_histogram: CUDA error {err}")
    return out


def plans(dev):
    """Phase 5's inputs: the keys plan of 2^26 int32 and the 2^23 records'."""
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.data.partition import pad_kv_to_shards, pad_to_shards
    from dsort_tpu_torch.ops.float_order import to_signed_keys
    from dsort_tpu_torch.parallel import exchange as ex
    from dsort_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(P)
    rng = np.random.default_rng(0)
    x32 = rng.integers(-2**31, 2**31 - 1, 1 << 26, dtype=np.int32, endpoint=True)
    shards, cnt = pad_to_shards(x32, P)
    cnt_d = torch.from_numpy(cnt).to(dev)
    xs, split, hist = ex._ring_plan_shard(to_signed_keys(torch.from_numpy(shards).to(dev)),
                                          cnt_d, mesh=mesh, oversample=32, kernel="auto")
    caps = ex.ring_caps(hist.cpu().numpy(), shards.shape[1], P)
    starts, lens = ex._bucket_bounds(xs, cnt_d, split)
    tk, tv = ingest.gen_terasort(1 << 23, seed=1)
    sk, sv, kcnt = pad_kv_to_shards(tk, tv, P)
    kcnt_d = torch.from_numpy(kcnt).to(dev)
    ks, vs, ksplit, khist = ex._ring_plan_kv_shard(
        to_signed_keys(torch.from_numpy(sk).to(dev)), torch.from_numpy(sv).to(dev), kcnt_d,
        mesh=mesh, oversample=32)
    kcaps = ex.ring_caps(khist.cpu().numpy(), sk.shape[1], P)
    kstarts, klens = ex._bucket_bounds(ks, kcnt_d, ksplit)
    xh = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 1 << 26, dtype=np.int32,
                                       endpoint=True)).to(dev)
    return (xs, starts, lens, caps), (ks, kstarts, klens, kcaps, vs), xh


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, metavar="DIR",
                        help="another checkout whose dsort_tpu_torch/csrc/ is timed beside")
    parser.add_argument("--forms", action="store_true", help="also the form constants' builds")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", choices=("R1", "S3"), help="one kernel's builds alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("r1_s3_forms needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kernels = ("R1", "S3") if args.only is None else (args.only,)
    sources = {"R1": "ring_exchange.cu", "S3": "tile_sort.cu"}
    builds = {k: {"new": build(f"new {k}", _build.CSRC / sources[k])} for k in kernels}
    if args.against is not None:
        other = args.against / "dsort_tpu_torch" / "csrc"
        for k in kernels:
            builds[k]["against"] = build(f"against {k}", other / sources[k])
    if args.forms:
        for file, kernel, consts in FORMS:
            if kernel in kernels:
                tag = " ".join(f"{c}={v}" for c, v in consts.items())
                builds[kernel][tag] = build(f"{kernel} {tag}", _build.CSRC / file, consts)
    zeroes = {"new": "cudaMemsetAsync" in (_build.CSRC / "tile_sort.cu").read_text()}
    if args.against is not None:
        zeroes["against"] = "cudaMemsetAsync" in (
            args.against / "dsort_tpu_torch" / "csrc" / "tile_sort.cu").read_text()
    ring_builds, tile_builds = builds.get("R1", {}), builds.get("S3", {})
    keys, recs, xh = plans(dev)
    want_keys = rk.ring_exchange_plain(*keys)[0] if ring_builds else None
    want_kv = rk.ring_exchange_plain(*recs) if ring_builds else None
    want_hist = ps.radix_histogram_plain(xh, 0, 8)
    runs = {}
    for tag, lib in ring_builds.items():
        if not torch.equal(exchange(lib, *keys)[0], want_keys):
            raise AssertionError(f"R1 {tag}: disagrees with its plain version")
        runs[f"R1 {tag}"] = lambda lib=lib: exchange(lib, *keys)
        if tag in ("new", "against"):
            got = exchange(lib, *recs)
            if not all(torch.equal(g, w) for g, w in zip(got, want_kv)):
                raise AssertionError(f"R2 exchange {tag}: disagrees with its plain version")
            runs[f"R2 exchange {tag}"] = lambda lib=lib: exchange(lib, *recs)
    for tag, lib in tile_builds.items():
        z = zeroes.get(tag, zeroes["new"])
        if not torch.equal(histogram(lib, z, xh), want_hist):
            raise AssertionError(f"S3 {tag}: disagrees with its plain version")
        runs[f"S3 {tag}"] = lambda lib=lib, z=z: histogram(lib, z, xh)
    del want_keys, want_kv
    print(f"checked {len(runs)} builds against the plain versions: bit-identical=True "
          f"(R1 caps {keys[3]}, R2 caps {recs[3]})", flush=True)
    times = {name: [] for name in runs}
    order = list(runs)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            times[name].append(alone_ms(runs[name]))
    for name, ts in times.items():
        print(f"alone {name}: median {float(np.median(ts)):.4f} ms of "
              f"{', '.join(f'{t:.4f}' for t in ts)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
