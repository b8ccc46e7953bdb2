#!/usr/bin/env python3
"""Build and drive dsort_tpu_torch on one NVIDIA GPU, and check every result.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. build the CUDA kernels from ``dsort_tpu_torch/csrc/`` (one nvcc per
   source) and the native host library from ``dsort_tpu_torch/runtime/
   native/`` (one g++ per source), all started together; timed;
2. hold each kernel bit-for-bit against its plain PyTorch version at the
   main path's shapes: the block kernels for int32 and int64 keys, keys
   alone and with the int32 rank plane; the global-stage kernel for every
   stage count S = 1..S_max, at the top group of the top level and the
   bottom group (j_low = T) of a lower one; the tile merge at k = row_len
   and at k = 2T (tiles of both directions in a row); the tile kernel and
   the tile merge also at every tile they admit (2 keys up to 8192 / 4096),
   the tile kernel at k_start in {2, 4, T/2, T}, the merge at k in {2T, 4T,
   8T}, with full (key, rank) ties and extreme keys; the ring exchange
   kernel on the plan of a 2^26 int32 sort (keys) and of a 2^23-record
   TeraSort sort (kv), and keys alone on the edges of its vector form (P of
   2, 3, 5, 8, slots of 1 to 4096 keys, bucket starts at every offset mod
   4, lengths 0, 1, 3, cap - 1, cap, above cap, sentinel keys inside
   buckets, shards off a 16-byte boundary); the payload gather with
   92-byte rows, and swept over
   rows of 1, 13, 16, 92, 100 and 256 bytes, a ``total`` that is not a
   multiple of 32, tags read from wider rows and tags out of range; S1 at
   every ``tile_rows`` the wrapper admits (1..2048 int32, 1..1024 int64: 1
   to 8 CTAs a tile); S2 at every ``tile_rows`` it admits (1..1024, both key
   types, 1 to 8 CTAs a tile) on random, % 7 and extreme keys, each with the
   index as an arange, a permutation and with repeated (key, index) pairs;
   S3 at 2^26 int32 and 2^24 int64 (five digits each), and on its vector
   form's edges: every key type at bases 0-3 keys past a 16-byte boundary,
   n of 0, 1, 15 and 2^20 + 7, 1, 2^8, 2^13 and 2^14 buckets, shifts at and
   past the key's width;
3. whole sorts: ``block_sort`` at 2^24 and 2^26 int32 and 2^24 int64, and
   ``block_merge_runs`` at the post-exchange shape, each equal to torch.sort;
4. the main paths, each driven with the launch counts set to 0 just before
   and read just after (the global-stage launches beside the stages they
   ran, each level's cross stages in ceil(g / S_max) passes), each output
   checked against numpy:
   ``SampleSort(VirtualMesh(8)).sort`` under the default ``alltoall`` at
   2^26 uniform int32, 2^24 zipf int64 (must take the capacity retry) and
   2^20 float32 with NaN/±0.0/±inf, and ``cli run`` on a 10^6-line file
   (under 2^20 keys: the fused route, one padded row of 2^20 through the
   block kernels and no exchange, as ``dsort run`` in its default mode);
   the same sort under ``ring`` and ``fused`` at 2^26 int32 and 2^24 zipf
   int64 (no capacity retry, one exchange launch per fused sort);
   ``sort_kv`` of 2^23 TeraSort records under all three exchanges, 2^22
   zipf records under ``fused`` (record multiset per key), and ``cli
   terasort`` on a 2^20-record file (byte-identical to numpy's order);
   ``local_kernel="pallas"`` (the tile kernel in phase 1 and phase 5) at
   2^26 int32 under ``alltoall`` and ``ring`` and 2^24 zipf int64 under
   ``alltoall``, with the default path's per-shard counts;
   ``merge_kernel="bitonic"`` at 2^24 int32 and for 2^23 records;
   ``pallas_sort_kv`` on 2^23 TeraSort and 2^22 zipf records (stable);
   ``cli run --kernel pallas``;
5. timings at the main path's shapes: each kernel (one call, and alone: 50
   calls back to back over one pair of events), its plain version and
   the nearest torch call (``library_ms``), the bound; a contiguous copy
   of the gather's bytes beside the gather; the global-stage
   kernel's pass at every S; the host-to-host
   sorts under each exchange and under ``pallas`` against ``auto``;
   ``pallas_sort`` / ``pallas_sort_kv`` against ``torch.sort``; records/s
   of ``sort_kv``; the tile merge also at the post-exchange shape (8 x
   2^24 int32); S1 also at 8 x 2^21 int64 and at phase 5's padded shape
   in the ``pallas`` sort of 2^26; device traces,
   with the traced sums of the global-stage kernel and of the tile merge in
   the 2^26 sort, in ``block_sort`` of 2^26 and in the 2^23-record
   ``fused`` sort, and of S1 in the ``pallas`` sort of 2^26 and in ``cli
   run --kernel pallas``, of the gather in the ``fused`` 2^23-record
   ``sort_kv`` and of S2 in ``pallas_sort_kv`` of the 2^23 records;
6. the fault plane (`fault_plane`): ``SpmdScheduler(8).sort`` of 2^26 int32
   beside ``SampleSort`` in turns (the scheduler's own cost); a worker lost
   before dispatch (7 survivors) and two lost in turn (6), at 2^26 int32; a
   worker lost between the ring plan and the exchange under ``ring`` and
   ``fused`` at 2^24 zipf int64 (7 + 6 ring steps, two fused plans, one
   exchange launch); a hang with healthy probes (bounded retry) and a hang
   with a failed probe (re-form), each detected before the hang ends and
   drained after; every worker dead (a clean `JobFailedError`); the probe's
   round trip; one real device-side assert in a child process (a program
   error: it propagates with no probe or re-form); the time to recover from
   a loss before dispatch, a mid-ring loss and a hang, faulted minus healthy
   in turns.  Every output is checked against numpy, every counter and
   journal order asserted, and the re-runs' launch counts printed;
7. the small-job route and the task pool (`small_jobs_and_taskpool`): the
   block kernels and S1 on one row of 2^16 and 2^20 keys against their
   plain versions (every S of the global stage the row allows), and
   ``block_sort`` / ``pallas_sort`` of one row at every fused rung from
   2^16 to 2^20 against torch.sort; ``fused_sort_small`` at 2^16, 2^17 + 3
   and 2^20 − 1 (int32, int64, uint32), 2^20 − 1 float32 with NaN/±0/±inf
   and under ``pallas``, none of the block kernels below a 2^16-key rung;
   ``GatherMergeSort`` at 2^24; ``cli run`` on 2^21 lines (through
   ``SpmdScheduler``) and ``--mode local`` / ``--mode taskpool`` on phase
   4's file; a fallback drill (a CUDA-named device error on the fused
   route); the task pool at 2^24 int32 — healthy, a worker killed before
   dispatch, a ``recv`` failure, a 3 s hang detected at the 1 s wait, every
   worker dead; host-to-host medians in turns of the fused route against
   ``SpmdScheduler.sort`` at 2^14, 2^17 and 2^20 − 1 and of the task pool
   against it at 2^24; the task pool's time to recover per drill;
8. device-resident results (`device_resident`): ``sort(keep_on_device=True)``
   of phase 4's 2^26 int32 under ``alltoall``, ``ring`` and ``fused`` and
   2^24 zipf int64, each with its launches, at most 4 KiB copied to the host
   before ``to_host()`` (counted per aten copy), ``validate_on_device()``
   (at most 64 bytes back) equal to the input's host checksum, ``to_host()``
   equal to numpy's bits and lengths equal to ``sort_ranges``'; one traced
   ``fused`` keep_on_device sort; host-to-host medians in turns (A B C C B
   A) of ``sort()``, keep_on_device plus ``validate_on_device()`` and keep
   plus ``to_host()``; the validator alone by CUDA events against its bound;
   the validator on rows built on the card for all eight integer dtypes,
   with an in-row and a boundary break; ``fused_sort_small(keep_on_device=
   True)`` at 2^16 and 2^20 − 1 read from another thread; the re-run drill
   (a later job loses worker 2, the handle re-runs once at ``to_host()``);
   ``cli run --device-resident`` on phase 4's file against its ``cli run``,
   ``cli validate --against`` (0, then 1 with two lines swapped), ``cli
   gen`` of 2^20 lines;
9. the rest of the exchange plane (`exchange_plane`): ``hier`` at 2^26
   int32 with 2 and 4 hosts and at 2^24 zipf int64 with 2 (numpy's bits,
   ring's per-shard counts, the wire-byte counters equal to the plan's,
   the block kernels launched), in turns against ``ring``, and the
   ``hier_reform`` drill (one worker, then one host lost); the coded plane
   at 2^26 int32 (replicate r = 2, parity r = 2 and 3: bits, launches,
   ``coded_replica_bytes`` against the wire model, peak memory, in turns
   against ``ring``) and on the 2^23 records (replicate and parity r = 2);
   ``SpmdScheduler(8)`` drills at 2^26 int32 r = 2: a mid-ring loss
   recovered with one ``attempt_start`` and one local-sort launch (the
   host copy and the host merge timed apart), its time to recover beside
   the uncoded re-run's, two adjacent losses over budget then re-run, and
   the straggler race (``slow(5, 0.5)``: one ``coded_straggler_serve``,
   under healthy + 0.5 s, the owner leg drained); ``local_kernel="radix"``
   at 2^26 int32 and ``radix_sort`` / ``radix_sort_kv`` against
   ``torch.sort``; ``cli run --redundancy 2`` on phase 4's file (not the
   fused route), ``--exchange hier`` on it (the fused route) and on 2^21
   lines (the scheduler, hier's plan journaled);
10. recovery and out-of-core (`out_of_core`), each dataset 8 times its
   per-run or per-wave budget, spilled to a temporary directory: the
   ``ExternalSort`` of phase 4's 2^26 int32 from a binary file in 8 runs
   (the block kernels' launches 8 times ``block_sort``'s at 2^23), under
   ``local_kernel="pallas"`` (8 S1 launches), 2^24 float32 with NaN/±0/±inf
   in 4 runs, its resume after 3 run files are deleted and a reused
   ``job_id`` on other data; ``ExternalWaveSort(VirtualMesh(8))`` of the
   file in 8 waves under ``ring``, ``fused`` (8 R1 launches), ``hier`` (2
   hosts) and coded replicate r = 2, its peak allocation under half of
   phase 9's in-memory ``ring`` peak, the 2^24 zipf int64 in 8 waves, the
   overlap on against off in turns; the wave drills (a loss in wave 4's
   ring repaired on the host, the same under r = 2 from the plane, the
   crash drill: a child ``cli external --mesh 8`` with
   ``DSORT_WAVE_DIE_AFTER_WAVE=3`` exits 17 with 32 runs durable and the
   re-run resumes them); ``ExternalTeraSort`` / ``ExternalWaveTeraSort`` /
   ``cli terasort --external [--mesh 8]`` of phase 5's 2^23 records beside
   the in-memory ``sort_kv``; ``SpmdScheduler(8)`` at 2^26 with and without
   ``checkpoint_dir`` in turns, a loss at ``assemble`` (5 ranges restored,
   about 3/8 of the keys re-sorted, the time to recover), the full restore
   (zero launches), the task pool's re-run at 2^24 (8 shards restored,
   zero launches) and ``cli run --checkpoint-dir --job-id`` (the scheduler,
   then the restore);
11. the batch and multi-process planes (`batch_and_multiprocess`):
   `BatchSampleSort` buckets against single sorts, records, its checkpoint
   drill and ``cli batch``; two ranks of a gloo group on the card, under
   the all-to-all and ``hier``, and the crash drill;
12. the serving plane (`serving`): `SortService` on ``VirtualMesh(8)`` in
   8 slices, each a CUDA stream: 3 tenants x 4 jobs of 2^19 / 2^18 int32
   beside phase 4's 2^26 job on the whole mesh, every output numpy's bits,
   a small job's and the big job's launches equal to `fused_sort_small`'s
   and `SpmdScheduler.sort`'s and the window's to their sum; jobs/s, the
   queue wait's p95 per tenant from ``job_dequeued``, the variant cache's
   hit rate (a gate: at least 0.5); the packed window against one slice in
   turns; int64, float32 and ``pallas`` jobs; a big job under ``fused``
   (one R1 launch); a slice loss (the time to recover in turns), a hang on
   a slice, a re-form under the big job; the admission verdicts and
   weights; ``cli serve`` as a subprocess (a ``/metrics`` scrape on
   localhost, SIGINT with a job queued, exit 0, the drained journal); the
   planner's exchange at 2^26 uniform int32 and 2^24 zipf int64; a real
   device-side assert in a child service (``--serve-real-error-child``:
   every slice retired, the queued job failed, no hang);
13. the introspection plane (`introspection`): ``SpmdScheduler.sort`` of
   2^26 int32 under ``alltoall`` and ``fused``, journaled into a journal
   that rotates at 4 KiB, memwatched and ledgered (one ``variant_compiled``
   per new variant, none on a repeat, the same launches as an unobserved
   run; the on/off host-to-host medians in turns), ``cli report --analyze
   --analyze-json --chrome-trace`` on the rotated set; ``cli terasort
   --journal --memwatch`` of the 2^23 records and their ``fused`` sort_kv
   (R2 and the gather) journaled, ``cli report --conform``; two ranks of
   `tools.mh_proc` on the card with journals and a flight directory, their
   merged verdict held to the journals' own records, and the crash drill's
   merged trace and postmortem bundle; ``cli top`` against a ``cli serve
   --metrics-port`` subprocess and against a closed port; every journal
   of phases 8-13 against the trace contracts;
14. the native runtime (`native_runtime`): the library loaded and its
   selftest binary built and run; native against plain in turns (plain
   native native plain), each pair bit-identical: ``merge_sorted_host`` of
   8 runs of 2^23 int32 against the numpy pairwise merge,
   ``read_ints_file`` / ``write_ints_file`` of phase 4's 10^6-line file and
   of a 2^24-line file against the numpy grammar and the Python formatter,
   ``fnv_multiset`` / ``check_order_be`` over the 2^23 records against
   ``_fnv_multiset_py`` / ``_check_order_chunk``; ``ExternalSort`` of the
   2^26 int32 in 8 runs and ``ExternalWaveTeraSort`` of the 2^23 records,
   each exact with ``native_merges`` counted; ``NativeCoordinator`` with 4
   ``runtime.worker`` processes sorting on the card (``--backend torch``,
   ``--kernel auto``): 2^26 uniform int32 and 2^24 zipf int64 (numpy's
   bits, the partition / dispatch / collect / merge phases); one
   `SortWorker` in this process sorting a 2^24 int32 chunk (its K1, K2 and
   tile-merge launches counted, held against the same network through the
   plain versions on the card, ``torch.sort`` and numpy), and under
   ``--kernel pallas`` (S1); the SURVEY §0 drill (``kill -9`` of worker 0
   right after its chunk is dispatched: exact, ``worker_dead`` and
   ``reassign`` journaled, the time to recover as faulted minus healthy in
   turns, a fresh cluster for each faulted turn); ``cli coordinator
   --workers 4`` with 4 ``cli worker`` processes over stdin, its output
   byte-identical to ``sort -n``, exit 0.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and last ``{"ok": true, "device": {...}}``.  Needs one GPU; exits
non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
P = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores (data sheet)
SOURCES = {
    "block": "dsort_tpu_torch/csrc/block_sort.cu",
    "ring": "dsort_tpu_torch/csrc/ring_exchange.cu",
    "tile": "dsort_tpu_torch/csrc/tile_sort.cu",
}
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
    "ring_exchange_kernel": "dsort_tpu/ops/ring_kernel.py:280 (R1 _fused_ring_kernel)",
    "ring_exchange_kernel+kv": "dsort_tpu/ops/ring_kernel.py:356 (R2 _fused_ring_kv_kernel)",
    "gather_rows_kernel":
        "dsort_tpu/ops/ring_kernel.py:356 (R2 _fused_ring_kv_kernel, in-kernel "
        "payload placement :467-477)",
    "tile_sort_kernel": "dsort_tpu/ops/pallas_sort.py:37 (S1 _tile_bitonic_kernel)",
    "tile_sort_kv_kernel": "dsort_tpu/ops/pallas_sort.py:106 (S2 _tile_bitonic_kv_kernel)",
    "radix_histogram_kernel": "dsort_tpu/ops/pallas_sort.py:223 (S3 _tile_histogram_kernel)",
}
RANK = "+rank"
# Phase 11's sizes: the batch's big jobs, its 64 small jobs, its record
# jobs; each rank's keys and records in the 2-rank cluster; the crash
# drill's keys in all.
BATCH_BIG, BATCH_MANY, BATCH_RECORDS = 1 << 23, 1 << 16, 1 << 21
MH_KEYS, MH_RECORDS, MH_DRILL = 1 << 25, 1 << 22, 1 << 24
# Phase 13's sizes: each rank's keys in the journaled 2-rank run, and the
# crash drill's keys in all.
INTRO_MH_KEYS, INTRO_MH_DRILL = 1 << 22, 1 << 22


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


def cuda_ms_alone(fn, launches: int = 50, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call on its own: ``launches`` calls back
    to back between one pair of CUDA events, divided by ``launches``.  The
    host's work around each call (the wrapper's checks, its allocation, the
    ctypes call) overlaps the device's, so it counts only where it is
    longer than a launch.  Each call's result is dropped before the next
    call, so the caching allocator hands the next call the same memory."""
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


def host_times(fn, reps: int) -> list[float]:
    """Host wall times (ms) of ``reps`` calls of ``fn()``, each ending in a
    device sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: its bytes over HBM, or its operations at the
    ALU peak, the larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def random_keys(rng, shape, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def tile_limit(dtype, ranked: bool) -> int:
    """The largest tile `bitonic_tile` admits: 48 KB of keys (and ranks)."""
    return 8192 if dtype == np.int32 and not ranked else 4096


def tile_inputs(rng, shape, dtype, ranked: bool) -> list:
    """``(label, keys, ranks)`` for the tile sweep: random keys; keys ``% 7``
    with a permutation rank plane and with many equal ranks (full
    ``(key, rank)`` ties); INT_MIN / INT_MAX / sentinel-valued keys."""
    n = int(np.prod(shape))
    perm = rng.permutation(n).astype(np.int32).reshape(shape)
    out = [("random", random_keys(rng, shape, dtype), perm)]
    if ranked:
        mod7 = random_keys(rng, shape, dtype) % 7
        out += [("% 7 keys, permuted ranks", mod7, perm),
                ("% 7 keys, ranks in {0, 1, 2}", mod7, rng.integers(0, 3, shape).astype(np.int32))]
    info, i32 = np.iinfo(dtype), np.iinfo(np.int32)
    extremes = np.array([info.min, info.max, info.max - 1, info.min + 1, 0, -1], dtype)
    out.append(("INT_MIN / INT_MAX / sentinel keys", rng.choice(extremes, shape),
                rng.choice(np.array([i32.max, i32.min, 0], np.int32), shape)))
    return out


def edge_exchange_inputs(rng, p, n_local, dtype, cap_base, sentinel_run):
    """Sorted shards (their top third sentinel-valued keys when
    ``sentinel_run``), step caps near ``cap_base``, each bucket's start at
    the next offset modulo 4 in turn and its length 0, 1, 3, cap - 1, cap or
    cap + 5 (clipped to cap by the kernel) in turn, every bucket inside its
    shard."""
    caps = tuple(max(1, cap_base + int(rng.integers(-(cap_base // 4), cap_base // 4 + 1)))
                 for _ in range(p))
    xs = np.sort(random_keys(rng, (p, n_local), dtype), axis=1)
    if sentinel_run:
        xs[:, n_local - n_local // 3:] = np.iinfo(dtype).max
    starts = np.zeros((p, p), np.int64)
    lens = np.zeros((p, p), np.int64)
    for i in range(p * p):
        s, d = divmod(i, p)
        cap = caps[(d - s) % p]
        ln = min((0, 1, 3, cap - 1, cap, cap + 5)[i % 6], n_local)
        room = n_local - min(ln, cap)
        st = int(rng.integers(0, room // 4 + 1)) * 4 + i % 4
        starts[s, d], lens[s, d] = (st if st <= room else room), ln
    return xs, starts, lens, caps


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


def phases_ms(m, prefix: str) -> dict:
    """The phases of ``m`` whose names start with ``prefix``, in ms."""
    return {k: round(v * 1e3, 3) for k, v in m.phase_s.items() if k.startswith(prefix)}


class Journal:
    """`Metrics` journal seam: keeps every event as ``(type, fields)``."""

    def __init__(self):
        self.events = []

    def emit(self, etype, **fields):
        self.events.append((etype, fields))
        return types.SimpleNamespace(mono=time.monotonic())

    def of(self, etype):
        return [f for t, f in self.events if t == etype]


class JournalCensus:
    """Every journal the phases from 8 on write, for phase 13.5's contract
    check: each `EventLog` made in this process (its records read at the
    check), each JSONL journal read back with `EventLog.read_jsonl` (the
    subprocesses' and the CLI's), and each directory of journals a phase
    hands over before deleting it (`add_dir`: the ranks' journals)."""

    def __init__(self):
        from dsort_tpu_torch.utils.events import EventLog

        self.logs: list = []
        self.files: list[tuple[str, list]] = []
        self._cls = EventLog
        self._init, self._read = EventLog.__init__, EventLog.read_jsonl
        census = self

        def init(log, *a, **kw):
            census._init(log, *a, **kw)
            census.logs.append(log)

        def read(path):
            recs = census._read(path)
            census.files.append((str(path), recs))
            return recs

        EventLog.__init__ = init
        EventLog.read_jsonl = staticmethod(read)

    def add_dir(self, d) -> None:
        from dsort_tpu_torch.obs.merge import group_rotated, read_journal_set

        paths = sorted(str(p) for p in Path(d).rglob("*.jsonl*") if p.is_file())
        for group in group_rotated(paths):
            self.files.append((group[-1], read_journal_set(group)[0]))

    def journals(self) -> list[tuple[str, list]]:
        """``(label, records)`` of every journal seen, the in-process logs
        first."""
        out = [(f"EventLog #{i}", [e.to_dict() for e in log.events()])
               for i, log in enumerate(self.logs)]
        return out + self.files

    def close(self) -> None:
        self._cls.__init__ = self._init
        self._cls.read_jsonl = staticmethod(self._read)


#: Phase 13.5's census of journals, set by `main` before phase 8.
CENSUS: JournalCensus | None = None


def profile(fn, label: str, card: str) -> dict[str, list]:
    """One traced run of ``fn``: device time by kernel or copy, and the
    device's busy share of the wall time (torch.profiler over CUPTI);
    returns ``{name: [ms, count, [ms of each launch]]}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0, []])
            acc[2].append(e.time_range.elapsed_us() / 1e3)
            acc[0] += acc[2][-1]
            acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(v[0] for v in by_name.values())
    log(f"trace {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall) [{card}]")
    for name, (ms, count, _) in rows[:10]:
        log(f"  device {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return by_name


def traced(by_name: dict[str, list], kernel: str) -> tuple[float, int]:
    """Summed device ms and launches of every instantiation of ``kernel``."""
    hits = [v for name, v in by_name.items() if kernel + "<" in name]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def traced_launches(by_name: dict[str, list], kernel: str) -> list[float]:
    """Device ms of each launch of ``kernel``, every instantiation."""
    return [ms for name, v in by_name.items() if kernel + "<" in name for ms in v[2]]


class StageTally:
    """Records each `bitonic_global_stage` call of the host loop, so a run
    can show its passes beside the stages they ran.  Patches the module
    attribute the host loop calls; the wrapper itself runs unchanged."""

    def __init__(self, tb):
        self.tb, self.real, self.calls = tb, tb.bitonic_global_stage, []

        def spy(x, k, j, r=None, stages=1):
            self.calls.append((k, j, stages, r is not None, x.dtype))
            return self.real(x, k, j, r, stages)

        tb.bitonic_global_stage = spy

    def close(self):
        self.tb.bitonic_global_stage = self.real

    def summary(self, ranked: bool) -> tuple[int, int, int]:
        """``(stages, passes, least passes)`` of one plane: the least is
        sum over levels of ceil(g / S_max), a level's calls starting at
        j = k/2."""
        calls = [c for c in self.calls if c[3] == ranked]
        levels = []
        for k, j, s, _, dtype in calls:
            if j == k // 2:
                levels.append([0, self.tb.STAGES_MAX[(dtype, ranked)]])
            levels[-1][0] += s
        least = sum(-(-g // s_max) for g, s_max in levels)
        return sum(c[2] for c in calls), len(calls), least


def wait_idle(sched, tag: str = "spmd", limit_s: float = 60.0) -> float:
    """Wait until the scheduler's full-mesh lane is idle: an attempt
    abandoned by a lapsed wait runs on to its end there, beside whatever
    runs next.  Returns the seconds waited."""
    t0 = time.monotonic()
    while sched.lane_stuck_for(tag) > 0:
        if time.monotonic() - t0 > limit_s:
            raise AssertionError(f"the {tag} lane is still busy after {limit_s} s")
        time.sleep(0.01)
    return time.monotonic() - t0


def real_error_child() -> int:
    """One scheduler attempt that hits a real device-side assert (an
    out-of-range ``index_select`` on the card).  Prints what the scheduler
    made of it as JSON and exits 3 when the error propagated."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import SpmdScheduler
    from dsort_tpu_torch.scheduler.fault import classify_runtime_error
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    def out_of_range(self, data, metrics=None):
        x = torch.arange(8, device=self.mesh.device)
        return torch.index_select(x, 0, torch.tensor([100], device=self.mesh.device)).cpu()

    SampleSort.sort = out_of_range
    sched = SpmdScheduler(8, job=JobConfig(settle_delay_s=0.01))
    journal = EventLog()
    m = Metrics(journal=journal)
    try:
        sched.sort(np.arange(1 << 20, dtype=np.int32), m)
    except Exception as e:
        print(json.dumps({
            "type": type(e).__name__, "error_code": getattr(e, "error_code", None),
            "message": str(e).splitlines()[0], "classified": classify_runtime_error(e),
            "counters": dict(m.counters), "events": journal.types(),
            "live": sched.table.live_workers(),
        }))
        return 3
    print(json.dumps({"type": None}))
    return 0


class ReformTap:
    """`Metrics` tap: the launch counts at each ``mesh_reform`` event, so a
    faulted sort's launches split into the failed attempts' and the
    re-run's."""

    def __init__(self, counts):
        self.counts, self.at = counts, []

    def observe(self, etype, fields, mono, metrics):
        if etype == "mesh_reform":
            self.at.append(self.counts())


def fault_plane(card, ss, x32, ref32, z, refz, reset, counts, launched, keys_path) -> None:
    """Phase 6: `SpmdScheduler` drills at full size, each output against
    numpy, each counter and journal order asserted; then the scheduler's own
    cost, the probe's round trip and the time to recover, in turns.  ``ss``
    is the phase-4 `SampleSort(VirtualMesh(8))`; ``x32`` / ``z`` its 2^26
    int32 and 2^24 zipf int64 keys with their numpy sorts."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.scheduler import FaultInjector, JobFailedError, SpmdScheduler
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    def faulted(label, sched, data, reference, arm, exchange=None):
        """One drill: ``arm(injector)``, sort with the launch counts set to 0
        just before; checks the bits; returns the metrics, the journal's
        types and the launches of the last re-run (after the last re-form)."""
        arm(sched.injector)
        tap = ReformTap(counts)
        m = Metrics(journal=EventLog(), taps=[tap])
        reset()
        t0 = time.perf_counter()
        out = sched.sort(data, m, exchange=exchange)
        wall = (time.perf_counter() - t0) * 1e3
        after = counts()
        if not same_bits(out, reference):
            raise AssertionError(f"{label}: output differs from numpy")
        types = m.journal.types()
        before = tap.at[-1] if tap.at else {k: 0 for k in after}
        rerun = {k: after[k] - before[k] for k in after if after[k] - before[k]}
        log(f"fault {label}: equal to numpy, {wall:.1f} ms wall, live "
            f"{sched.table.live_workers()}, counters {dict(m.counters)}")
        if tap.at:
            log(f"  launches before the last re-form {({k: v for k, v in before.items() if v})}, "
                f"re-run on {len(sched.table.live_workers())} shards {rerun}")
        else:
            log(f"  launches (no re-form; an abandoned attempt's included) {rerun}")
        return m, types, rerun

    def in_order(label, types, *names):
        """``names`` occur in ``types`` in this order (each after the last)."""
        pos = -1
        for n in names:
            if n not in types[pos + 1:]:
                raise AssertionError(f"{label}: no {n} after {names[:names.index(n)]}: {types}")
            pos = types.index(n, pos + 1)

    # 6.1 healthy: the scheduler around the same sort, in turns (A B B A).
    sched = SpmdScheduler(8, injector=FaultInjector())
    reset()
    if not same_bits(sched.sort(x32), ref32):
        raise AssertionError("SpmdScheduler healthy 2^26: output differs from numpy")
    log(f"fault healthy SpmdScheduler(8).sort uniform int32 n=2^26: equal to numpy, launches "
        f"{launched('SpmdScheduler healthy', keys_path)}")
    turns = []
    for name in ("SampleSort", "SpmdScheduler", "SpmdScheduler", "SampleSort"):
        run = ss.sort if name == "SampleSort" else sched.sort
        turns += [(name, t) for t in host_times(lambda: run(x32), 2)]
    med = {}
    for name in ("SampleSort", "SpmdScheduler"):
        ts = [t for k, t in turns if k == name]
        med[name] = float(np.median(ts))
        log(f"time {name} int32 n=2^26 alltoall host-to-host: {med[name]:.3f} ms median of "
            f"{len(ts)} (runs {[round(t, 3) for t in ts]}) [{card}]")
    log(f"time scheduler overhead (SpmdScheduler - SampleSort medians): "
        f"{med['SpmdScheduler'] - med['SampleSort']:.3f} ms [{card}]")

    # 6.2 loss before dispatch: 7 survivors re-run the whole sort.
    m, types, rerun = faulted("loss before dispatch (fail_once(2, 'spmd')) int32 n=2^26",
                              sched, x32, ref32, lambda inj: inj.fail_once(2, "spmd"))
    if m.counters["mesh_reforms"] != 1 or sched.table.live_workers() != [0, 1, 3, 4, 5, 6, 7]:
        raise AssertionError(f"loss before dispatch: {dict(m.counters)}")
    in_order("loss before dispatch", types, "job_start", "worker_dead", "mesh_reform",
             "attempt_start", "job_done")
    if types.count("attempt_start") != 2 or not all(rerun.get(k) for k in keys_path):
        raise AssertionError(f"loss before dispatch: attempts {types}, re-run {rerun}")

    # 6.3 cascading loss: 6 survivors.
    m, types, rerun = faulted(
        "cascading loss (fail_once(2), fail_once(5)) int32 n=2^26", sched, x32, ref32,
        lambda inj: (inj.fail_once(2, "spmd"), inj.fail_once(5, "spmd")))
    if m.counters["mesh_reforms"] != 2 or sched.table.live_workers() != [0, 1, 3, 4, 6, 7]:
        raise AssertionError(f"cascading loss: {dict(m.counters)}")
    if not all(rerun.get(k) for k in keys_path):
        raise AssertionError(f"cascading loss: the 6-shard re-run launched {rerun}")

    # 6.4 mid-ring loss: between the plan and the exchange, ring and fused.
    ring_scheds = {}
    for exchange in ("ring", "fused"):
        rs = ring_scheds[exchange] = SpmdScheduler(
            8, job=JobConfig(exchange=exchange), injector=FaultInjector())
        rs.sort(z)  # warm
        m, types, rerun = faulted(f"mid-ring loss (fail_once(3, 'ring')) zipf(1.3) int64 n=2^24 "
                                  f"exchange={exchange}", rs, z, refz,
                                  lambda inj: inj.fail_once(3, "ring"))
        c = m.counters
        want_plan = "fused_exchange_launch" if exchange == "fused" else "exchange_step"
        if (c["mesh_reforms"] != 1 or c["exchange_ring_steps"] != 13
                or rs.table.live_workers() != [0, 1, 2, 4, 5, 6, 7]
                or want_plan not in types[types.index("mesh_reform"):]):
            raise AssertionError(f"mid-ring loss {exchange}: {dict(c)} {types}")
        if exchange == "fused" and (c["fused_exchange_launches"] != 2
                                    or c["fused_exchange_steps"] != 13
                                    or rerun.get("ring_exchange_kernel") != 1):
            raise AssertionError(f"mid-ring loss fused: {dict(c)}, re-run launches {rerun}")

    # 6.5 hangs, on a warmed bucket: waits lapse at 2.07 s of a 4 s hang.
    hang_s = 4.0
    hang_job = JobConfig(settle_delay_s=0.01, heartbeat_timeout_s=1.0, compile_grace_s=120.0,
                         exec_allowance_floor_s=1.0, exec_allowance_keys_per_s=1e9,
                         max_transient_retries=5)
    hs = SpmdScheduler(8, job=hang_job, injector=FaultInjector())
    hs.sort(x32)  # warm
    t0 = time.monotonic()
    m, types, _ = faulted(f"hang ({hang_s} s) with healthy probes int32 n=2^26", hs, x32, ref32,
                          lambda inj: inj.hang_once(0, "spmd", hang_s))
    c = m.counters
    if (c["spmd_wait_timeouts"] < 1 or c["transient_retries"] < 1 or c.get("mesh_reforms")
            or hs.table.live_workers() != list(range(8))):
        raise AssertionError(f"hang with healthy probes: {dict(c)}")
    lapse = m.journal.events()[types.index("heartbeat_lapse")].mono - t0
    if lapse >= hang_s:
        raise AssertionError(f"hang with healthy probes: detected at {lapse:.3f} s")
    log(f"  detected at {lapse:.3f} s of the {hang_s} s hang; lane drained after "
        f"{wait_idle(hs):.3f} s more")
    t0 = time.monotonic()
    m, types, rerun = faulted(
        f"hang ({hang_s} s) + fail_once(3, 'probe') int32 n=2^26", hs, x32, ref32,
        lambda inj: (inj.hang_once(0, "spmd", hang_s), inj.fail_once(3, "probe")))
    done = time.monotonic() - t0
    c = m.counters
    if c["spmd_wait_timeouts"] != 1 or c["mesh_reforms"] != 1 or hs.table.is_alive(3):
        raise AssertionError(f"hang + failed probe: {dict(c)}")
    in_order("hang + failed probe", types, "heartbeat_lapse", "probe", "worker_dead",
             "mesh_reform", "job_done")
    if done >= hang_s:
        raise AssertionError(f"hang + failed probe: done at {done:.3f} s, not before the hang ends")
    log(f"  detected and recovered at {done:.3f} s of the {hang_s} s hang; the abandoned "
        f"attempt drained after {wait_idle(hs):.3f} s more")

    # 6.6 everyone dead: a clean JobFailedError within a bounded time.
    dead = SpmdScheduler(8, injector=FaultInjector())
    for i in range(8):
        dead.injector.kill(i)
    t0 = time.perf_counter()
    try:
        dead.sort(x32[: 1 << 20])
        raise AssertionError("every worker dead: the job did not fail")
    except JobFailedError as e:
        took = time.perf_counter() - t0
        if took > 10.0:
            raise AssertionError(f"every worker dead: JobFailedError after {took:.1f} s")
        log(f"fault every worker dead: JobFailedError ({e}) after {took * 1e3:.1f} ms")

    # 6.7 the probe's round trip on the card.
    probe_ms = []
    for _ in range(7):
        t0 = time.perf_counter()
        if not sched._probe_device(0):
            raise AssertionError("probe of a healthy worker failed")
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"time probe round trip (8 int32 up and back on the worker's lane): "
        f"{float(np.median(probe_ms)):.4f} ms median of 7 (runs "
        f"{[round(t, 4) for t in probe_ms]}) [{card}]")

    # 6.8 the classifier's status table against the runtime's own strings;
    # then one real CUDA error, in a child process (the error is sticky).
    from dsort_tpu_torch.ops.errors import CUDA_ERRORS

    cudart = torch.cuda.cudart()
    wrong = {code: cudart.cudaGetErrorString(cudart.cudaError(code))
             for code, (_, text) in CUDA_ERRORS.items()
             if cudart.cudaGetErrorString(cudart.cudaError(code)) != text}
    if wrong:
        raise AssertionError(f"CUDA_ERRORS texts differ from cudaGetErrorString: {wrong}")
    log(f"fault CUDA_ERRORS: {len(CUDA_ERRORS)} codes, each text equal to cudaGetErrorString's")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--real-error-child"],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    try:
        rep = json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        raise AssertionError(f"real-error child printed no report (rc {child.returncode}): "
                             f"{child.stdout[-2000:]} {child.stderr[-2000:]}") from e
    if (child.returncode != 3 or rep["classified"] is not None
            or "device-side assert" not in rep["message"] or rep["counters"]
            or rep["events"] != ["job_start", "attempt_start"] or len(rep["live"]) != 8):
        raise AssertionError(f"real-error child: rc {child.returncode}, {rep}")
    log(f"fault real device-side assert in a child: {rep['type']} (error_code "
        f"{rep['error_code']}) classified as a program error, propagated with no probe or "
        f"re-form, child exit {child.returncode} after {took:.1f} s")

    # 6.9 time to recover: the faulted sort minus the healthy one, in turns
    # (healthy, faulted, faulted, healthy).
    def recover(label, sched, data, arm, reps, exchange=None):
        turns = []
        for kind in ("healthy", "faulted", "faulted", "healthy"):
            for _ in range(reps):
                if kind == "faulted":
                    arm(sched.injector)
                t0 = time.perf_counter()
                sched.sort(data, exchange=exchange)
                torch.cuda.synchronize()
                turns.append((kind, (time.perf_counter() - t0) * 1e3))
                wait_idle(sched)
        med = {k: float(np.median([t for n, t in turns if n == k])) for k in ("healthy", "faulted")}
        log(f"time to recover, {label}: {med['faulted'] - med['healthy']:.3f} ms (faulted "
            f"{med['faulted']:.3f} - healthy {med['healthy']:.3f} ms, medians of {2 * reps}; runs "
            f"{[(n[0], round(t, 3)) for n, t in turns]}) [{card}]")

    recover("loss before dispatch, int32 n=2^26 alltoall (default JobConfig)", sched, x32,
            lambda inj: inj.fail_once(2, "spmd"), 2)
    recover("mid-ring loss, zipf(1.3) int64 n=2^24 ring (default JobConfig)", ring_scheds["ring"],
            z, lambda inj: inj.fail_once(3, "ring"), 2)
    recover(f"hang ({hang_s} s) + failed probe, int32 n=2^26 (waits of 2.07 s)", hs, x32,
            lambda inj: (inj.hang_once(0, "spmd", hang_s), inj.fail_once(3, "probe")), 1)


def pool_lanes_idle(dev, workers, limit_s: float = 60.0) -> float:
    """Wait until the task pool's attempt lanes of ``workers`` are idle (an
    attempt abandoned by a lapsed wait runs on to its end there).  Returns
    the seconds waited."""
    from dsort_tpu_torch.scheduler.scheduler import _lane_for_device

    lanes = [_lane_for_device(dev, w) for w in workers]
    t0 = time.monotonic()
    while any(lane.stuck_for() > 0 or not lane._q.empty() for lane in lanes):
        if time.monotonic() - t0 > limit_s:
            raise AssertionError(f"task-pool lanes {workers} still busy after {limit_s} s")
        time.sleep(0.01)
    return time.monotonic() - t0


def rungs_between(lo: int, hi: int) -> list[int]:
    """Every `pad_rung` value from ``lo`` to ``hi`` (powers of two): 8 a
    size octave."""
    out = []
    while lo < hi:
        out += [lo + i * (lo >> 3) for i in range(8)]
        lo *= 2
    return out + [hi]


def small_jobs_and_taskpool(card, hold, reset, counts, launched, keys_path, src, want_bytes,
                            work, pool_n: int = 1 << 24, cli_n: int = 1 << 21) -> None:
    """Phase 7: the fused small-job route, ``cli run --mode``, the task pool
    and the gather-merge sort on the card.  The block kernels and S1 at
    one-row shapes against their plain versions and `torch.sort`; fused jobs
    and the routes of ``cli run`` with their launches; a fallback drill; the
    task pool's drills at ``pool_n`` int32 keys; host-to-host medians in
    turns.  ``src`` is phase 4's 10^6-line file and ``want_bytes`` its
    `sort -n` order; ``cli_n`` lines go through the scheduler."""
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.device import resolve_device
    from dsort_tpu_torch.models import pipelines as pl
    from dsort_tpu_torch.ops import block_sort as tb
    from dsort_tpu_torch.ops import pallas_sort as ps
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.scheduler import (
        DeviceExecutor, FaultInjector, JobFailedError, Scheduler, SpmdScheduler,
    )
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    dev = resolve_device()
    rng = np.random.default_rng(17)
    T = tb.TILE

    # 7.1 one-row grids: each kernel against its plain version at a row of
    # 2^16 and of 2^20 keys (16 and 256 block tiles, 2 and 32 S1 tiles).
    for dtype in (np.int32, np.int64):
        for n in (1 << 16, 1 << 20):
            x = torch.from_numpy(random_keys(rng, (1, n), dtype)).to(dev)
            label = f"{np.dtype(dtype).name} 1x{n}"
            hold("bitonic_tile_kernel", f"{label} k_start=2", lambda: (tb.bitonic_tile(x.clone(), T),),
                 lambda: (tb.tile_sort_plain(x.clone(), T),))
            for k in (n, 2 * T):
                hold("bitonic_tile_merge_kernel", f"{label} k={k}",
                     lambda: (tb.bitonic_tile_merge(x.clone(), T, k),),
                     lambda: (tb.tile_merge_plain(x.clone(), T, k),))
            for st in range(1, tb.STAGES_MAX[(x.dtype, False)] + 1):
                j_bot = T << (st - 1)
                for k, j in ((n, n // 2), (2 * j_bot, j_bot)):
                    if k > n or (j >> (st - 1)) < T:
                        continue
                    hold("bitonic_global_stage_kernel", f"{label} S={st} k={k} j={j}..{j >> (st - 1)}",
                         lambda: (tb.bitonic_global_stage(x.clone(), k, j, stages=st),),
                         lambda: (tb.global_stage_plain(x.clone(), k, j, stages=st),))
            hold("tile_sort_kernel", f"{label} tile_rows=256 ({n // (256 * ps.LANES)} tiles of "
                 f"{ps.tile_sort_cluster_size(256, x.dtype)} CTAs)",
                 lambda: (ps.tile_sort(x.clone(), 256),), lambda: (ps.tile_sort_plain(x.clone(), 256),))
            del x
    # block_sort and pallas_sort of one row at every fused rung from 2^16 to
    # 2^20, against torch.sort.
    rungs = rungs_between(1 << 16, 1 << 20)
    for dtype in (np.int32, np.int64):
        for n in rungs:
            x = torch.from_numpy(random_keys(rng, (1, n), dtype)).to(dev)
            want = torch.sort(x).values
            if not (torch.equal(tb.block_sort(x), want) and torch.equal(ps.pallas_sort(x), want)):
                raise AssertionError(f"one-row sort {np.dtype(dtype).name} 1x{n} differs from torch.sort")
    torch.cuda.synchronize()
    log(f"small block_sort and pallas_sort of one row at every fused rung 2^16..2^20 ({len(rungs)} "
        f"rungs, int32 and int64): equal to torch.sort")

    # 7.2 fused jobs: one row through K1, K2 and the tile merge (auto), S1
    # (pallas); below a 2^16-key rung auto is torch.sort.
    fused_launches = {}
    for n in (1 << 16, (1 << 17) + 3, (1 << 20) - 1):
        for dtype in (np.int32, np.int64, np.uint32):
            x = random_keys(rng, n, dtype)
            reset()
            t0 = time.perf_counter()
            out = pl.fused_sort_small(x)
            wall = time.perf_counter() - t0
            got = launched(f"fused_sort_small {np.dtype(dtype).name} n={n}", keys_path)
            if not same_bits(out, np.sort(x)):
                raise AssertionError(f"fused_sort_small {np.dtype(dtype).name} n={n}: differs")
            log(f"small fused_sort_small {np.dtype(dtype).name} n={n} (rung {pl.pad_rung(n)}): "
                f"equal to numpy, {wall * 1e3:.3f} ms wall, launches {got}")
            if n == (1 << 20) - 1 and dtype == np.int32:
                fused_launches = got
    f = (rng.standard_normal((1 << 20) - 1) * 1e3).astype(np.float32)
    specials = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45, -1e-45], np.float32)
    f[rng.choice(f.size, 4096, replace=False)] = np.resize(specials, 4096)
    reset()
    out = pl.fused_sort_small(f)
    got = launched("fused_sort_small float32", keys_path)
    if not same_bits(out, ordered_float_reference(f)):
        raise AssertionError("fused_sort_small float32 with NaN/±0/±inf: differs")
    log(f"small fused_sort_small float32 with NaN/±0/±inf n={f.size}: the ordered float "
        f"reference's bits, launches {got}")
    x = random_keys(rng, (1 << 20) - 1, np.int32)
    reset()
    out = pl.fused_sort_small(x, "pallas")
    got = launched("fused_sort_small pallas", {"tile_sort_kernel"})
    if not same_bits(out, np.sort(x)) or got["tile_sort_kernel"] != 1:
        raise AssertionError(f"fused_sort_small pallas: bits or launches {got}")
    log(f"small fused_sort_small int32 n={x.size} kernel=pallas: equal to numpy, launches {got}")
    for n in (1 << 14, (1 << 15) + 1):
        x = random_keys(rng, n, np.int32)
        reset()
        out = pl.fused_sort_small(x)
        got = {k: v for k, v in counts().items() if v}
        if got or not same_bits(out, np.sort(x)):
            raise AssertionError(f"fused_sort_small n={n} (rung {pl.pad_rung(n)}): launches {got}")
        log(f"small fused_sort_small int32 n={n} (rung {pl.pad_rung(n)} < 2^16): equal to numpy, "
            "no kernel launched (auto is torch.sort)")
    # The gather-merge sort: one batched block sort of the 8 rows.
    x = random_keys(rng, pool_n, np.int32)
    reset()
    t0 = time.perf_counter()
    out = pl.GatherMergeSort(VirtualMesh(P)).sort(x)
    wall = time.perf_counter() - t0
    got = launched("GatherMergeSort", keys_path)
    if not same_bits(out, np.sort(x)):
        raise AssertionError(f"GatherMergeSort n={pool_n}: differs from numpy")
    log(f"small GatherMergeSort(VirtualMesh(8)) int32 n={pool_n}: equal to numpy, {wall * 1e3:.1f} ms "
        f"wall, launches {got}")

    # 7.3 cli run routes: cli_n (>= 2^20) lines through the scheduler; --mode local and
    # taskpool on phase 4's 10^6 lines.
    def cli_run(label, path, want, argv, need):
        dst, jpath = work / "out7.txt", work / "journal7.jsonl"
        reset()
        t0 = time.perf_counter()
        if cli.main(["run", str(path), "-o", str(dst), "--journal", str(jpath), *argv]) != 0:
            raise AssertionError(f"{label} failed")
        wall = time.perf_counter() - t0
        got = launched(label, need)
        if dst.read_bytes() != want:
            raise AssertionError(f"{label}: output differs from sort -n order")
        recs = EventLog.read_jsonl(str(jpath))
        log(f"small {label}: byte-identical, {wall * 1e3:.1f} ms wall, job_start mode "
            f"{recs[0]['mode']}, counters {recs[-2].get('counters')}, launches {got}")
        return recs

    x21 = random_keys(rng, cli_n, np.int32)
    src21 = work / "input21.txt"
    src21.write_text("".join(f"{v}\n" for v in x21.tolist()))
    recs = cli_run(f"cli run {cli_n} lines", src21,
                   "".join(f"{v}\n" for v in np.sort(x21).tolist()).encode(), [], keys_path)
    if recs[0]["mode"] != "spmd" or "attempt_start" not in [r["type"] for r in recs]:
        raise AssertionError(f"cli run {cli_n} lines did not go through SpmdScheduler")
    for mode in ("local", "taskpool"):
        recs = cli_run(f"cli run --mode {mode} 10^6 lines", src, want_bytes, ["--mode", mode],
                       keys_path)
        if recs[0]["mode"] != mode:
            raise AssertionError(f"cli run --mode {mode}: job_start mode {recs[0]['mode']}")

    # 7.4 fallback drill: the fused route raises a CUDA-named device error;
    # the job falls back to SpmdScheduler and returns numpy's bits.
    real = pl.fused_sort_small

    def dying(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")

    x = random_keys(rng, 1 << 19, np.int32)
    pl.fused_sort_small = dying
    try:
        sorter = cli._make_sorter(JobConfig(settle_delay_s=0.01), "spmd")
        m = Metrics(journal=EventLog())
        reset()
        out = sorter(x, m)
    finally:
        pl.fused_sort_small = real
    got = launched("fused fallback", keys_path)
    types = m.journal.types()
    if (not same_bits(out, np.sort(x)) or m.counters.get("fused_fallbacks") != 1
            or "fused_small_jobs" in m.counters or "fused_fallback" not in types):
        raise AssertionError(f"fused fallback drill: {dict(m.counters)} {types}")
    log(f"small fused fallback drill (CUDA-named device error) int32 n=2^19: equal to numpy, "
        f"counters {dict(m.counters)}, scheduler launches {got}")

    # 7.5 the task pool at pool_n int32, 8 workers: 8 one-row block sorts a
    # job (shards of pool_n / 8 keys), against SampleSort's one batched sort.
    x24 = random_keys(rng, pool_n, np.int32)
    ref24 = np.sort(x24)
    pool = Scheduler(DeviceExecutor(P, injector=FaultInjector()),
                     JobConfig(heartbeat_timeout_s=1.0, compile_grace_s=120.0))
    inj = pool.executor.injector

    def pool_job(label, arm=None, disarm=None):
        if arm is not None:
            arm(inj)
        m = Metrics(journal=EventLog())
        reset()
        t0 = time.perf_counter()
        try:
            out = pool.run_job(x24, m)
        finally:
            if disarm is not None:
                disarm(inj)
        wall = time.perf_counter() - t0
        got = launched(f"task pool {label}", keys_path)
        if not same_bits(out, ref24):
            raise AssertionError(f"task pool {label}: differs from numpy")
        dead = [w for w in range(P) if not pool.table.is_alive(w)]
        log(f"pool {label} int32 n={pool_n}: equal to numpy, {wall * 1e3:.1f} ms wall, dead {dead}, "
            f"counters {dict(m.counters)}, launches {got}")
        return m, dead, got

    m, dead, pool_launches = pool_job("healthy")
    if dead or pool_launches["bitonic_tile_kernel"] != P:
        raise AssertionError(f"task pool healthy: dead {dead}, launches {pool_launches}")
    m, dead, _ = pool_job("worker 3 killed before dispatch", lambda i: i.kill(3),
                          lambda i: i.revive(3))
    if dead != [3] or m.counters["reassignments"] != 1:
        raise AssertionError(f"task pool kill: dead {dead}, {dict(m.counters)}")
    m, dead, _ = pool_job("fail_once(2, 'recv')", lambda i: i.fail_once(2, "recv"))
    if dead != [2] or m.counters["reassignments"] != 1:
        raise AssertionError(f"task pool recv: dead {dead}, {dict(m.counters)}")
    hang_s = 3.0
    t0 = time.monotonic()
    m, dead, _ = pool_job(f"hang ({hang_s} s) of worker 0 at sort",
                          lambda i: i.hang_once(0, "sort", hang_s))
    done = time.monotonic() - t0
    if dead != [0] or m.counters["heartbeat_timeouts"] != 1 or done >= hang_s:
        raise AssertionError(f"task pool hang: dead {dead}, {dict(m.counters)}, done at {done:.3f}")
    lapse = [e for e in m.journal.events() if e.type == "heartbeat_lapse"][0].mono - t0
    log(f"  hang detected at {lapse:.3f} s (heartbeat wait 1.0 s), job done at {done:.3f} s of the "
        f"{hang_s} s hang; lane drained after {pool_lanes_idle(dev, [0]):.3f} s more")
    for w in range(P):
        inj.kill(w)
    t0 = time.perf_counter()
    try:
        pool.run_job(x24[: 1 << 20])
        raise AssertionError("task pool every worker dead: the job did not fail")
    except JobFailedError as e:
        took = time.perf_counter() - t0
        log(f"pool every worker dead: JobFailedError ({e}) after {took * 1e3:.1f} ms")
    finally:
        for w in range(P):
            inj.revive(w)
    out = pool.run_job(x24)  # the pool serves the next job
    if not same_bits(out, ref24):
        raise AssertionError("task pool after every worker died: differs")

    # 7.6 host-to-host medians of 4, in turns (A B B A, two runs each).
    def in_turns(label, a, b, data, unit_n):
        a()
        b()
        turns = []
        for name, fn in ((a.__name__, a), (b.__name__, b), (b.__name__, b), (a.__name__, a)):
            turns += [(name, t) for t in host_times(fn, 2)]
        med = {}
        for name in (a.__name__, b.__name__):
            ts = [t for k, t in turns if k == name]
            med[name] = float(np.median(ts))
            log(f"time {label} {name} host-to-host: {med[name]:.3f} ms median of {len(ts)} "
                f"({unit_n / med[name] / 1e6:.3f} Gkeys/s; runs {[round(t, 3) for t in ts]}) "
                f"[{card}]")
        return med

    route = cli._make_sorter(JobConfig(), "spmd")
    sched = SpmdScheduler(P)
    for n in (1 << 14, 1 << 17, (1 << 20) - 1):
        x = random_keys(rng, n, np.int32)

        def fused_route(x=x):
            return route(x, Metrics())

        def spmd_scheduler(x=x):
            return sched.sort(x)

        med = in_turns(f"int32 n={n}", fused_route, spmd_scheduler, x, n)
        log(f"  fused route / SpmdScheduler.sort at n={n}: "
            f"{med['fused_route'] / med['spmd_scheduler']:.3f} [{card}]")

    def task_pool():
        return pool.run_job(x24)

    def spmd_scheduler():
        return sched.sort(x24)

    med = in_turns(f"int32 n={pool_n}", task_pool, spmd_scheduler, x24, pool_n)
    log(f"  task pool / SpmdScheduler.sort at n={pool_n}: "
        f"{med['task_pool'] / med['spmd_scheduler']:.3f} [{card}]")
    m = Metrics()
    pool.run_job(x24, m)
    log(f"phases task pool int32 n={pool_n}: {json.dumps(m.summary())} [{card}]")
    m = Metrics()
    route(random_keys(rng, (1 << 20) - 1, np.int32), m)
    log(f"phases fused route int32 n=2^20-1: {json.dumps(m.summary())} [{card}]")
    profile(lambda: route(random_keys(rng, (1 << 20) - 1, np.int32), Metrics()),
            "fused route int32 n=2^20-1", card)
    profile(task_pool, f"task pool int32 n={pool_n}", card)

    # Time to recover: faulted minus healthy, in turns (H F F H).
    def recover(label, arm, disarm, reps, drain=()):
        turns = []
        for kind in ("healthy", "faulted", "faulted", "healthy"):
            for _ in range(reps):
                if kind == "faulted":
                    arm(inj)
                t0 = time.perf_counter()
                try:
                    pool.run_job(x24)
                finally:
                    if kind == "faulted" and disarm is not None:
                        disarm(inj)
                turns.append((kind, (time.perf_counter() - t0) * 1e3))
                pool_lanes_idle(dev, drain)
        med = {k: float(np.median([t for n, t in turns if n == k])) for k in ("healthy", "faulted")}
        log(f"time to recover, task pool {label}: {med['faulted'] - med['healthy']:.3f} ms "
            f"(faulted {med['faulted']:.3f} - healthy {med['healthy']:.3f} ms, medians of "
            f"{2 * reps}; runs {[(n[0], round(t, 3)) for n, t in turns]}) [{card}]")

    recover(f"worker 3 killed before dispatch, int32 n={pool_n}", lambda i: i.kill(3),
            lambda i: i.revive(3), 2)
    recover(f"fail_once(2, 'recv'), int32 n={pool_n}", lambda i: i.fail_once(2, "recv"), None, 2)
    recover(f"hang ({hang_s} s) of worker 0, int32 n={pool_n} (heartbeat wait 1.0 s)",
            lambda i: i.hang_once(0, "sort", hang_s), None, 1, drain=[0])
    log(f"small launches per fused 2^20-1 int32 job {fused_launches}, per task-pool n={pool_n} "
        f"int32 job {pool_launches}")


class HostCopies:
    """Counts the bytes that aten copies from ``device_type`` to the host
    move (``.cpu()``, ``.tolist()``, ``.item()``) on this thread while
    entered: the device-to-host traffic of a device-resident sort."""

    def __init__(self, device_type: str = "cuda"):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                src = args[0] if args else None
                if isinstance(src, torch.Tensor) and src.device.type == device_type:
                    if func is torch.ops.aten._local_scalar_dense.default:
                        counter.add(src.element_size())
                    elif (func is torch.ops.aten._to_copy.default
                          and isinstance(out, torch.Tensor) and out.device.type == "cpu"):
                        counter.add(out.nbytes)
                return out

        self.mode = _Mode()
        self.bytes = self.copies = 0

    def add(self, nbytes: int) -> None:
        self.bytes += nbytes
        self.copies += 1

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def device_resident(card, ss, x32, ref32, z, refz, reset, launched, keys_path, src, want_bytes,
                    work, cli_wall_ms: float) -> None:
    """Phase 8: device-resident results on the card.  ``ss`` is phase 4's
    `SampleSort(VirtualMesh(8))`, ``x32`` / ``z`` its 2^26 int32 / 2^24
    zipf int64 keys with numpy's sorts; ``src`` its 10^6-line file,
    ``want_bytes`` that file's sorted bytes and ``cli_wall_ms`` phase 4's
    ``cli run`` wall on it."""
    import threading

    from dsort_tpu_torch import cli
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.device import resolve_device
    from dsort_tpu_torch.models import pipelines as pl
    from dsort_tpu_torch.models.validate import _multiset, validate_device_result
    from dsort_tpu_torch.ops.float_order import from_signed_keys, to_signed_keys
    from dsort_tpu_torch.ops.local_sort import sentinel_for
    from dsort_tpu_torch.parallel import DeviceSortResult
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    dev = resolve_device()

    def checksum(a: np.ndarray) -> int:
        return _multiset(a, len(a), a.dtype.itemsize)

    t0 = time.perf_counter()
    ck = {"int32": checksum(x32), "int64": checksum(z)}
    log(f"device-resident: host _multiset of the inputs {(time.perf_counter() - t0) * 1e3:.1f} ms")

    # 8.1 keep_on_device at full size: launches, at most 4 KiB copied to the
    # host before to_host(), the checksum, the bits, the lengths.
    for label, data, ref, exchange in (("uniform int32 n=2^26", x32, ref32, "alltoall"),
                                       ("uniform int32 n=2^26", x32, ref32, "ring"),
                                       ("uniform int32 n=2^26", x32, ref32, "fused"),
                                       ("zipf(1.3) int64 n=2^24", z, refz, "alltoall")):
        tag = f"keep_on_device {label} exchange={exchange}"
        need = keys_path | ({"ring_exchange_kernel"} if exchange == "fused" else set())
        reset()
        with HostCopies() as before:
            t0 = time.perf_counter()
            h = ss.sort(data, keep_on_device=True, exchange=exchange)
            sort_ms = (time.perf_counter() - t0) * 1e3
        got = launched(tag, need)
        if before.bytes > 4096:
            raise AssertionError(f"{tag}: {before.bytes} bytes copied to the host before to_host()")
        with HostCopies() as val:
            rep = h.validate_on_device()
        if val.bytes > 64:
            raise AssertionError(f"{tag}: validate_on_device copied {val.bytes} bytes to the host")
        want = ck[data.dtype.name]
        if not rep.sorted_ok or rep.records != len(data) or rep.checksum != want:
            raise AssertionError(f"{tag}: {rep} against checksum {want:016x}")
        if not same_bits(h.to_host(), ref):
            raise AssertionError(f"{tag}: to_host() differs from np.sort")
        lengths = [len(r) for r in ss.sort_ranges(data, exchange=exchange)]
        if list(h.shard_lengths) != lengths:
            raise AssertionError(f"{tag}: shard_lengths {h.shard_lengths} != sort_ranges' {lengths}")
        log(f"main {tag}: sorted, checksum {rep.checksum:016x} = the input's, to_host() equal to "
            f"np.sort, shard_lengths = sort_ranges' {lengths}; {sort_ms:.1f} ms to the handle; "
            f"device-to-host before to_host() {before.bytes} bytes in {before.copies} copies, "
            f"validate_on_device {val.bytes} bytes in {val.copies}; launches {got} [{card}]")
        del h

    # 8.2 one traced keep_on_device sort: the path's kernels by their launch
    # counts and in the trace, and the copies the trace shows.
    keep = {}
    fused_path = keys_path | {"ring_exchange_kernel"}
    reset()
    by_name = profile(lambda: keep.update(h=ss.sort(x32, keep_on_device=True, exchange="fused")),
                      "SampleSort int32 n=2^26 fused keep_on_device", card)
    got = launched("traced keep_on_device fused sort", fused_path)
    for kname in sorted(fused_path):
        k_ms, k_n = traced(by_name, kname)
        log(f"traced {kname} in the keep_on_device fused sort: {k_ms:.3f} ms over {k_n} launches "
            f"in the trace, {got[kname]} by its launch count [{card}]")
    if any(not traced(by_name, k)[1] for k in fused_path):
        log("  the trace's device events: " + "; ".join(
            f"{name[:60]} x{v[1]}" for name, v in sorted(by_name.items())))
    dtoh = [(name, v) for name, v in by_name.items() if "DtoH" in name]
    log(f"traced device-to-host copies in the keep_on_device fused sort: "
        f"{[(name, round(v[0], 3), v[1]) for name, v in dtoh]} [{card}]")
    profile(lambda: keep["h"].validate_on_device(), "validate_on_device int32 n=2^26 (8 rows)",
            card)
    del keep

    # 8.3 host to host in turns (A B C C B A): sort(); keep_on_device plus
    # validate_on_device(); keep_on_device plus to_host().
    def host_sort():
        return ss.sort(x32)

    def keep_validate():
        return ss.sort(x32, keep_on_device=True).validate_on_device()

    def keep_to_host():
        return ss.sort(x32, keep_on_device=True).to_host()

    arms = (host_sort, keep_validate, keep_to_host)
    for fn in arms:
        fn()
    turns = []
    for fn in arms + arms[::-1]:
        turns += [(fn.__name__, t) for t in host_times(fn, 2)]
    med = {}
    for fn in arms:
        ts = [t for k, t in turns if k == fn.__name__]
        med[fn.__name__] = float(np.median(ts))
        log(f"time device-resident int32 n=2^26 alltoall {fn.__name__} host-to-host: "
            f"{med[fn.__name__]:.3f} ms median of {len(ts)} (runs {[round(t, 3) for t in ts]}) "
            f"[{card}]")
    log(f"  keep_validate / host_sort {med['keep_validate'] / med['host_sort']:.3f}, "
        f"keep_to_host / host_sort {med['keep_to_host'] / med['host_sort']:.3f} [{card}]")
    for label, data in (("int32 n=2^26", x32), ("zipf(1.3) int64 n=2^24", z)):
        h = ss.sort(data, keep_on_device=True)
        v_ms = cuda_ms(lambda: validate_device_result(h))
        b_ms, b_by = bound_ms(data.nbytes)
        log(f"time validate_on_device {label} ({h.num_shards} x {h._rows().shape[1]} rows, "
            f"plain PyTorch): {v_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: the keys read once), "
            f"{v_ms / b_ms:.1f}x the bound [{card}]")
        m = Metrics()
        ss.sort(data, m, keep_on_device=True)
        log(f"phases keep_on_device {label} alltoall: {json.dumps(m.summary())} [{card}]")
        del h

    # 8.4 the validator on tensors built on the card, every integer dtype:
    # the checksum against the host's, an in-row and a boundary break.
    gen = torch.Generator(device=dev).manual_seed(8)
    lengths = [1 << 18, (1 << 18) - 5, 0, 1000, 1 << 18, 7, 1 << 18, 3]
    for dtype in (torch.int32, torch.int64, torch.uint32, torch.uint64,
                  torch.int8, torch.uint8, torch.int16, torch.uint16):
        width = torch.empty(0, dtype=dtype).element_size()
        bits = torch.randint(-(1 << 31), (1 << 31) - 1, (P * (1 << 18) * width // 4,),
                             dtype=torch.int32, device=dev, generator=gen)
        s = torch.sort(to_signed_keys(bits.view(torch.uint8).view(dtype))).values.view(P, -1)
        pos = torch.arange(s.shape[1], device=dev)
        cnt = torch.tensor(lengths, device=dev)
        s = torch.where(pos < cnt.unsqueeze(1), s, sentinel_for(s.dtype))
        rows = from_signed_keys(s, dtype)
        host = rows.cpu().numpy()
        want = checksum(np.concatenate([host[i, :c] for i, c in enumerate(lengths)]))
        rep = DeviceSortResult(rows, lengths, sum(lengths)).validate_on_device()
        if not rep.sorted_ok or rep.checksum != want or rep.records != sum(lengths):
            raise AssertionError(f"validator {dtype}: {rep} against {want:016x}")
        # Breaks made in the signed carrier: PyTorch's unsigned 16-, 32- and
        # 64-bit dtypes have only partial operator support.
        last = lengths[0] - 1
        if bool((s[0, 0] == s[0, last]).item()):
            raise AssertionError(f"validator {dtype}: row 0 is constant")
        broken = s.clone()
        broken[0, [0, last]] = s[0, [last, 0]]
        order = [7, 1, 2, 3, 4, 5, 6, 0]
        for what, r, c in (("in-row break", broken, lengths),
                           ("boundary break", s[order], [lengths[i] for i in order])):
            r = from_signed_keys(r.contiguous(), dtype)
            bad = DeviceSortResult(r, c, sum(c)).validate_on_device()
            if bad.sorted_ok or bad.checksum != want:
                raise AssertionError(f"validator {dtype} {what}: {bad}")
        log(f"validator {str(dtype).removeprefix('torch.')} on the card (8 rows, lengths "
            f"{lengths}): checksum {rep.checksum:016x} = the host's; in-row and boundary "
            f"breaks caught [{card}]")

    # 8.5 fused_sort_small(keep_on_device=True): no download, no synchronize;
    # the handle read from another thread.
    rng = np.random.default_rng(18)
    for n in (1 << 16, (1 << 20) - 1):
        x = random_keys(rng, n, np.int32)
        reset()
        t0 = time.perf_counter()
        h = pl.fused_sort_small(x, keep_on_device=True)
        handle_ms = (time.perf_counter() - t0) * 1e3
        got = launched(f"fused_sort_small keep_on_device n={n}", keys_path)
        box = {}
        reader = threading.Thread(target=lambda: box.update(rep=h.validate_on_device(),
                                                            host=h.to_host()))
        reader.start()
        reader.join(timeout=120)
        if reader.is_alive() or "host" not in box:
            raise AssertionError(f"fused handle n={n}: the reading thread failed")
        if (not box["rep"].sorted_ok or box["rep"].checksum != checksum(x)
                or not same_bits(box["host"], np.sort(x)) or h.label != "fused"):
            raise AssertionError(f"fused handle n={n}: {box['rep']}")
        log(f"main fused_sort_small keep_on_device int32 n={n}: read from another thread, "
            f"checksum and bits equal; {handle_ms:.3f} ms to the handle; launches {got} [{card}]")

    # 8.6 the re-run drill: a later job loses worker 2, the handle is
    # invalidated, and to_host() re-runs it once.
    inj = FaultInjector()
    sched = SpmdScheduler(P, job=JobConfig(settle_delay_s=0.01), injector=inj)
    journal = EventLog()
    m = Metrics(journal=journal)
    h = sched.sort(x32, m, keep_on_device=True)
    inj.fail_once(2, "spmd")
    sched.sort(x32[: 1 << 20], m)
    types_ = journal.types()
    if h.valid or m.counters["mesh_reforms"] != 1 or not (
            types_.index("mesh_reform") < types_.index("device_handle_invalidated")):
        raise AssertionError(f"re-run drill: the handle was not invalidated after the re-form "
                             f"{types_}")
    reset()
    t0 = time.perf_counter()
    out = h.to_host()
    rerun_ms = (time.perf_counter() - t0) * 1e3
    got = launched("re-run of an invalidated handle", keys_path)
    rep = h.validate_on_device()
    if (not same_bits(out, ref32) or m.counters["device_handle_reruns"] != 1 or not h.valid
            or rep.checksum != ck["int32"]):
        raise AssertionError(f"re-run drill: {dict(m.counters)} {rep}")
    log(f"device-resident re-run drill int32 n=2^26: invalidated after mesh_reform, to_host() "
        f"re-ran once (device_handle_reruns 1) in {rerun_ms:.1f} ms (re-sort on 8 workers and "
        f"the copy), bits and checksum equal; launches {got} [{card}]")
    del h, out

    # 8.7 the CLI: run --device-resident, validate, gen.
    dst, jpath = work / "output_device_resident.txt", work / "journal_device_resident.jsonl"
    reset()
    t0 = time.perf_counter()
    if cli.main(["run", str(src), "-o", str(dst), "--device-resident",
                 "--journal", str(jpath)]) != 0:
        raise AssertionError("cli run --device-resident failed")
    wall = (time.perf_counter() - t0) * 1e3
    got = launched("cli run --device-resident", keys_path)
    recs = [r["type"] for r in EventLog.read_jsonl(str(jpath))]
    if (dst.read_bytes() != want_bytes or recs.count("result_fetch") != 1
            or "device_validate" not in recs):
        raise AssertionError(f"cli run --device-resident: output or journal wrong {recs}")
    log(f"main cli run --device-resident 10^6 lines: byte-identical, {wall:.1f} ms wall against "
        f"cli run's {cli_wall_ms:.1f} ms (phase 4, fused route), launches {got} [{card}]")
    if cli.main(["validate", str(dst), "--against", str(src)]) != 0:
        raise AssertionError("cli validate --against rejected a sorted output")
    lines = dst.read_bytes().split(b"\n")
    i = next(i for i in range(len(lines) // 2, len(lines) - 1) if lines[i] != lines[i + 1])
    lines[i], lines[i + 1] = lines[i + 1], lines[i]
    swapped = work / "output_swapped.txt"
    swapped.write_bytes(b"\n".join(lines))
    if cli.main(["validate", str(swapped), "--against", str(src)]) != 1:
        raise AssertionError("cli validate accepted two swapped lines")
    gen_path = work / "gen.txt"
    if cli.main(["gen", str(1 << 20), "-o", str(gen_path)]) != 0:
        raise AssertionError("cli gen failed")
    n_lines = gen_path.read_bytes().count(b"\n")
    if n_lines != 1 << 20:
        raise AssertionError(f"cli gen wrote {n_lines} lines")
    log(f"cli validate --against: 0 on the output, 1 with lines {i} and {i + 1} swapped; cli gen "
        f"wrote {n_lines} lines [{card}]")


def exchange_plane(card, ss, x32, ref32, counts32, z, refz, tk, tv, ref_k, ref_v, hist32,
                   reset, counts, launched, keys_path, kv_merge, src, want_bytes, work) -> None:
    """Phase 9: the rest of the exchange plane on the card — ``hier``, the
    coded plane (keys, records, recovery drills, the straggler race),
    ``local_kernel="radix"`` and the CLI flags.  ``ss`` is phase 4's
    `SampleSort(VirtualMesh(8))`; ``x32`` / ``z`` / ``tk, tv`` its 2^26
    int32, 2^24 zipf int64 and 2^23 TeraSort inputs with their numpy
    results; ``hist32`` the measured (P, P) histogram of ``x32``'s plan."""
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.ops.radix import radix_sort, radix_sort_kv
    from dsort_tpu_torch.parallel import exchange as ex
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    mesh, dev = ss.mesh, ss.mesh.device
    n32, n_local = len(x32), -(-len(x32) // P)

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() / 2**30

    def one(label, sorter, data, reference, need, **kw):
        """One driven sort with its launches, bits, wall and peak memory."""
        m = Metrics(journal=EventLog())
        reset()
        t0 = time.perf_counter()
        out, gb = peak_gb(lambda: sorter.sort(data, m, **kw))
        wall = (time.perf_counter() - t0) * 1e3
        got = launched(label, need)
        if not same_bits(out, reference):
            raise AssertionError(f"{label}: output differs from numpy")
        log(f"exchange {label}: equal to numpy, {wall:.1f} ms wall, peak "
            f"{gb:.3f} GiB allocated, launches {got} [{card}]")
        return m, got

    def in_turns(label, runs: dict, data, reps=2, unit_n=None):
        """Host-to-host medians of each named run, in turns A B .. B A."""
        names = list(runs)
        order = names + names[::-1]
        parts = []
        for name in order:
            parts += [(name, t) for t in host_times(lambda: runs[name](data), reps)]
        med = {}
        for name in names:
            ts = [t for k, t in parts if k == name]
            med[name] = float(np.median(ts))
            log(f"time {label} {name} host-to-host: {med[name]:.3f} ms median of {len(ts)} "
                f"(runs {[round(t, 3) for t in ts]}) [{card}]")
        return med

    # -- hier -------------------------------------------------------------------
    hier = {h: SampleSort(mesh, JobConfig(exchange="hier", hier_hosts=h)) for h in (2, 4)}
    ring_counts = counts32
    caps32 = ex.ring_caps(hist32, n_local, P)
    for h, sorter in hier.items():
        m, _ = one(f"hier hosts={h} uniform int32 n=2^26", sorter, x32, ref32, keys_path)
        plan = ex.hier_plan(hist32, n_local, P, h)
        dcn, intra = ex.hier_wire_bytes(plan, 4)
        saved = max(ex.ring_dcn_bytes(caps32, 4, P, h) - dcn, 0)
        got = (m.counters["dcn_bytes_on_wire"], m.counters["intra_host_bytes_on_wire"],
               m.counters["dcn_bytes_saved"])
        if got != (dcn, intra, saved) or m.counters["hier_exchanges"] != 1:
            raise AssertionError(f"hier hosts={h}: counters {got} != plan's {(dcn, intra, saved)}")
        shard_counts = [len(r) for r in sorter.sort_ranges(x32)]
        if shard_counts != ring_counts:
            raise AssertionError(f"hier hosts={h}: per-shard counts differ from ring's")
        log(f"  plan {tuple(plan)}: dcn_bytes_on_wire {dcn}, intra_host_bytes_on_wire {intra}, "
            f"dcn_bytes_saved {saved} (the plan's counts: on one card no byte crosses a host); "
            f"per-shard counts equal ring's")
    one("hier hosts=2 zipf(1.3) int64 n=2^24", hier[2], z, refz, keys_path)
    in_turns("SampleSort int32 n=2^26", {
        "ring": lambda d: ss.sort(d, exchange="ring"),
        "hier hosts=2": lambda d: hier[2].sort(d), "hier hosts=4": lambda d: hier[4].sort(d),
    }, x32)
    for victims, what in (([5], "one worker"), ([2, 3], "host 1 of 4")):
        inj = FaultInjector()
        sched = SpmdScheduler(8, dev, JobConfig(settle_delay_s=0.01, exchange="hier",
                                                hier_hosts=4), inj)
        for w in victims:
            inj.fail_once(w, "ring")
        m = Metrics(journal=EventLog())
        if not same_bits(sched.sort(x32, m), ref32):
            raise AssertionError(f"hier_reform drill ({what}): output differs from numpy")
        rf = [f for e in m.journal.events() if e.type == "hier_reform" for f in [e.fields]]
        want = ex.resolve_hier_hosts(4, 8 - len(victims))
        if len(rf) != 1 or (rf[0]["hosts_before"], rf[0]["hosts_after"]) != (4, want):
            raise AssertionError(f"hier_reform drill ({what}): {rf}")
        log(f"fault hier_reform, lose {what} (workers {victims}) at 2^26 int32, hosts=4: "
            f"hosts_before {rf[0]['hosts_before']}, hosts_after {rf[0]['hosts_after']}, "
            f"downgraded {rf[0]['downgraded']}, survivors {rf[0]['survivors']}, equal to numpy")

    # -- coded keys --------------------------------------------------------------
    coded = {
        f"{mode} r={r}": SampleSort(mesh, JobConfig(exchange="ring", redundancy=r,
                                                    redundancy_mode=mode))
        for mode, r in (("replicate", 2), ("parity", 2), ("parity", 3))
    }
    _, ring_gb = peak_gb(lambda: ss.sort(x32, exchange="ring"))
    log(f"exchange ring uniform int32 n=2^26: peak {ring_gb:.3f} GiB allocated [{card}]")
    for name, sorter in coded.items():
        m, _ = one(f"coded {name} uniform int32 n=2^26", sorter, x32, ref32, keys_path)
        r, mode = sorter.job.redundancy, sorter.job.redundancy_mode
        model = (ex.parity_wire_bytes if mode == "parity" else ex.replica_wire_bytes)(
            caps32, 4, P, r)
        if m.counters["coded_replica_bytes"] != model:
            raise AssertionError(f"coded {name}: coded_replica_bytes "
                                 f"{m.counters['coded_replica_bytes']} != model {model}")
        log(f"  coded_replica_bytes {model} = {mode}_wire_bytes(caps); ring's own "
            f"{ex.ring_wire_bytes(caps32, 4, P)}")
    in_turns("SampleSort int32 n=2^26", {
        "ring": lambda d: ss.sort(d, exchange="ring"),
        **{f"coded {k}": (lambda d, s=s: s.sort(d)) for k, s in coded.items()},
    }, x32)

    # -- coded records -----------------------------------------------------------
    for mode in ("replicate", "parity"):
        sorter = SampleSort(mesh, JobConfig(exchange="ring", redundancy=2, redundancy_mode=mode))
        m = Metrics()
        reset()
        t0 = time.perf_counter()
        (ok, ov), gb = peak_gb(lambda: sorter.sort_kv(tk, tv, m))
        wall = (time.perf_counter() - t0) * 1e3
        got = launched(f"coded sort_kv {mode}", kv_merge)
        # The 8-byte prefixes are unique (phase 4), so the multiset per key
        # is the stable order itself.
        if not (np.array_equal(ok, ref_k) and np.array_equal(ov, ref_v)):
            raise AssertionError(f"coded sort_kv {mode}: records differ from numpy's")
        log(f"exchange coded sort_kv {mode} r=2 2^23 TeraSort records: records equal numpy's, "
            f"{wall:.1f} ms wall, peak {gb:.3f} GiB allocated, coded_replica_bytes "
            f"{m.counters['coded_replica_bytes']}, launches {got} [{card}]")

    # -- recovery drills ---------------------------------------------------------
    def drill_sched(**job):
        inj = FaultInjector()
        sched = SpmdScheduler(8, dev, JobConfig(settle_delay_s=0.1, exchange="ring", **job), inj)
        if not same_bits(sched.sort(x32), ref32):
            raise AssertionError("drill warm-up differs from numpy")
        return sched, inj

    def faulted_sort(label, sched, inj, arm, check):
        arm(inj)
        m = Metrics(journal=EventLog())
        reset()
        out = sched.sort(x32, m)
        if not same_bits(out, ref32):
            raise AssertionError(f"{label}: output differs from numpy")
        check(m)
        return m

    recover = {}
    for name, job in (("replicate r=2", dict(redundancy=2)),
                      ("parity r=2", dict(redundancy=2, redundancy_mode="parity")),
                      ("uncoded", {})):
        sched, inj = drill_sched(**job)
        coded_run = bool(job)
        rec_type = "parity_recover" if job.get("redundancy_mode") == "parity" else "coded_recover"
        events = []

        def check(m, coded_run=coded_run, rec_type=rec_type, name=name):
            types = m.journal.types()
            k1 = counts()["bitonic_tile_kernel"]
            if coded_run:
                rec = [e.fields for e in m.journal.events() if e.type == rec_type]
                if types.count("attempt_start") != 1 or len(rec) != 1 or k1 != 1:
                    raise AssertionError(f"coded drill {name}: {types}, K1 launches {k1}")
                events.append(rec[0])
            elif types.count("attempt_start") != 2 or k1 != 2:
                raise AssertionError(f"uncoded drill: {types}, K1 launches {k1}")

        def healthy(d, sched=sched):
            return sched.sort(d)

        def faulted(d, sched=sched, inj=inj, check=check, name=name):
            return faulted_sort(f"mid-ring loss {name}", sched, inj,
                                lambda i: i.fail_once(3, "ring"), check)

        med = in_turns(f"SpmdScheduler(8) int32 n=2^26 {name}",
                       {"healthy": healthy, "mid-ring loss of worker 3": faulted}, x32)
        recover[name] = med["mid-ring loss of worker 3"] - med["healthy"]
        if events:
            ev = events[0]
            fetch = [round(e["fetch_s"] * 1e3, 3) for e in events]
            merge = [round(e["wall_s"] * 1e3, 3) for e in events]
            log(f"  {rec_type} x{len(events)}: dead {ev['dead']}, holders {ev['holders']}, "
                f"recovered_keys {ev['recovered_keys']}, replica_bytes {ev['replica_bytes']}, "
                f"host copy (fetch_s) median {np.median(fetch):.3f} ms {fetch}, host merge "
                f"(wall_s) median {np.median(merge):.3f} ms {merge}; one attempt_start, K1 "
                f"launched once (zero keys re-sorted) each [{card}]")
        if coded_run:
            def over_budget(m):
                types = m.journal.types()
                if "coded_budget_exceeded" not in types or types.count("attempt_start") != 2:
                    raise AssertionError(f"two adjacent losses: {types}")

            faulted_sort(f"two adjacent losses {name}", sched, inj,
                         lambda i: i.fail_sequence([(3, "ring"), (4, "ring")]), over_budget)
            log(f"fault coded {name} two adjacent losses (3, 4): coded_budget_exceeded, then "
                f"the re-run, equal to numpy")
        if name == "replicate r=2":
            # The straggler race: worker 5 slow by 0.5 s, no failure.
            inj.slow(5, 0.5)
            m = Metrics(journal=EventLog())
            t0 = time.perf_counter()
            out = sched.sort(x32, m)
            wall = (time.perf_counter() - t0) * 1e3
            inj.slow(5, 0)
            serves = [e.fields for e in m.journal.events() if e.type == "coded_straggler_serve"]
            if not same_bits(out, ref32) or len(serves) != 1:
                raise AssertionError(f"straggler drill: {m.journal.types()}")
            if wall >= med["healthy"] + 500:
                raise AssertionError(f"straggler drill: {wall:.1f} ms >= healthy + 500 ms")
            for s in sched._sorters.values():
                s.join_stragglers()
            owner = [e.fields for e in m.journal.events() if e.type == "coded_owner_fetch"]
            if len(owner) != 1 or owner[0]["won"]:
                raise AssertionError(f"straggler drill: owner leg {owner}")
            log(f"fault straggler slow(5, 0.5 s) replicate r=2 2^26 int32: one "
                f"coded_straggler_serve (range {serves[0]['range']}, holder leg "
                f"{serves[0]['wall_s'] * 1e3:.3f} ms), wall {wall:.1f} ms against healthy "
                f"{med['healthy']:.1f} + 500 ms; the owner leg drained after "
                f"{owner[0]['wall_s'] * 1e3:.1f} ms, won=False [{card}]")
    log(f"time to recover, mid-ring loss at 2^26 int32 (faulted minus healthy medians): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in recover.items()) + f" [{card}]")

    # -- radix ------------------------------------------------------------------
    rs = SampleSort(mesh, JobConfig(local_kernel="radix"))
    one("local_kernel=radix uniform int32 n=2^26", rs, x32, ref32, set())
    rrng = np.random.default_rng(13)
    for dtype, shape in ((np.int32, (P, n32 // P)), (np.int64, (P, len(z) // P))):
        xr = torch.from_numpy(random_keys(rrng, shape, dtype)).to(dev)
        if not torch.equal(radix_sort(xr), torch.sort(xr).values):
            raise AssertionError(f"radix_sort {np.dtype(dtype).name} {shape} != torch.sort")
        r_ms = cuda_ms(lambda: radix_sort(xr), reps=3, warmup=1)
        t_ms = cuda_ms(lambda: torch.sort(xr))
        b_ms, b_by = bound_ms(2 * xr.numel() * xr.element_size())
        log(f"time radix_sort {np.dtype(dtype).name} {shape}: {r_ms:.3f} ms, torch.sort "
            f"{t_ms:.3f} ms ({r_ms / t_ms:.1f}x), bound {b_ms:.4f} ms ({b_by}) (plain PyTorch, "
            f"no kernel) [{card}]")
        del xr
    nk = 1 << 20
    kk = torch.from_numpy(rrng.integers(0, 1 << 12, nk).astype(np.int32)).to(dev)
    vv = torch.from_numpy(rrng.integers(0, 256, (nk, 90), dtype=np.uint8)).to(dev)
    ok, ov = radix_sort_kv(kk, vv)
    perm = torch.sort(kk, stable=True).indices
    if not (torch.equal(ok, kk[perm]) and torch.equal(ov, vv[perm])):
        raise AssertionError("radix_sort_kv: not the stable order")
    kv_ms = cuda_ms(lambda: radix_sort_kv(kk, vv), reps=3, warmup=1)
    log(f"time radix_sort_kv 2^20 int32 keys (4096 distinct) + 90-byte payloads: {kv_ms:.3f} ms, "
        f"stable: payloads in the stable torch.sort order [{card}]")
    del kk, vv, ok, ov, perm

    # -- the CLI flags -------------------------------------------------------------
    dst, jpath = work / "output_p9.txt", work / "journal_p9.jsonl"
    reset()
    t0 = time.perf_counter()
    if cli.main(["run", str(src), "-o", str(dst), "--redundancy", "2", "--journal",
                 str(jpath)]) != 0:
        raise AssertionError("cli run --redundancy 2 failed")
    wall = (time.perf_counter() - t0) * 1e3
    got = launched("cli run --redundancy 2", keys_path)
    recs = EventLog.read_jsonl(str(jpath))
    types = [r["type"] for r in recs]
    if (dst.read_bytes() != want_bytes or recs[0]["mode"] != "spmd"
            or "coded_replica_ship" not in types or "fused_small_jobs" in recs[-2]["counters"]):
        raise AssertionError(f"cli run --redundancy 2: {recs[0]} {types}")
    log(f"main cli run --redundancy 2 10^6 lines: byte-identical, {wall:.1f} ms wall, "
        f"SpmdScheduler (not the fused route), coded_replica_ship journaled, launches {got}")
    # Under 2^20 keys a hier job takes the fused route, as dsort run routes
    # it (only a coded job skips it); 2^21 lines reach the scheduler.
    if cli.main(["run", str(src), "-o", str(dst), "--exchange", "hier", "--journal",
                 str(jpath)]) != 0:
        raise AssertionError("cli run --exchange hier (10^6 lines) failed")
    recs = EventLog.read_jsonl(str(jpath))
    if dst.read_bytes() != want_bytes or recs[0]["mode"] != "fused":
        raise AssertionError(f"cli run --exchange hier 10^6 lines: {recs[0]}")
    log("main cli run --exchange hier 10^6 lines: byte-identical, the fused route (under "
        "2^20 keys, as dsort run routes it)")
    big, big_out = work / "input_2p21.txt", work / "output_2p21.txt"
    xb = x32[: 1 << 21]
    big.write_text("".join(f"{v}\n" for v in xb.tolist()))
    reset()
    t0 = time.perf_counter()
    if cli.main(["run", str(big), "-o", str(big_out), "--exchange", "hier", "--hier-hosts", "4",
                 "--journal", str(jpath)]) != 0:
        raise AssertionError("cli run --exchange hier failed")
    wall = (time.perf_counter() - t0) * 1e3
    got = launched("cli run --exchange hier", keys_path)
    recs = EventLog.read_jsonl(str(jpath))
    plans = [r for r in recs if r["type"] == "hier_exchange_plan"]
    if (big_out.read_bytes() != "".join(f"{v}\n" for v in np.sort(xb).tolist()).encode()
            or len(plans) != 1 or plans[0]["hosts"] != 4):
        raise AssertionError(f"cli run --exchange hier: {plans}")
    log(f"main cli run --exchange hier --hier-hosts 4 2^21 lines: byte-identical, {wall:.1f} ms "
        f"wall, hier_exchange_plan hosts 4, launches {got}")
    return ring_gb


def out_of_core(card, ss, x32, ref32, z, refz, tk, tv, ref_k, ref_v, reset, counts, launched,
                keys_path, src, want_bytes, work, ring_gb) -> None:
    """Phase 10: recovery and out-of-core on the card.  ``x32`` / ``z`` /
    ``tk, tv`` are phase 4's 2^26 uniform int32, 2^24 zipf int64 and
    phase 5's 2^23 TeraSort records (unique prefixes, so ``ref_k, ref_v``
    is their order), ``ring_gb`` phase 9's peak allocation of the
    in-memory ``ring`` sort at 2^26.  Every dataset is 8 times the per-run
    or per-wave budget (the reference's out-of-core bench factor); the
    spill lives in a temporary directory under ``work``, removed at the
    end."""
    import os
    import shutil
    import tempfile

    from dsort_tpu_torch import cli
    from dsort_tpu_torch.checkpoint import ShardCheckpoint
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.models.external_sort import ExternalSort, ExternalTeraSort
    from dsort_tpu_torch.models.wave_sort import (
        DIE_AFTER_WAVE_ENV,
        ExternalWaveSort,
        ExternalWaveTeraSort,
    )
    from dsort_tpu_torch.ops import block_sort as tb
    from dsort_tpu_torch.ops import pallas_sort as ps
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.scheduler import (
        DeviceExecutor,
        FaultInjector,
        Scheduler,
        SpmdScheduler,
    )
    from dsort_tpu_torch.scheduler.fault import WorkerFailure
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    dev = ss.mesh.device
    n32, nz, nrec = len(x32), len(z), len(tk)
    run32, runz, run_rec = n32 // 8, nz // 8, nrec // 8
    spill = Path(tempfile.mkdtemp(prefix="ooc_", dir=work))
    in32, out32 = spill / "in_int32.bin", spill / "out_int32.bin"
    x32.tofile(in32)

    def read_out(path, dtype):
        return np.fromfile(path, dtype=dtype)

    def peak_gb(fn):
        """``fn()`` and its peak allocation over what was live before it
        (earlier phases leave tensors allocated)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - live) / 2**30

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def drop(*job_ids):
        """Remove finished stores: the spill stays near one job's size."""
        for job_id in job_ids:
            shutil.rmtree(spill / job_id, ignore_errors=True)

    def expect(label, m, **want):
        got = {k: m.counters.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{label}: counters {got} != {want}")

    try:
        # -- 1. ExternalSort ---------------------------------------------------
        row = torch.from_numpy(x32[:run32].copy()).to(dev)
        reset()
        tb.block_sort(row)
        torch.cuda.synchronize()
        per_run = {k: v for k, v in counts().items() if v}
        reset()
        ps.pallas_sort(row)
        torch.cuda.synchronize()
        s1_per_run = counts()["tile_sort_kernel"]
        del row
        es = ExternalSort(run_elems=run32, spill_dir=str(spill), job_id="ext32")
        m = Metrics()
        reset()
        _, wall = timed(lambda: es.sort_binary_file(str(in32), str(out32), np.int32, m))
        got = launched("ExternalSort int32 n=2^26", keys_path)
        if got != {k: 8 * v for k, v in per_run.items()}:
            raise AssertionError(f"ExternalSort launches {got} != 8 x block_sort's {per_run}")
        if not same_bits(read_out(out32, np.int32), ref32):
            raise AssertionError("ExternalSort int32 n=2^26: output differs from numpy")
        expect("ExternalSort", m, runs_sorted=8, runs_resumed=0)
        ext_wall = wall
        log(f"ooc ExternalSort int32 n=2^26 run_elems=2^23 (8 runs) from a binary file: equal to "
            f"numpy, {wall:.1f} ms wall ({n32 / wall / 1e3:.3f} Mkeys/s), phases "
            f"{m.summary()['phases_ms']}, launches {got} = 8 x block_sort's at 2^23 {per_run} "
            f"[{card}]")
        esp = ExternalSort(run_elems=run32, spill_dir=str(spill), job_id="ext32p",
                           local_kernel="pallas")
        m = Metrics()
        reset()
        _, wall = timed(lambda: esp.sort_binary_file(str(in32), str(out32), np.int32, m))
        got = launched("ExternalSort pallas", {"tile_sort_kernel"})
        if got.get("tile_sort_kernel") != 8 * s1_per_run or s1_per_run != 1:
            raise AssertionError(f"ExternalSort pallas: S1 launches {got} (per run {s1_per_run})")
        if not same_bits(read_out(out32, np.int32), ref32):
            raise AssertionError("ExternalSort pallas: output differs from numpy")
        log(f"ooc ExternalSort int32 n=2^26 local_kernel=pallas: equal to numpy, {wall:.1f} ms "
            f"wall, phases {m.summary()['phases_ms']}, launches {got} [{card}]")
        drop("ext32p")
        rng = np.random.default_rng(10)
        f = (rng.standard_normal(nz) * 1e3).astype(np.float32)
        specials = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45, -1e-45],
                            np.float32)
        f[rng.choice(f.size, 4096, replace=False)] = np.resize(specials, 4096)
        m = Metrics()
        reset()
        out, wall = timed(lambda: ExternalSort(run_elems=nz // 4, spill_dir=str(spill),
                                               job_id="extf").sort(f, metrics=m))
        got = launched("ExternalSort float32", keys_path)
        if not same_bits(out, ordered_float_reference(f)):
            raise AssertionError("ExternalSort float32: output differs from the float order")
        expect("ExternalSort float32", m, runs_sorted=4)
        log(f"ooc ExternalSort float32 with NaN/±0/±inf n=2^24 in 4 runs: the float order "
            f"(ordered uints), {wall:.1f} ms wall, launches {got} [{card}]")
        drop("extf")
        ck = ShardCheckpoint(str(spill), "ext32")
        for i in (1, 4, 6):
            os.remove(ck._shard_path(i))
        m = Metrics()
        reset()
        _, wall = timed(lambda: es.sort_binary_file(str(in32), str(out32), np.int32, m))
        got = launched("ExternalSort resume", keys_path)
        expect("ExternalSort resume", m, runs_resumed=5, runs_sorted=3)
        if not same_bits(read_out(out32, np.int32), ref32):
            raise AssertionError("ExternalSort resume: output differs from numpy")
        log(f"ooc ExternalSort resume after 3 of 8 run files deleted: runs_resumed 5, "
            f"runs_sorted 3, equal to numpy, {wall:.1f} ms wall against the full job's "
            f"{ext_wall:.1f} ms, launches {got} [{card}]")
        other = x32[: n32 // 4] ^ 1
        m = Metrics()
        out = es.sort(other, metrics=m)
        expect("ExternalSort reused job_id", m, runs_resumed=0, runs_sorted=2)
        if not same_bits(out, np.sort(other)) or ck.manifest()["total"] != len(other):
            raise AssertionError("ExternalSort reused job_id: the store was not cleared")
        log("ooc ExternalSort reused job_id on other data (a quarter of the keys): store cleared, "
            "runs_resumed 0, runs_sorted 2, equal to numpy")
        drop("ext32")

        # -- 2. ExternalWaveSort(VirtualMesh(8)) --------------------------------
        mesh8 = VirtualMesh(P)
        waves = {
            "ring": dict(exchange="ring"),
            "fused": dict(exchange="fused"),
            "hier hosts=2": dict(exchange="hier", job=JobConfig(hier_hosts=2)),
            "coded replicate r=2": dict(redundancy=2),
        }
        wave_gb, wave_wall = {}, {}
        for name, kw in waves.items():
            ws = ExternalWaveSort(mesh8, wave_elems=run32, spill_dir=str(spill),
                                  job_id=f"wave_{name.split()[0]}", resume=False, **kw)
            m = Metrics(journal=EventLog())
            reset()
            t0 = time.perf_counter()
            _, gb = peak_gb(lambda: ws.sort_binary_file(str(in32), str(out32), np.int32, m))
            wall = (time.perf_counter() - t0) * 1e3
            need = keys_path | ({"ring_exchange_kernel"} if name == "fused" else set())
            got = launched(f"ExternalWaveSort {name}", need)
            if name == "fused" and got["ring_exchange_kernel"] != 8:
                raise AssertionError(f"fused waves: {got['ring_exchange_kernel']} R1 launches")
            if not same_bits(read_out(out32, np.int32), ref32):
                raise AssertionError(f"ExternalWaveSort {name}: output differs from numpy")
            expect(f"ExternalWaveSort {name}", m, waves_sorted=8, runs_sorted=64,
                   hier_exchanges=8 if name.startswith("hier") else 0)
            wave_gb[name], wave_wall[name] = gb, wall
            drop(ws.job_id)
            log(f"ooc ExternalWaveSort(VirtualMesh(8)) {name} int32 n=2^26 wave_elems=2^23 (8 "
                f"waves): equal to numpy, {wall:.1f} ms wall ({n32 / wall / 1e3:.3f} Mkeys/s), "
                f"peak {gb:.3f} GiB allocated over the live, phases {m.summary()['phases_ms']}, launches "
                f"{got} [{card}]")
        out, mem_gb = peak_gb(lambda: ss.sort(x32, exchange="ring"))
        if not same_bits(out, ref32) or not wave_gb["ring"] < mem_gb / 2:
            raise AssertionError(f"wave ring peak {wave_gb['ring']:.3f} GiB is not under half of "
                                 f"the in-memory ring's {mem_gb:.3f} GiB")
        log(f"ooc peak allocated over the {torch.cuda.memory_allocated() / 2**30:.3f} GiB live "
            f"before each job: wave ring {wave_gb['ring']:.3f} GiB against the in-memory "
            f"ring's {mem_gb:.3f} GiB at 2^26 (ratio {wave_gb['ring'] / mem_gb:.3f}; phase "
            f"9's absolute ring peak {ring_gb:.3f} GiB) [{card}]")
        wz = ExternalWaveSort(mesh8, wave_elems=runz, spill_dir=str(spill), job_id="wave_zipf")
        m = Metrics()
        reset()
        out, wall = timed(lambda: wz.sort(z, metrics=m))
        got = launched("ExternalWaveSort zipf int64", keys_path)
        if not same_bits(out, refz):
            raise AssertionError("ExternalWaveSort zipf int64: output differs from numpy")
        expect("ExternalWaveSort zipf", m, waves_sorted=8)
        log(f"ooc ExternalWaveSort zipf(1.3) int64 n=2^24 wave_elems=2^21: equal to numpy, "
            f"{wall:.1f} ms wall, launches {got} [{card}]")
        drop("wave_zipf")
        turns = []
        for overlap in (True, False, False, True):
            ws = ExternalWaveSort(mesh8, wave_elems=run32, spill_dir=str(spill),
                                  job_id="wave_ab", resume=False, overlap=overlap)
            turns.append((overlap, timed(lambda: ws.sort_binary_file(
                str(in32), str(out32), np.int32))[1]))
            if not same_bits(read_out(out32, np.int32), ref32):
                raise AssertionError(f"overlap={overlap}: output differs from numpy")
        drop("wave_ab")
        on = float(np.median([t for o, t in turns if o]))
        off = float(np.median([t for o, t in turns if not o]))
        log(f"ooc ExternalWaveSort ring overlap on / off, in turns (on off off on): "
            f"{on:.1f} / {off:.1f} ms median of 2 (ratio off/on {off / on:.3f}; runs "
            f"{[(o, round(t, 1)) for o, t in turns]}) [{card}]")

        # -- 3. wave drills ----------------------------------------------------
        def wave_drill(label, hook_at, coded):
            ws = ExternalWaveSort(mesh8, wave_elems=run32, spill_dir=str(spill),
                                  job_id=f"drill_{coded}", resume=False,
                                  redundancy=2 if coded else 1)
            calls = {"n": 0}

            def hook():
                calls["n"] += 1
                if calls["n"] == hook_at:
                    raise WorkerFailure(3 if coded else 5, "ring")

            ws.fault_hook = hook
            m = Metrics(journal=EventLog())
            reset()
            _, wall = timed(lambda: ws.sort_binary_file(str(in32), str(out32), np.int32, m))
            got = launched(label, keys_path)
            if not same_bits(read_out(out32, np.int32), ref32):
                raise AssertionError(f"{label}: output differs from numpy")
            drop(ws.job_id)
            return m, wall, got

        m, wall, got = wave_drill("wave drill: a loss in wave 4's ring", 5, False)
        expect("wave drill", m, wave_runs_resorted=8, waves_sorted=7, coded_recoveries=0)
        log(f"ooc wave drill, a loss in wave 4's ring: wave_runs_resorted 8 (host re-sort), "
            f"equal to numpy, {wall:.1f} ms wall against {wave_wall['ring']:.1f} healthy, "
            f"host repair split (ms) {phases_ms(m, 'wave_repair')}, launches {got} [{card}]")
        m, wall, got = wave_drill("wave drill coded r=2", 5, True)
        rec = m.journal.types().count("coded_recover")
        expect("coded wave drill", m, wave_runs_resorted=0, coded_recoveries=1, waves_sorted=8)
        if rec != 1:
            raise AssertionError(f"coded wave drill: {rec} coded_recover events")
        log(f"ooc wave drill coded replicate r=2, a loss in wave 4's ring: one coded_recover, "
            f"wave_runs_resorted absent, equal to numpy, {wall:.1f} ms wall against "
            f"{wave_wall['coded replicate r=2']:.1f} healthy [{card}]")
        crash_out = spill / "out_crash.bin"
        argv = ["external", str(in32), "-o", str(crash_out), "--mesh", "8", "--wave-elems",
                str(run32), "--spill-dir", str(spill), "--job-id", "crash"]
        env = {**os.environ, DIE_AFTER_WAVE_ENV: "3"}
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "dsort_tpu_torch.cli", *argv], env=env,
                           cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        runs = ShardCheckpoint(str(spill), "crash").completed_wave_runs()
        if r.returncode != 17 or len(runs) != 32:
            raise AssertionError(f"crash drill: exit {r.returncode}, {len(runs)} wave runs\n"
                                 f"{r.stderr[-2000:]}")
        jpath = spill / "crash.jsonl"
        reset()
        t0 = time.perf_counter()
        if cli.main(argv + ["--journal", str(jpath)]) != 0:
            raise AssertionError("crash drill re-run failed")
        wall = (time.perf_counter() - t0) * 1e3
        got = launched("crash drill re-run", keys_path)
        done = [x for x in EventLog.read_jsonl(str(jpath)) if x["type"] == "job_done"][-1]
        if (done["counters"].get("runs_resumed") != 32 or done["counters"].get("runs_sorted") != 32
                or not same_bits(read_out(crash_out, np.int32), ref32)):
            raise AssertionError(f"crash drill re-run: {done['counters']}")
        log(f"ooc crash drill: child exit 17 after wave 3 ({child_s:.1f} s with its start), 32 "
            f"wave runs durable; re-run runs_resumed 32, runs_sorted 32, equal to numpy, "
            f"{wall:.1f} ms wall against the full job's {wave_wall['ring']:.1f} ms, launches "
            f"{got} [{card}]")
        drop("crash")
        crash_out.unlink()

        # -- 4. records ----------------------------------------------------------
        rec_in, rec_ref = spill / "tera_in.bin", spill / "tera_ref.bin"
        ingest.write_terasort_file(rec_in, tk, tv)
        ingest.write_terasort_file(rec_ref, ref_k, ref_v)
        want_rec = rec_ref.read_bytes()
        _, mem_ms = timed(lambda: ss.sort_kv(tk, tv, secondary=ingest.terasort_secondary(tv)))
        rec_jobs = {
            "ExternalTeraSort run_recs=2^20": lambda out: ExternalTeraSort(
                run_recs=run_rec, spill_dir=str(spill), job_id="tera",
                resume=False).sort_file(str(rec_in), str(out)),
            "ExternalWaveTeraSort(VirtualMesh(8)) wave_recs=2^20": lambda out: (
                ExternalWaveTeraSort(mesh8, wave_recs=run_rec, spill_dir=str(spill),
                                     job_id="tera_wave", resume=False).sort_file(
                    str(rec_in), str(out))),
            "cli terasort --external": lambda out: cli.main(
                ["terasort", str(rec_in), "-o", str(out), "--external", "--run-recs",
                 str(run_rec), "--spill-dir", str(spill), "--no-resume"]),
            "cli terasort --external --mesh 8": lambda out: cli.main(
                ["terasort", str(rec_in), "-o", str(out), "--external", "--mesh", "8",
                 "--run-recs", str(run_rec), "--spill-dir", str(spill), "--no-resume"]),
        }
        for name, job in rec_jobs.items():
            out = spill / "tera_out.bin"
            _, wall = timed(lambda: job(out))
            if out.read_bytes() != want_rec:
                raise AssertionError(f"{name}: records differ from the lexsort order")
            log(f"ooc {name} 2^23 TeraSort records: byte-identical to the key order, "
                f"{wall:.1f} ms wall ({nrec / wall / 1e3:.3f} Mrec/s) beside the in-memory "
                f"sort_kv's {mem_ms:.1f} ms ({nrec / mem_ms / 1e3:.3f} Mrec/s) [{card}]")
            drop("tera", "tera_wave", "tera_external")
        for path in (rec_in, rec_ref, spill / "tera_out.bin"):
            path.unlink()

        # -- 5. resumable jobs ---------------------------------------------------
        root = spill / "ckpt"
        plain = SpmdScheduler(8, dev, JobConfig(settle_delay_s=0.01))
        ckd = SpmdScheduler(8, dev, JobConfig(settle_delay_s=0.01, checkpoint_dir=str(root)))
        if not same_bits(plain.sort(x32), ref32):
            raise AssertionError("SpmdScheduler warm-up differs from numpy")
        turns = []
        for i, ck_on in enumerate((False, True, True, False)):
            sched = ckd if ck_on else plain
            out, wall = timed(lambda: sched.sort(x32, job_id=f"turn{i}"))
            if not same_bits(out, ref32):
                raise AssertionError("SpmdScheduler turns: output differs from numpy")
            turns.append((ck_on, wall))
            shutil.rmtree(root / f"turn{i}", ignore_errors=True)
        healthy = {k: float(np.median([t for c, t in turns if c == k])) for k in (False, True)}
        log(f"ooc SpmdScheduler(8) int32 n=2^26 without / with checkpoint_dir, in turns: "
            f"{healthy[False]:.1f} / {healthy[True]:.1f} ms median of 2 (the cost of persisting "
            f"{healthy[True] - healthy[False]:.1f} ms; runs {[(c, round(t, 1)) for c, t in turns]}) "
            f"[{card}]")
        inj = FaultInjector()
        drill = SpmdScheduler(8, dev, JobConfig(settle_delay_s=0.01, checkpoint_dir=str(root)),
                              inj)
        inj.fail_once(5, "assemble")
        m = Metrics(journal=EventLog())
        reset()
        out, wall = timed(lambda: drill.sort(x32, m, job_id="assemble"))
        got = launched("SpmdScheduler loss at assemble", keys_path)
        resort = m.counters.get("shuffle_resort_keys", 0)
        if (not same_bits(out, ref32) or m.counters.get("shuffle_ranges_restored") != 5
                or not 0.3 * n32 < resort < 0.45 * n32 or m.counters.get("mesh_reforms") != 1):
            raise AssertionError(f"assemble drill: {dict(m.counters)}")
        log(f"ooc SpmdScheduler loss at assemble (range 5): shuffle_ranges_restored 5, "
            f"shuffle_resort_keys {resort} ({resort / n32:.4f} of N), equal to numpy, "
            f"{wall:.1f} ms wall, time to recover {wall - healthy[True]:.1f} ms over the "
            f"checkpointed healthy median, {wall / healthy[False]:.2f}x a plain re-run "
            f"(the uncheckpointed job, {healthy[False]:.1f} ms), resume split (ms) "
            f"{phases_ms(m, 'resume_')}, launches {got} [{card}]")
        m = Metrics()
        reset()
        out, wall = timed(lambda: drill.sort(x32, m, job_id="assemble"))
        if (not same_bits(out, ref32) or m.counters.get("shuffle_phase_restores") != 1
                or any(counts().values())):
            raise AssertionError(f"full restore: {dict(m.counters)} launches {counts()}")
        log(f"ooc SpmdScheduler re-run of the same job_id: shuffle_phase_restores 1, zero kernel "
            f"launches, equal to numpy, {wall:.1f} ms wall [{card}]")
        pool = Scheduler(DeviceExecutor(8, dev), JobConfig(settle_delay_s=0.01,
                                                           checkpoint_dir=str(root)))
        xp = x32[:nz]
        refp = np.sort(xp)
        _, first = timed(lambda: pool.run_job(xp, job_id="pool"))
        m = Metrics()
        reset()
        out, wall = timed(lambda: pool.run_job(xp, m, job_id="pool"))
        if (not same_bits(out, refp) or m.counters.get("shards_restored") != 8
                or any(counts().values())):
            raise AssertionError(f"task pool re-run: {dict(m.counters)} launches {counts()}")
        log(f"ooc task pool 2^24 int32 re-run with a job_id: shards_restored 8, zero kernel "
            f"launches, {wall:.1f} ms wall against the first run's {first:.1f} ms [{card}]")
        dst, jpath = spill / "cli_out.txt", spill / "cli_ck.jsonl"
        argv = ["run", str(src), "-o", str(dst), "--checkpoint-dir", str(root), "--job-id",
                "clijob", "--journal", str(jpath)]
        reset()
        if cli.main(argv) != 0:
            raise AssertionError("cli run --checkpoint-dir failed")
        got = launched("cli run --checkpoint-dir", keys_path)
        recs = EventLog.read_jsonl(str(jpath))
        if (dst.read_bytes() != want_bytes or recs[0]["mode"] != "spmd"
                or "fused_small_jobs" in recs[-2]["counters"]):
            raise AssertionError(f"cli run --checkpoint-dir: {recs[0]} {recs[-2]}")
        reset()
        if cli.main(argv) != 0:
            raise AssertionError("cli run --checkpoint-dir re-run failed")
        recs = EventLog.read_jsonl(str(jpath))
        if (dst.read_bytes() != want_bytes
                or recs[-2]["counters"].get("shuffle_phase_restores") != 1):
            raise AssertionError(f"cli run --checkpoint-dir re-run: {recs[-2]}")
        log(f"main cli run --checkpoint-dir --job-id 10^6 lines: byte-identical through "
            f"SpmdScheduler (not the fused route), launches {got}; the re-run restored "
            f"(shuffle_phase_restores 1, launches {counts()})")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    log(f"phase 10 out_of_core: {time.perf_counter() - t_phase:.1f} s wall [{card}]")


def batch_and_multiprocess(card, ss, reset, counts, launched, keys_path, work) -> None:
    """Phase 11: the batch plane and the multi-process plane on the card.
    ``ss`` is phase 4's `SampleSort(VirtualMesh(8))`; every output is held
    to numpy's bits (records by key order, the prefixes being unique)."""
    import shutil
    import tempfile

    from dsort_tpu_torch import cli
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.models.validate import _multiset
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import BatchSampleSort
    from dsort_tpu_torch.tools import mh_proc
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    mesh = ss.mesh
    scratch = Path(tempfile.mkdtemp(prefix="batch_mh_", dir=work))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def check_all(label, jobs, outs):
        for j, o in zip(jobs, outs):
            if not same_bits(o, np.sort(j)):
                raise AssertionError(f"{label}: a job differs from numpy")

    def buckets_of(bs, jobs):
        return len({bs._bucket_cap(len(j)) for j in jobs})

    def ran():
        """The launches since the last ``reset()``."""
        return {k: v for k, v in counts().items() if v}

    try:
        # -- 11.1 mixed batch at full width -------------------------------
        big = [random_keys(rng, BATCH_BIG, np.int32) for _ in range(4)]
        small = [random_keys(rng, max(n * BATCH_BIG >> 23, 16), np.int32)
                 for n in [1 << e for e in range(10, 19)] + [3000, 50_000, 150_000]]
        jobs = big + small
        reset()
        ss.sort(big[0])
        one_job = launched("SampleSort 2^23 int32 (one job of the big bucket's shape)",
                           keys_path)
        BatchSampleSort(mesh).sort(jobs)  # warm-up: the allocator's first 32-row buffers
        for dp in (1, 4):
            bs = BatchSampleSort(mesh, dp=dp)
            m = Metrics()
            reset()
            outs, wall = timed(lambda: bs.sort(jobs, m))
            got = launched(f"batch dp={dp}", keys_path)
            check_all(f"batch dp={dp}", jobs, outs)
            if got != one_job:
                raise AssertionError(f"batch dp={dp}: launches {got} != one 2^23 job's {one_job} "
                                     "(the big bucket must be one program over its 32 rows)")
            log(f"batch 11.1 mixed dp={dp}: 16 jobs (4 x 2^23, 12 of 2^10..2^18) equal to numpy, "
                f"{wall:.1f} ms wall, {buckets_of(bs, jobs)} buckets, padded_elems "
                f"{m.counters['padded_elems']}, phases {m.summary()['phases_ms']}, launches {got} "
                f"= one 2^23 job's [{card}]")
        bs = BatchSampleSort(mesh)
        times = {"bucket": [], "single": []}
        for side in ("bucket", "single", "single", "bucket"):
            run = (lambda: bs.sort(big)) if side == "bucket" else (lambda: [ss.sort(b) for b in big])
            times[side] += host_times(run, 1)
        log(f"time batch 11.1 the big bucket (4 x 2^23 int32, 32 rows) host-to-host: "
            f"{np.median(times['bucket']):.3f} ms median of 2 beside 4 SampleSort.sort calls "
            f"{np.median(times['single']):.3f} ms (runs {[round(t, 3) for t in times['bucket']]} / "
            f"{[round(t, 3) for t in times['single']]}) [{card}]")

        # -- 11.2 many small jobs ------------------------------------------
        many = [random_keys(rng, BATCH_MANY, np.int32) for _ in range(64)]
        reset()
        check_all("batch 64 x 2^16", many, bs.sort(many))
        many_launches = ran()
        turns = {"batch": [], "single": []}
        for side in ("batch", "single", "single", "batch"):
            run = (lambda: bs.sort(many)) if side == "batch" else (lambda: [ss.sort(j) for j in many])
            turns[side] += host_times(run, 2)
        b_ms, s_ms = float(np.median(turns["batch"])), float(np.median(turns["single"]))
        log(f"time batch 11.2 64 jobs of 2^16 int32 host-to-host: one BatchSampleSort.sort "
            f"{b_ms:.3f} ms, 64 SampleSort.sort calls {s_ms:.3f} ms (ratio {b_ms / s_ms:.3f}; "
            f"medians of 4 in turns A B B A, runs {[round(t, 3) for t in turns['batch']]} / "
            f"{[round(t, 3) for t in turns['single']]}); launches {many_launches} (2^13 keys a "
            f"shard: torch.sort, under the block kernels' 2^16) [{card}]")

        # -- 11.3 the batch's other paths -----------------------------------
        pairs = [ingest.gen_terasort(BATCH_RECORDS, seed=20 + i) for i in range(4)]
        m = Metrics()
        reset()
        outs, wall = timed(lambda: bs.sort_kv(pairs, m))
        got = launched("batch sort_kv 4 x 2^21 records",
                       {"bitonic_global_stage_kernel" + RANK, "bitonic_tile_merge_kernel" + RANK})
        for (k, v), (gk, gv) in zip(pairs, outs):
            order = np.argsort(k, kind="stable")
            if len(np.unique(k)) != len(k) or not (same_bits(gk, k[order])
                                                   and np.array_equal(gv, v[order])):
                raise AssertionError("batch sort_kv: records differ from numpy's key order")
        log(f"batch 11.3 sort_kv 4 x 2^21 TeraSort records (the rank plane): equal to numpy's key "
            f"order, {wall:.1f} ms wall, phases {m.summary()['phases_ms']}, launches {got} [{card}]")
        specials = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
        fjobs = []
        for n in (BATCH_BIG >> 3, 3 * BATCH_BIG >> 5, BATCH_BIG >> 7):
            f = (rng.standard_normal(n) * 1e3).astype(np.float32)
            k = min(600, n // 4)
            f[rng.choice(n, k, replace=False)] = np.resize(specials, k)
            fjobs.append(f)
        reset()
        outs, wall = timed(lambda: bs.sort(fjobs))
        if not all(same_bits(o, ordered_float_reference(f)) for f, o in zip(fjobs, outs)):
            raise AssertionError("batch float32: differs from the documented order")
        log(f"batch 11.3 float32 with NaN/±0/±inf (3 jobs, 2^16..2^20): -0.0 before +0.0, NaNs "
            f"last, {wall:.1f} ms wall, launches {ran()} [{card}]")
        m = Metrics()
        reset()
        outs, wall = timed(lambda: bs.sort(jobs, m, exchange="ring"))
        got = launched("batch ring", keys_path)
        check_all("batch ring", jobs, outs)
        log(f"batch 11.3 exchange=ring mixed 16 jobs: equal to numpy, {wall:.1f} ms wall, "
            f"exchange_ring_steps {m.counters['exchange_ring_steps']}, launches {got} [{card}]")
        m = Metrics()
        reset()
        handles, wall = timed(lambda: bs.sort(jobs, m, keep_on_device=True))
        keep_launches = launched("batch keep_on_device", keys_path)
        for j, h in zip(jobs, handles):
            rep = h.validate_on_device()
            if not (rep.sorted_ok and rep.records == len(j)
                    and rep.checksum == _multiset(j, len(j), 4)):
                raise AssertionError(f"batch keep_on_device: validate {rep}")
        check_all("batch keep_on_device to_host", jobs, [h.to_host() for h in handles])
        log(f"batch 11.3 keep_on_device mixed 16 jobs: {len(handles)} handles, each "
            f"validate_on_device() ok (order, count, checksum = the host _multiset), {wall:.1f} ms "
            f"to the handles, device_handles {m.counters['device_handles']}, launches "
            f"{keep_launches} [{card}]")
        del handles
        bsp = BatchSampleSort(mesh, JobConfig(local_kernel="pallas"))
        reset()
        outs, wall = timed(lambda: bsp.sort(big))
        got = launched("batch local_kernel=pallas", {"tile_sort_kernel"})
        check_all("batch pallas", big, outs)
        log(f"batch 11.3 local_kernel=pallas one bucket 4 x 2^23: equal to numpy, {wall:.1f} ms "
            f"wall, launches {got} [{card}]")
        ck = scratch / "ck"
        bsc = BatchSampleSort(mesh, JobConfig(checkpoint_dir=str(ck)))
        ids = [f"job{i}" for i in range(len(jobs))]
        first_cap = min(bsc._bucket_cap(len(j)) for j in jobs)
        first = sum(bsc._bucket_cap(len(j)) == first_cap for j in jobs)
        real = BatchSampleSort._run_bucket
        sorted_caps = []

        def killed_after_one(self, ks, vs, cap, metrics, **kw):
            if sorted_caps:
                raise InterruptedError("killed after the first bucket")
            sorted_caps.append(cap)
            return real(self, ks, vs, cap, metrics, **kw)

        BatchSampleSort._run_bucket = killed_after_one
        try:
            bsc.sort(jobs, job_ids=ids)
            raise AssertionError("the checkpoint drill's kill did not fire")
        except InterruptedError:
            pass
        finally:
            BatchSampleSort._run_bucket = real
        m = Metrics()
        reset()
        outs, wall = timed(lambda: bsc.sort(jobs, m, job_ids=ids))
        check_all("batch checkpoint re-run", jobs, outs)
        if m.counters.get("batch_jobs_restored") != first:
            raise AssertionError(f"batch re-run restored {dict(m.counters)}, expected {first}")
        log(f"batch 11.3 checkpoint drill: killed after the first bucket, the re-run restored "
            f"batch_jobs_restored={first} and sorted the rest, {wall:.1f} ms wall, launches "
            f"{ran()} [{card}]")
        files = []
        for i, n in enumerate((1 << 18, 100_000, 1 << 16, 5000)):
            path = scratch / f"in{i}.txt"
            ingest.write_ints_file(path, random_keys(rng, max(n * BATCH_BIG >> 23, 16), np.int32))
            files.append(path)
        argv = ["batch", *map(str, files), "--outdir", str(scratch / "out"), "--checkpoint-dir",
                str(scratch / "cli_ck"), "--journal", str(scratch / "batch.jsonl"),
                "--device", mesh.device.type]
        walls, cli_launches = [], []
        for _ in range(2):
            reset()
            _, wall = timed(lambda: cli.main(argv))
            walls.append(wall)
            cli_launches.append(ran())
            for path in files:
                want = np.sort(ingest.read_ints_file(path, "int32"))
                if not same_bits(ingest.read_ints_file(scratch / "out" / path.name, "int32"), want):
                    raise AssertionError(f"cli batch: {path.name} differs from numpy")
        recs = [r["type"] for r in EventLog.read_jsonl(str(scratch / "batch.jsonl"))]
        if "phase_start" in recs:
            raise AssertionError(f"cli batch re-run sorted again: {recs}")
        log(f"batch 11.3 cli batch 4 files --checkpoint-dir: outputs equal to numpy, "
            f"{walls[0]:.1f} ms, the re-run restored all 4 (no phase ran) {walls[1]:.1f} ms; "
            f"launches {cli_launches[0]} then {cli_launches[1]} [{card}]")
        del big, small, jobs, many, pairs, outs

        # -- 11.4 two ranks on the one card ---------------------------------
        n_rank = MH_KEYS
        # The first uniform32 run warms each rank (allocator, first calls).
        modes = ["uniform32", "uniform32", "uniform32:hier", f"terasort@{MH_RECORDS}",
                 f"float32@{MH_RECORDS}"]
        res = mh_proc.run_cluster(2, scratch / "mh", ",".join(modes), local=4, n=n_rank,
                                  device=mesh.device.type, timeout_s=300.0)
        if [rc for rc, _ in res] != [0, 0]:
            raise AssertionError(f"2-rank cluster failed: {[rc for rc, _ in res]}\n"
                                 + "\n".join(err[-1500:] for _, err in res))
        union = np.concatenate([mh_proc.rank_data("uniform32", r, 2, n_rank) for r in range(2)])
        ref = np.sort(union)
        _, single_ms = timed(lambda: ss.sort(union))
        single_ms = min(single_ms, timed(lambda: ss.sort(union))[1])
        for i, spec in enumerate(modes):
            metas = mh_proc.read_mode(scratch / "mh", i, 2)
            got = np.concatenate([mm["out"] for mm in metas])
            if [mm["offset"] for mm in metas] != [0, len(metas[0]["out"])]:
                raise AssertionError(f"{spec}: offsets {[mm['offset'] for mm in metas]}")
            if spec.startswith("uniform32"):
                ok = same_bits(got, ref)
            elif spec.startswith("terasort"):
                data = [mh_proc.rank_data(spec, r, 2) for r in range(2)]
                k = np.concatenate([d[0] for d in data])
                v = np.concatenate([d[1] for d in data])
                order = np.lexsort((ingest.terasort_secondary(v), k))
                ok = same_bits(got, k[order]) and np.array_equal(
                    np.concatenate([mm["outv"] for mm in metas]), v[order])
            else:
                f = np.concatenate([mh_proc.rank_data(spec, r, 2) for r in range(2)])
                ok = same_bits(got, ordered_float_reference(f))
            if not ok:
                raise AssertionError(f"2-rank {spec}: differs from numpy")
            for r, mm in enumerate(metas):
                on_card = mesh.device.type == "cuda"
                if on_card and spec.startswith("uniform32") and not all(
                        mm["launches"].get(k) for k in keys_path):
                    raise AssertionError(f"rank {r} {spec}: block kernels not launched "
                                         f"{mm['launches']}")
                log(f"mh 11.4 {spec}{' (warm-up)' if i == 0 else ''} rank {r} of 2 "
                    f"(VirtualMesh(4) each): slice equal to numpy's "
                    f"at offset {mm['offset']}, {mm['wall_ms']:.1f} ms wall, phases "
                    f"{mm['phases_ms']}, cross-process legs {mm['wire_ms']:.1f} ms for "
                    f"{mm['wire_bytes']} bytes sent, counters {mm['counters']}, launches "
                    f"{mm['launches']} [{card}]")
            if spec.startswith("uniform32") and i > 0:
                wall = max(mm["wall_ms"] for mm in metas)
                log(f"time mh 11.4 {spec} 2 x 2^25 int32: {wall:.1f} ms (slower rank) beside "
                    f"SampleSort(VirtualMesh(8)).sort of the same 2^26 keys in one process "
                    f"{single_ms:.1f} ms (ratio {wall / single_ms:.3f}) [{card}]")
        del union, ref

        # -- 11.5 the crash drill on the card --------------------------------
        n_ck = MH_DRILL
        env = {"DSORT_MH_CKPT_DIR": str(scratch / "mh_ck")}
        expect = np.sort(mh_proc.rank_data("ckpt", 0, 1, n_ck))
        for run, world, extra in (("run1", 2, {"DSORT_MH_DIE_BEFORE_RANGE": "1"}),
                                  ("run2", 1, {}), ("run3", 2, {})):
            t0 = time.perf_counter()
            res = mh_proc.run_cluster(world, scratch / run, "ckpt", local=4, n=n_ck,
                                      device=mesh.device.type, env={**env, **extra},
                                      timeout_s=240.0, group_timeout_s=60.0)
            wall = (time.perf_counter() - t0) * 1e3
            want = [0, 17] if extra else [0] * world
            if [rc for rc, _ in res] != want:
                raise AssertionError(f"drill {run}: return codes {[rc for rc, _ in res]} != "
                                     f"{want}\n" + "\n".join(err[-1500:] for _, err in res))
            metas = mh_proc.read_mode(scratch / run, 0, world) if not extra else [
                mh_proc.read_mode(scratch / run, 0, 1)[0]]
            if not extra:
                if not same_bits(np.concatenate([mm["out"] for mm in metas]), expect):
                    raise AssertionError(f"drill {run}: output differs from numpy")
                c = metas[0]["counters"]
                if run == "run2" and not (c.get("multihost_ranges_restored") == 1
                                          and 0 < c.get("multihost_resort_keys", 0) < n_ck):
                    raise AssertionError(f"drill run2 counters {c}")
                if run == "run3" and ("multihost_resort_keys" in c
                                      or not c.get("multihost_ranges_restored")):
                    raise AssertionError(f"drill run3 counters {c}")
            log(f"mh 11.5 crash drill {run} ({world} rank{'s' if world > 1 else ''}, 2^24 int32 "
                f"in all): return codes {[rc for rc, _ in res]}, {wall:.1f} ms to the last exit, "
                f"job walls {[round(mm['wall_ms'], 1) for mm in metas]} ms, counters "
                f"{[mm['counters'] for mm in metas]}, phases {metas[0]['phases_ms']} [{card}]")
        if CENSUS is not None:  # the ranks' journals, for phase 13.5
            CENSUS.add_dir(scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 11 batch_and_multiprocess: {time.perf_counter() - t_phase:.1f} s wall [{card}]")


def serve_real_error_child() -> int:
    """A `SortService(8)` on the card whose first small job hits a real
    device-side assert (an out-of-range ``index_select``).  Prints what
    the service made of it as JSON and exits 3 when it ended as it must:
    the job failed, every slice retired, the queued jobs failed with no
    slice left, and ``shutdown`` returned."""
    from dsort_tpu_torch.config import JobConfig, ServeConfig
    from dsort_tpu_torch.models import pipelines
    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.utils.events import EventLog

    def out_of_range(*args):
        def sort_row(x, count):
            return torch.index_select(x, 0, torch.tensor([1 << 30], device=x.device))
        return sort_row

    pipelines._fused_small_fn = out_of_range
    journal = EventLog()
    svc = SortService(8, job=JobConfig(settle_delay_s=0.01, heartbeat_timeout_s=5.0),
                      serve=ServeConfig(slice_devices=4), journal=journal, start=False)
    rng = np.random.default_rng(5)
    tickets = [svc.submit(random_keys(rng, 1 << 18, np.int32), tenant="acme")[1]
               for _ in range(3)]
    t0 = time.perf_counter()
    svc.start()
    outcomes = []
    for t in tickets:
        try:
            t.result(timeout=120)
            outcomes.append("ok")
        except Exception as e:
            outcomes.append(f"{type(e).__name__}: {str(e).splitlines()[0][:80]}")
    closed = svc.shutdown(drain=True, timeout=120)
    print(json.dumps({
        "outcomes": outcomes, "closed": closed, "slices": svc.stats()["slices"],
        "retired": [e.fields for e in journal.events() if e.type == "slice_retired"],
        "seconds": round(time.perf_counter() - t0, 3), "types": journal.types(),
    }))
    ok = (closed and svc.stats()["slices"] == 0 and "device-side assert" in outcomes[0]
          and "no live mesh slices" in outcomes[-1] and "ok" not in outcomes)
    return 3 if ok else 1


def serving(card, x32, ref32, z, refz, reset, counts, launched, keys_path, work) -> None:
    """Phase 12: the serving plane on the card (`serve.SortService`).

    ``VirtualMesh(8)`` in slices of one worker, each slice a CUDA stream:
    3 tenants x 4 uniform int32 jobs of 2^19 and 2^18 keys (the fused
    route) beside one 2^26 job on the whole mesh (phase 4's keys), every
    output held to numpy's bits; the launches of a small job and of the big
    job held to `fused_sort_small`'s and `SpmdScheduler.sort`'s at those
    sizes, and the window's to their sum; jobs/s, the p95 queue wait and
    the tenants' p95 ratio from ``job_dequeued``, the variant cache's hit
    rate; the packed window against one slice, in turns; int64, float32
    and ``pallas`` small jobs; a big job under ``fused`` (one R1 launch); a
    slice loss (evicted, re-admitted, exact; time to recover in turns), a
    hang on a slice (evicted at its bound), a re-form under the big job
    (the dead worker's slice retired); the admission verdicts
    (``queue_full``, ``tenant_limit``, ``slo_shed``) and weights; ``cli
    serve`` as a subprocess (a ``/metrics`` scrape, SIGINT with jobs
    queued, exit 0, the drained journal, the output file); the planner's
    exchange at 2^26 uniform int32 and 2^24 zipf int64; a real
    device-side assert in a child service (every slice retired, no hang).
    """
    import os
    import re
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    from dsort_tpu_torch.config import JobConfig, ServeConfig
    from dsort_tpu_torch.models import pipelines as pl
    from dsort_tpu_torch.obs.plan import replay_decision
    from dsort_tpu_torch.obs.prof import LEDGER
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    n_big = len(x32)
    tenants = ("acme", "blue", "coral")
    fast = JobConfig(settle_delay_s=0.01)

    def service(job=fast, **serve_kw):
        journal = EventLog()
        serve_kw.setdefault("max_queue_depth", 64)
        serve_kw.setdefault("max_tenant_inflight", 32)
        return SortService(8, job=job, serve=ServeConfig(**serve_kw), journal=journal,
                           start=False), journal

    def small_jobs(seed):
        r = np.random.default_rng(seed)
        return [(tenants[i % 3], random_keys(r, 1 << (19 - i % 2), np.int32)) for i in range(12)]

    def run_window(svc, jobs):
        """Submit every job, run them, then hold each output to numpy's;
        returns the seconds from the first submission to the last result
        (numpy's sorts are taken before the clock starts)."""
        refs = [ref32 if d is x32 else np.sort(d) for _, d in jobs]
        t0 = time.perf_counter()
        tickets = [svc.submit(d, tenant=t)[1] for t, d in jobs]
        svc.start()
        outs = [tk.result(timeout=300) for tk in tickets]
        wall = time.perf_counter() - t0
        for (_, d), out, want in zip(jobs, outs, refs):
            if not same_bits(out, want):
                raise AssertionError(f"serve: a {d.dtype} job of {len(d)} keys differs from numpy")
        return wall

    # 12.1 each small size and the big job alone: the service's launches
    # equal fused_sort_small's and SpmdScheduler.sort's at those sizes.
    # First calls of the earlier phases' unjournaled sorts wait in the
    # process's ledger queue for a recording Metrics; drain them into a
    # journal of their own, so the prewarm's journal holds only its own.
    LEDGER.drain_to(Metrics(journal=EventLog()))
    svc, journal = service()
    svc.start()
    fresh = svc.prewarm(sizes=[1 << 18, 1 << 19])
    compiled = [e.fields for e in journal.events() if e.type == "variant_compiled"]
    streams = {s if s is None else s.cuda_stream for s in svc._streams.values()}
    if fresh != 2 or len(compiled) != 2 * len(streams):  # one first call per rung and stream
        raise AssertionError(f"serve prewarm: {fresh} rungs, {len(compiled)} first calls")
    log(f"serve 12.1 prewarm 2^18, 2^19 int32 on {len(streams)} slice streams: first calls "
        f"{[round(c['compile_s'] * 1e3, 3) for c in compiled]} ms (peak bytes "
        f"{compiled[0]['peak_hbm_bytes']}, argument {compiled[0]['argument_hbm_bytes']}) [{card}]")
    per_job = {}
    for n in (1 << 18, 1 << 19):
        x = random_keys(rng, n, np.int32)
        reset()
        pl.fused_sort_small(x)
        want = launched(f"fused_sort_small n={n}", keys_path)
        reset()
        out = svc.submit(x, tenant="acme")[1].result(timeout=120)
        got = launched(f"serve small job n={n}", keys_path)
        if got != want or not same_bits(out, np.sort(x)):
            raise AssertionError(f"serve small job n={n}: launches {got} != {want}")
        per_job[n] = got
        log(f"serve small job n=2^{n.bit_length() - 1}: launches {got} (= fused_sort_small's)")
    reset()
    SpmdScheduler(8).sort(x32)
    want = launched("SpmdScheduler.sort 2^26", keys_path)
    reset()
    out = svc.submit(x32, tenant="acme")[1].result(timeout=300)
    got = launched("serve big job 2^26", keys_path)
    if got != want or not same_bits(out, ref32):
        raise AssertionError(f"serve big job: launches {got} != SpmdScheduler's {want}")
    per_job[n_big] = got
    log(f"serve big job n=2^26: launches {got} (= SpmdScheduler.sort's)")
    svc.shutdown()

    # 12.2 the packed window: 12 small jobs of 3 tenants and the big job.
    svc, journal = service()
    svc.prewarm(sizes=[1 << 18, 1 << 19])
    jobs = small_jobs(1) + [("acme", x32)]
    reset()
    wall = run_window(svc, jobs)
    got = counts()
    want = {k: 6 * per_job[1 << 18].get(k, 0) + 6 * per_job[1 << 19].get(k, 0)
            + per_job[n_big].get(k, 0) for k in got}
    if {k: v for k, v in got.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"serve window launches {got} != the jobs' sum {want}")
    deq = [e.fields for e in journal.events() if e.type == "job_dequeued"]
    waits = {t: [f["wait_s"] for f in deq if f["tenant"] == t] for t in tenants}
    p95 = {t: float(np.percentile(w, 95)) for t, w in waits.items()}
    hit = svc.variants.hit_rate()
    if hit < 0.5:
        raise AssertionError(f"serve: variant cache hit rate {hit} < 0.5 over repeat sizes")
    slices_used = sorted({tuple(f["slices"]) for f in deq if not f["big"]})
    log(f"serve 12.2 window: 12 small jobs (3 tenants, 2^19 / 2^18 int32) + 1 big (2^26) in "
        f"{wall * 1e3:.3f} ms = {len(jobs) / wall:.3f} jobs/s, every output equal to numpy, "
        f"launches {got} (= the jobs' sum); queue wait p95 "
        f"{float(np.percentile([f['wait_s'] for f in deq], 95)) * 1e3:.3f} ms, per tenant "
        f"{ {t: round(v * 1e3, 3) for t, v in p95.items()} } ms (max/min "
        f"{max(p95.values()) / max(min(p95.values()), 1e-9):.3f}); cache hit rate {hit:.3f}; "
        f"small jobs on {len(slices_used)} slices [{card}]")
    svc.shutdown()

    # 12.3 packed (8 slices) against one slice (slice_devices=8), both
    # prewarmed, in turns (A B B A), the 12 small jobs alone.
    services = {"8 slices": service(), "1 slice": service(slice_devices=8)}
    for s, _ in services.values():
        s.prewarm(sizes=[1 << 18, 1 << 19])
        s.start()
        run_window(s, small_jobs(9))  # one untimed window each
    turns = []
    for name in ("8 slices", "1 slice", "1 slice", "8 slices"):
        for rep in range(2):
            turns.append((name, run_window(services[name][0], small_jobs(10 + rep)) * 1e3))
    med = {k: float(np.median([t for n, t in turns if n == k])) for k in services}
    log(f"time serve 12 small jobs packed on 8 slice streams: {med['8 slices']:.3f} ms, on one "
        f"slice: {med['1 slice']:.3f} ms (median of 4 in turns; x{med['1 slice'] / med['8 slices']:.3f}; "
        f"runs {[(n, round(t, 3)) for n, t in turns]}) [{card}]")
    for name, (s, jl) in services.items():
        local = [e.fields["seconds"] * 1e3 for e in jl.events()
                 if e.type == "phase_end" and e.fields["phase"] == "local_sort"]
        log(f"  {name}: a small job's local_sort phase (upload, sort, download on its "
            f"stream) median {float(np.median(local)):.3f} ms of {len(local)} [{card}]")
        s.shutdown()

    # 12.4 int64, float32 (NaN, ±0.0) and pallas small jobs.
    svc, journal = service()
    f = (rng.standard_normal(1 << 18) * 1e3).astype(np.float32)
    f[rng.choice(f.size, 4096, replace=False)] = np.resize(
        np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32), 4096)
    x64 = random_keys(rng, 1 << 18, np.int64)
    reset()
    tk = [svc.submit(x64, tenant="blue")[1], svc.submit(f, tenant="coral")[1]]
    svc.start()
    o64, of = tk[0].result(timeout=120), tk[1].result(timeout=120)
    got = launched("serve int64 + float32 small jobs", keys_path)
    if not (same_bits(o64, np.sort(x64)) and same_bits(of, ordered_float_reference(f))):
        raise AssertionError("serve int64 / float32 small jobs differ")
    log(f"serve 12.4 int64 and float32 (NaN/±0/±inf) small jobs of 2^18: numpy's bits, "
        f"launches {got}")
    svc.shutdown()
    svc, journal = service(JobConfig(local_kernel="pallas", settle_delay_s=0.01))
    x = random_keys(rng, 1 << 19, np.int32)
    reset()
    pl.fused_sort_small(x, "pallas")
    want = launched("fused_sort_small pallas", {"tile_sort_kernel"})
    reset()
    svc.start()
    out = svc.submit(x, tenant="acme")[1].result(timeout=120)
    got = launched("serve pallas small job", {"tile_sort_kernel"})
    if got != want or not same_bits(out, np.sort(x)):
        raise AssertionError(f"serve pallas: launches {got} != {want}")
    log(f"serve pallas small job 2^19 int32: S1 launches {got['tile_sort_kernel']} "
        f"(= fused_sort_small's), numpy's bits")
    svc.shutdown()

    # 12.5 a big job under exchange="fused": one R1 launch.
    svc, journal = service(JobConfig(exchange="fused", settle_delay_s=0.01))
    reset()
    t0 = time.perf_counter()
    svc.start()
    out = svc.submit(x32, tenant="acme")[1].result(timeout=300)
    got = launched("serve big job fused", keys_path | {"ring_exchange_kernel"})
    if got["ring_exchange_kernel"] != 1 or not same_bits(out, ref32):
        raise AssertionError(f"serve big fused job: launches {got}")
    log(f"serve 12.5 big job 2^26 int32 exchange=fused: numpy's bits, launches {got}, "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    svc.shutdown()

    # 12.6 a slice loss: evicted, re-admitted, probed, exact; the time to
    # recover (faulted minus healthy) in turns.
    inj = FaultInjector()
    svc = SortService(8, job=fast, serve=ServeConfig(), journal=(journal := EventLog()),
                      injector=inj)
    svc.prewarm(sizes=[1 << 19])
    x = random_keys(rng, 1 << 19, np.int32)
    refx = np.sort(x)
    turns = []
    for kind in ("healthy", "faulted", "faulted", "healthy") * 2:
        if kind == "faulted":
            inj.fail_once(0, "slice")
        n_ev = len(journal)
        t0 = time.perf_counter()
        out = svc.submit(x, tenant="acme")[1].result(timeout=120)
        turns.append((kind, (time.perf_counter() - t0) * 1e3))
        types = [e.type for e in journal.events()[n_ev:]]
        if not same_bits(out, refx):
            raise AssertionError("serve slice loss: output differs")
        if kind == "faulted" and not (types.index("job_evicted") < types.index("job_readmitted")
                                      < types.index("job_done")):
            raise AssertionError(f"serve slice loss: events {types}")
    if svc.stats()["slices"] != 8 or svc.stats()["done"] != 8:
        raise AssertionError(f"serve slice loss: {svc.stats()}")
    med = {k: float(np.median([t for n, t in turns if n == k])) for k in ("healthy", "faulted")}
    log(f"time to recover, serve slice loss (fail_once(0, 'slice'), 2^19 int32): "
        f"{med['faulted'] - med['healthy']:.3f} ms (faulted {med['faulted']:.3f}, healthy "
        f"{med['healthy']:.3f}, median of 4 in turns; the probe passed, 8 slices kept) [{card}]")
    svc.shutdown()

    # 12.7 a hang on a slice: the bounded wait evicts it at its bound.
    hang_job = JobConfig(settle_delay_s=0.01, heartbeat_timeout_s=1.0, exec_allowance_floor_s=0.5,
                         exec_allowance_keys_per_s=1e9, compile_grace_s=1.0)
    inj = FaultInjector()
    svc = SortService(8, job=hang_job, serve=ServeConfig(), journal=(journal := EventLog()),
                      injector=inj)
    svc.prewarm(sizes=[1 << 19])
    svc.submit(x, tenant="acme")[1].result(timeout=120)  # warms slice 0's lane
    inj.hang_once(0, "slice", seconds=4.0)
    t0 = time.monotonic()
    out = svc.submit(x, tenant="acme")[1].result(timeout=120)
    took = time.monotonic() - t0
    ev = [e for e in journal.events() if e.type == "job_evicted"]
    bound = hang_job.heartbeat_timeout_s + hang_job.exec_allowance_floor_s + len(x) / 1e9
    if not ev or "wait exceeded" not in ev[0].fields["reason"] or not same_bits(out, refx):
        raise AssertionError(f"serve hang: evictions {[e.fields for e in ev]}")
    first = ev[0].mono - t0
    if first > bound + 0.5:
        raise AssertionError(f"serve hang: evicted after {first:.3f} s, bound {bound:.3f} s")
    log(f"serve 12.7 hang_once(0, 'slice', 4 s): evicted at {first:.3f} s (bound {bound:.3f} s), "
        f"{len(ev)} eviction(s), exact result after {took:.3f} s")
    svc.shutdown()

    # 12.8 a re-form under the big job retires the dead worker's slice.
    inj = FaultInjector()
    svc = SortService(8, job=fast, serve=ServeConfig(), journal=(journal := EventLog()),
                      injector=inj)
    inj.fail_once(5, "spmd")
    inj.fail_once(5, "probe")
    out = svc.submit(x32, tenant="acme")[1].result(timeout=300)
    retired = [(e.fields["slice"], e.fields.get("reason"))
               for e in journal.events() if e.type == "slice_retired"]
    if not same_bits(out, ref32) or retired != [(5, "mesh_reform")] or svc.stats()["slices"] != 7:
        raise AssertionError(f"serve re-form: retired {retired}, {svc.stats()}")
    out = svc.submit(x, tenant="blue")[1].result(timeout=120)
    if not same_bits(out, refx):
        raise AssertionError("serve after re-form: output differs")
    log(f"serve 12.8 fail_once(5, 'spmd') under the 2^26 job: re-formed over 7, slice 5 retired "
        f"(probe failed), 7 slices serve on, exact results")
    svc.shutdown()

    # 12.9 admission: the bounds, SLO shedding, weights.
    svc, journal = service(max_queue_depth=3, max_tenant_inflight=2)
    small = random_keys(rng, 1 << 16, np.int32)
    reasons = [svc.submit(small, tenant=t)[0].reason for t in ("a", "a", "a", "b", "c", "d")]
    if reasons != ["admitted", "admitted", "tenant_limit", "admitted", "queue_full", "queue_full"]:
        raise AssertionError(f"serve admission verdicts {reasons}")
    svc.shutdown()
    svc, journal = service(slice_devices=8, slo_shed_ms=1.0, max_queue_depth=256,
                           max_tenant_inflight=256)
    svc.start()
    tickets, shed = [], None
    xs = random_keys(rng, (1 << 20) - 1, np.int32)
    for _ in range(200):  # arrivals faster than one slice serves: the wait grows
        v, tk = svc.submit(xs, tenant="acme")
        if not v.admitted:
            shed = v.reason
            break
        tickets.append(tk)
        time.sleep(0.0002)
    for tk in tickets:
        tk.result(timeout=300)
    time.sleep(0.05)
    v, tk = svc.submit(small, tenant="acme")
    if tk is not None:
        tk.result(timeout=60)
    if shed != "slo_shed" or not v.admitted:
        raise AssertionError(f"serve slo_shed: shed {shed}, after the drain {v.reason}")
    svc.shutdown()
    svc, journal = service(slice_devices=8, tenant_weights={"acme": 2.0})
    for _ in range(6):
        for t in ("acme", "blue"):
            svc.submit(random_keys(rng, 1 << 18, np.int32), tenant=t)
    svc.start()
    svc.shutdown()
    order = [e.fields["tenant"] for e in journal.events() if e.type == "job_dequeued"]
    if order[:6].count("acme") < 4:
        raise AssertionError(f"serve weights acme=2: order {order}")
    log(f"serve 12.9 admission verdicts {reasons}; slo_shed after {len(tickets)} queued jobs, "
        f"admitted again once drained; weights acme=2 dequeue order {order}")

    # 12.10 cli serve as a subprocess: a scrape, SIGINT with jobs queued.
    # The first file (2^22 lines) is a big job on the whole mesh; the two
    # small files behind it are read and queued while it runs, and the
    # fourth prompt comes at once (3 jobs pending < --max-in-flight 4).
    scratch = Path(tempfile.mkdtemp(prefix="serve_", dir=work))
    try:
        files = []
        for i, n in enumerate((1 << 22, 1 << 12, 1 << 12)):
            p = scratch / f"in{i}.txt"
            p.write_text("".join(f"{v}\n" for v in random_keys(rng, n, np.int32).tolist()))
            files.append(p)
        out_path, jpath, errpath = scratch / "out.txt", scratch / "serve.jsonl", scratch / "err.txt"
        t0 = time.perf_counter()
        with open(errpath, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dsort_tpu_torch.cli", "serve", "-o", str(out_path),
                 "--max-in-flight", "4", "--metrics-port", "0", "--journal", str(jpath)],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                env={**os.environ, "PYTHONPATH": str(ROOT)}, text=True)
        buf = []

        def pump():
            while ch := proc.stdout.read(1):
                buf.append(ch)

        threading.Thread(target=pump, daemon=True).start()
        for i, p in enumerate(files):
            proc.stdin.write(f"tenant={tenants[i % 3]} {p}\n")
        proc.stdin.flush()  # stdin stays open: the REPL waits at its next prompt
        deadline = time.monotonic() + 120
        while "".join(buf).count("Enter the filename") < 4:
            if time.monotonic() > deadline or proc.poll() is not None:
                proc.kill()
                raise AssertionError(f"cli serve: no 4th prompt; {errpath.read_text()[-2000:]}")
            time.sleep(0.002)
        port = int(re.search(r"127\.0\.0\.1:(\d+)/metrics", errpath.read_text()).group(1))
        scrape = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=10).read().decode()
        admitted = sum(float(ln.rsplit(" ", 1)[1]) for ln in scrape.splitlines()
                       if ln.startswith("dsort_admissions_total{") and 'reason="admitted"' in ln)
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        wall = time.perf_counter() - t0
        recs = EventLog.read_jsonl(str(jpath))
        types = [r["type"] for r in recs]
        drain = next(r for r in recs if r["type"] == "serve_drain")
        want_bytes = "".join(f"{v}\n" for v in np.sort(np.loadtxt(files[-1], dtype=np.int64))
                             .tolist()).encode()
        if (rc != 0 or types[-1] != "serve_stop" or types.count("job_done") != 3
                or out_path.read_bytes() != want_bytes or admitted != 3 or not drain["queued"]):
            raise AssertionError(f"cli serve: rc {rc}, {types[-3:]}, {types.count('job_done')} "
                                 f"done, admitted {admitted}, drain {drain}; "
                                 f"{errpath.read_text()[-2000:]}")
        log(f"serve 12.10 cli serve subprocess (--max-in-flight 4 --metrics-port 0 --journal): "
            f"a 2^22-line big job then two 2^12-line files, 3 tenants; /metrics scraped on "
            f"localhost (admitted {admitted:g}); SIGINT with {drain['queued']} queued + "
            f"{drain['in_flight']} in flight: exit {rc}, serve_drain then serve_stop, 3 jobs done, "
            f"output file = the last file's sort -n; {wall:.1f} s wall from the launch")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # 12.11 the planner's exchange (autotune on) at 2^26 uniform int32 and
    # 2^24 zipf(1.3) int64, from the journal's plan_decision.
    auto = SampleSort(VirtualMesh(P), JobConfig(autotune=True))
    picks = {}
    for label, data, ref in (("2^26 uniform int32", x32, ref32), ("2^24 zipf(1.3) int64", z, refz)):
        journal = EventLog()
        reset()
        out = auto.sort(data, Metrics(journal=journal))
        (p,) = [e.fields for e in journal.events() if e.type == "plan_decision"]
        if not same_bits(out, ref) or replay_decision("exchange", p["inputs"])[0] != p["chosen"]:
            raise AssertionError(f"autotune {label}: {p}")
        picks[label] = p["chosen"]
        log(f"serve 12.11 autotune {label}: planned exchange={p['chosen']} (skew "
            f"{p['inputs']['max_mean_ratio']}, fused_ok {p['inputs']['fused_ok']}), numpy's bits, "
            f"launches {counts()}")

    # 12.12 a real device-side assert in a child service.
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--serve-real-error-child"], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    try:
        rep = json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        raise AssertionError(f"serve real-error child printed no report (rc {child.returncode}): "
                             f"{child.stdout[-2000:]} {child.stderr[-2000:]}") from e
    if child.returncode != 3:
        raise AssertionError(f"serve real-error child: rc {child.returncode}, {rep}")
    log(f"serve 12.12 real device-side assert in a child service: outcomes {rep['outcomes']}, "
        f"{len(rep['retired'])} slices retired {rep['retired']}, shutdown returned "
        f"{rep['closed']} after {rep['seconds']} s, child exit {child.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 12 serving: {time.perf_counter() - t_phase:.1f} s wall [{card}]")


def introspection(card, x32, ref32, tk, tv, ref_k, ref_v, reset, counts, launched, keys_path,
                  kv_merge, work) -> None:
    """Phase 13: the introspection plane on the card.

    13.1 `SpmdScheduler.sort` of phase 4's 2^26 int32 under the default
    ``alltoall`` and under ``fused``, journaled into a log that rotates at
    4 KiB (``--journal-rotate-mb``'s rule), memwatched and ledgered: the
    first job journals one ``variant_compiled`` per new variant, the
    repeat none, and a sort with all of it off launches the same K1 / K2 /
    tile-merge / R1 counts as the first and the repeat; the on/off
    host-to-host medians of both routes in turns; ``cli report --analyze
    --analyze-json --chrome-trace`` on the rotated set (one source, the
    critical phase the journal's own largest, the memory high-water at
    least the input's bytes, a Chrome trace of one pid).  13.2 ``cli
    terasort --journal --memwatch`` of phase 5's 2^23 records (its
    secondary key keeps the all-to-all combine, as the reference's) and
    the same records through ``sort_kv(exchange="fused")`` journaled and
    memwatched (R2 and the gather), launches held to an unobserved run;
    ``cli report --conform`` of both exits 0.  13.3 two ranks of
    `tools.mh_proc` on the card, each journaling and with a flight
    directory: ``cli report --merge --analyze`` gives a monotonic
    two-source timeline whose critical source, phases and straggler equal
    what the journals' own records give; then the crash drill with
    journals, whose merged trace and postmortem bundle name the resume
    path.  13.4 ``cli serve --metrics-port`` as a subprocess with a few
    jobs: ``cli top URL --interval 0.5 --count 2`` exits 0 with the
    admission, cache and ledger tables, ``cli top`` against a dead port
    exits 1.  13.5 every journal phases 8-13 wrote conforms to the
    trace contracts.
    """
    import contextlib
    import io
    import os
    import re
    import shutil
    import socket
    import tempfile
    import threading

    from dsort_tpu_torch import cli
    from dsort_tpu_torch.analysis.spec.contracts import conformance_report
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.obs import LEDGER, FlightRecorder, MemWatch
    from dsort_tpu_torch.obs.merge import (
        expand_path_args,
        group_rotated,
        merge_journals,
        read_journal_set,
        rotated_set,
    )
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import SpmdScheduler
    from dsort_tpu_torch.tools import mh_proc
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    dev_type = VirtualMesh(P).device.type
    main_kernels = set(keys_path) | {"ring_exchange_kernel", "ring_exchange_kernel+kv",
                                     "gather_rows_kernel"}
    main_kernels |= {k + RANK for k in keys_path}

    def of_path(got: dict) -> dict:
        return {k: v for k, v in got.items() if k in main_kernels and v}

    def cli_out(argv) -> tuple[int, str]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        return rc, buf.getvalue()

    scratch = Path(tempfile.mkdtemp(prefix="introspection_", dir=work))
    try:
        # -- 13.1 a journaled, memwatched, ledgered SpmdScheduler.sort -------
        # First calls an earlier phase made with no recording Metrics wait
        # in the ledger's queue; hand them to a journal of their own, so
        # this job's journal holds only its own.
        LEDGER.drain_to(Metrics(journal=EventLog()))
        jpath = scratch / "spmd.jsonl"
        rotate_mb = 4 / 1024
        journal = EventLog(rotate_bytes=int(rotate_mb * (1 << 20)))
        sched = SpmdScheduler(P, job=JobConfig(settle_delay_s=0.01))

        def observed(exchange):
            m = Metrics(journal=journal)
            MemWatch().attach(m)
            out = sched.sort(x32, metrics=m, exchange=exchange)
            journal.flush_jsonl(str(jpath))
            return out

        def unobserved(exchange):
            return sched.sort(x32, metrics=Metrics(), exchange=exchange)

        route_launches = {}
        for route in ("alltoall", "fused"):
            need = keys_path | ({"ring_exchange_kernel"} if route == "fused" else set())
            runs = {}
            for label, fn in (("first", observed), ("repeat", observed), ("off", unobserved)):
                before = len(journal)
                reset()
                out = fn(route)
                got = launched(f"introspection {route} {label}", need)
                if not same_bits(out, ref32):
                    raise AssertionError(f"introspection {route} {label}: differs from numpy")
                compiled = [e.fields["variant"] for e in journal.events()[before:]
                            if e.type == "variant_compiled"]
                runs[label] = (of_path(got), compiled)
            first, repeat, off = runs["first"], runs["repeat"], runs["off"]
            if not first[1] or len(set(first[1])) != len(first[1]) or repeat[1] or off[1]:
                raise AssertionError(f"introspection {route}: variant_compiled first {first[1]}, "
                                     f"repeat {repeat[1]}, off {off[1]}")
            if not first[0] == repeat[0] == off[0]:
                raise AssertionError(f"introspection {route}: launches observed {first[0]} / "
                                     f"{repeat[0]} against unobserved {off[0]}")
            route_launches[route] = off[0]
            log(f"intro 13.1 SpmdScheduler.sort 2^26 int32 {route}: numpy's bits; first job "
                f"journaled {len(first[1])} variant_compiled {first[1]}, the repeat none; "
                f"launches with journal + memwatch + ledger {first[0]} = unobserved {off[0]}")
        # The price of observing, host to host, in turns (on off off on).
        for route in ("alltoall", "fused"):
            walls = {True: [], False: []}
            for _ in range(3):
                for on in (True, False, False, True):
                    walls[on] += host_times(lambda: (observed if on else unobserved)(route), 1)
            on_ms, off_ms = float(np.median(walls[True])), float(np.median(walls[False]))
            log(f"time intro 13.1 SpmdScheduler.sort 2^26 int32 {route} host to host: journal + "
                f"memwatch + ledger on {on_ms:.3f} ms, off {off_ms:.3f} ms (median of 6 each, "
                f"in turns; {100 * (on_ms - off_ms) / off_ms:+.2f}%) [{card}]")
        pieces = rotated_set(str(jpath))
        groups = group_rotated(expand_path_args([str(jpath)]))
        recs, skipped = read_journal_set(pieces)
        if (len(pieces) < 3 or len(groups) != 1 or skipped
                or [r["seq"] for r in recs] != list(range(len(journal)))):
            raise AssertionError(f"introspection rotation: {len(pieces)} pieces, {len(groups)} "
                                 f"sources, {skipped} skipped, {len(recs)} of {len(journal)}")
        vpath, tpath = scratch / "verdict.json", scratch / "trace.json"
        rc, text = cli_out(["report", str(jpath), "--analyze", "--analyze-json", str(vpath),
                            "--chrome-trace", str(tpath)])
        verdict = json.loads(vpath.read_text())
        trace = json.loads(tpath.read_text())
        hbm = (verdict.get("hbm") or {}).get("bytes_in_use", 0)
        pids = {e["pid"] for e in trace["traceEvents"]}
        # The critical phase is one of the sort's and the journal's own
        # largest: the phase_end seconds summed here, apart from the analyzer.
        phase_sum: dict[str, float] = {}
        for r in recs:
            if r["type"] == "phase_end":
                phase_sum[r["phase"]] = phase_sum.get(r["phase"], 0.0) + r["seconds"]
        truth = max(phase_sum, key=phase_sum.get)
        if (rc != 0 or verdict["critical_phase"] != truth
                or truth not in ("partition", "spmd_sort", "assemble")
                or hbm < x32.nbytes or pids != {1} or not verdict["conformance"]["ok"]):
            raise AssertionError(f"cli report --analyze: rc {rc}, critical "
                                 f"{verdict['critical_phase']} (journal: {truth}), hbm {hbm}, "
                                 f"pids {pids}\n{text}")
        log(f"intro 13.1 rotated journal: {len(pieces)} pieces at {rotate_mb * 1024:.0f} KiB "
            f"stitched into one source of {len(recs)} records; cli report --analyze: critical "
            f"{verdict['critical_src']} / {verdict['critical_phase']} (phases summed "
            f"{ {k: round(v * 1e3, 3) for k, v in phase_sum.items()} } ms), splits "
            f"{verdict['splits']}, hbm high-water {hbm} bytes in {verdict['hbm']['phase']} "
            f"(input {x32.nbytes}), first-call ledger {len(verdict['compiles'])} variants; "
            f"Chrome trace {len(trace['traceEvents'])} events, pid {sorted(pids)} [{card}]")
        for line in text.splitlines()[:8]:
            log(f"  {line}")
        del journal, sched

        # -- 13.2 records: cli terasort and the fused sort_kv, journaled -----
        rec_in, rec_ref, rec_out = scratch / "t.bin", scratch / "ref.bin", scratch / "out.bin"
        ingest.write_terasort_file(rec_in, tk, tv)
        ingest.write_terasort_file(rec_ref, ref_k, ref_v)
        tj = scratch / "terasort.jsonl"
        reset()
        t0 = time.perf_counter()
        if cli.main(["terasort", str(rec_in), "-o", str(rec_out), "--exchange", "fused",
                     "--journal", str(tj), "--memwatch"]) != 0:
            raise AssertionError("cli terasort --journal --memwatch failed")
        wall = (time.perf_counter() - t0) * 1e3
        got = counts()
        if rec_out.read_bytes() != rec_ref.read_bytes():
            raise AssertionError("cli terasort: records differ from the key order")
        ttypes = [r["type"] for r in EventLog.read_jsonl(str(tj))]
        if "hbm_watermark" not in ttypes or ttypes[-1] != "job_done":
            raise AssertionError(f"cli terasort journal: {ttypes[:5]} ... {ttypes[-3:]}")
        log(f"intro 13.2 cli terasort --journal --memwatch 2^23 records (--exchange fused: the "
            f"secondary key keeps the all-to-all combine, as the reference's): byte-identical, "
            f"{wall:.1f} ms wall, {ttypes.count('hbm_watermark')} watermarks, launches "
            f"{of_path(got)} [{card}]")
        for path in (rec_in, rec_ref, rec_out):
            path.unlink()
        ss = SampleSort(VirtualMesh(P))
        kj = scratch / "sort_kv.jsonl"
        kv_log = EventLog()
        kv_runs = {}
        for label, on in (("first", True), ("repeat", True), ("off", False)):
            m = Metrics(journal=kv_log) if on else Metrics()
            if on:
                MemWatch().attach(m)
            reset()
            ok, ov = ss.sort_kv(tk, tv, m, exchange="fused")
            got = launched(f"sort_kv fused {label}", kv_merge | {"ring_exchange_kernel+kv",
                                                                 "gather_rows_kernel"})
            if not (np.array_equal(ok, ref_k) and np.array_equal(ov, ref_v)):
                raise AssertionError(f"sort_kv fused {label}: records differ from numpy")
            kv_runs[label] = of_path(got)
        if not kv_runs["first"] == kv_runs["repeat"] == kv_runs["off"]:
            raise AssertionError(f"sort_kv fused launches observed/unobserved: {kv_runs}")
        kv_log.flush_jsonl(str(kj))
        compiled = [e.fields["variant"] for e in kv_log.events() if e.type == "variant_compiled"]
        rc_t, conf_t = cli_out(["report", str(tj), "--conform"])
        rc_k, conf_k = cli_out(["report", str(kj), "--conform"])
        if rc_t or rc_k or len(compiled) != len(set(compiled)) or not compiled:
            raise AssertionError(f"cli report --conform: {rc_t} {rc_k}; {compiled}\n{conf_t}"
                                 f"\n{conf_k}")
        log(f"intro 13.2 sort_kv 2^23 records fused, journaled + memwatched: equal to numpy's "
            f"order, first call journaled {compiled}, launches {kv_runs['first']} = unobserved; "
            f"cli report --conform: exit {rc_t} (terasort), {rc_k} (sort_kv) [{card}]")
        for line in conf_k.splitlines()[:1]:
            log(f"  {line}")
        del ss, kv_log

        # -- 13.3 two ranks on the card: merged journals, the crash drill ----
        flights = scratch / "flights"
        n_rank = INTRO_MH_KEYS
        res = mh_proc.run_cluster(2, scratch / "mh", "uniform32", local=4, n=n_rank,
                                  device=dev_type, env={"DSORT_MH_FLIGHT_DIR": str(flights)},
                                  timeout_s=240.0)
        if [rc for rc, _ in res] != [0, 0]:
            raise AssertionError(f"13.3 cluster: {[rc for rc, _ in res]}\n"
                                 + "\n".join(err[-1500:] for _, err in res))
        metas = mh_proc.read_mode(scratch / "mh", 0, 2)
        union = np.concatenate([mh_proc.rank_data("uniform32", r, 2, n_rank) for r in range(2)])
        if not same_bits(np.concatenate([mm["out"] for mm in metas]), np.sort(union)):
            raise AssertionError("13.3 cluster: output differs from numpy")
        paths = [str(scratch / "mh" / "0" / f"journal_{r}.jsonl") for r in range(2)]
        merged, skipped = merge_journals(paths)
        vpath = scratch / "mh_verdict.json"
        rc, text = cli_out(["report", "--merge", *paths, "--analyze", "--analyze-json",
                            str(vpath)])
        v = json.loads(vpath.read_text())
        monos = [r["mono"] for r in merged]
        # The ground truth, from the journals' own records.
        ends, phases = {}, {}
        for r in merged:
            ends[r["src"]] = r["mono"]
            if r["type"] == "phase_end" and isinstance(r.get("seconds"), (int, float)):
                per = phases.setdefault(f"p{r['src']}", {})
                per[r["phase"]] = per.get(r["phase"], 0.0) + r["seconds"]
        busy = {src: sum(per.values()) for src, per in phases.items()}
        truth = {
            "critical_src": f"p{max(ends, key=ends.get)}",
            "phases": {src: {k: round(s, 6) for k, s in sorted(per.items())}
                       for src, per in phases.items()},
            "straggler": max(busy, key=busy.get),
        }
        got = {"critical_src": v["critical_src"], "phases": v["phases"],
               "straggler": v["straggler"]["name"]}
        if (rc or skipped or {r["src"] for r in merged} != {0, 1} or monos != sorted(monos)
                or got != truth):
            raise AssertionError(f"13.3 merged verdict: rc {rc}, skipped {skipped}, {got} != "
                                 f"{truth}\n{text}")
        log(f"intro 13.3 2 ranks x 2^22 int32 on the card: merged {len(merged)} records of 2 "
            f"sources, monotonic; verdict critical {v['critical_src']} / "
            f"{v['critical_phase']}, straggler {v['straggler']['name']} (score "
            f"{v['straggler']['score']}), phases {v['phases']} = the journals' own [{card}]")
        ck = {"DSORT_MH_CKPT_DIR": str(scratch / "mh_ck"), "DSORT_MH_FLIGHT_DIR": str(flights)}
        n_ck = INTRO_MH_DRILL
        expect = np.sort(mh_proc.rank_data("ckpt", 0, 1, n_ck))
        for run, extra in (("run1", {"DSORT_MH_DIE_BEFORE_RANGE": "1"}), ("run2", {})):
            res = mh_proc.run_cluster(2, scratch / run, "ckpt", local=4, n=n_ck, device=dev_type,
                                      env={**ck, **extra}, timeout_s=240.0, group_timeout_s=60.0)
            want = [0, 17] if extra else [0, 0]
            if [rc for rc, _ in res] != want:
                raise AssertionError(f"13.3 drill {run}: {[rc for rc, _ in res]} != {want}\n"
                                     + "\n".join(err[-1500:] for _, err in res))
        metas = mh_proc.read_mode(scratch / "run2", 0, 2)
        if not same_bits(np.concatenate([mm["out"] for mm in metas]), expect):
            raise AssertionError("13.3 drill: the resumed output differs from numpy")
        paths = [str(scratch / "run2" / "0" / f"journal_{r}.jsonl") for r in range(2)]
        rc, text = cli_out(["report", "--merge", *paths])
        merged, _ = merge_journals(paths)
        restores = [r for r in merged if r["type"] == "checkpoint_restore"
                    and r.get("kind") == "multihost_partial"]
        bundles = [b for b in FlightRecorder.read_bundles(str(flights))
                   if b["recovery_path"] == "checkpoint_restore:multihost_partial"]
        if (rc or {r["src"] for r in restores} != {0, 1} or "kind=multihost_partial" not in text
                or not bundles or bundles[0]["state"]["mode"] != "multihost"):
            raise AssertionError(f"13.3 drill trace: rc {rc}, restores {restores}, bundles "
                                 f"{[b['recovery_path'] for b in bundles]}")
        log(f"intro 13.3 crash drill with journals (2 ranks, 2^22 int32 in all): the merged "
            f"resume trace names checkpoint_restore kind=multihost_partial in both sources; "
            f"{len(bundles)} postmortem bundles name {bundles[0]['recovery_path']} (resort_keys "
            f"{bundles[0]['detail'].get('resort_keys')}, state {bundles[0]['state']})")
        CENSUS.add_dir(scratch / "mh")
        CENSUS.add_dir(scratch / "run1")
        CENSUS.add_dir(scratch / "run2")

        # -- 13.4 cli top against a live cli serve --------------------------
        rng = np.random.default_rng(13)
        files = []
        for i, n in enumerate((1 << 16, 1 << 12, 1 << 14)):
            p = scratch / f"in{i}.txt"
            p.write_text("".join(f"{v}\n" for v in random_keys(rng, n, np.int32).tolist()))
            files.append(p)
        sj, errpath = scratch / "serve.jsonl", scratch / "serve_err.txt"
        with open(errpath, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dsort_tpu_torch.cli", "serve", "-o",
                 str(scratch / "out.txt"), "--metrics-port", "0", "--journal", str(sj),
                 "--journal-rotate-mb", "1", "--memwatch"],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                env={**os.environ, "PYTHONPATH": str(ROOT)}, text=True)
        buf = []

        def pump():
            while ch := proc.stdout.read(1):
                buf.append(ch)

        threading.Thread(target=pump, daemon=True).start()
        try:
            for i, p in enumerate(files):
                proc.stdin.write(f"tenant={('acme', 'blue')[i % 2]} {p}\n")
            proc.stdin.flush()
            deadline = time.monotonic() + 120
            while "".join(buf).count("Enter the filename") < len(files) + 1:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError(f"cli serve: jobs not served; "
                                         f"{errpath.read_text()[-2000:]}")
                time.sleep(0.01)
            port = int(re.search(r"127\.0\.0\.1:(\d+)/metrics", errpath.read_text()).group(1))
            url = f"http://127.0.0.1:{port}/metrics"
            t0 = time.perf_counter()
            rc, top = cli_out(["top", url, "--interval", "0.5", "--count", "2"])
            top_s = time.perf_counter() - t0
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = s.getsockname()[1]
            rc_dead, _ = cli_out(["top", f"http://127.0.0.1:{dead}/metrics"])
            proc.stdin.write("exit\n")
            proc.stdin.flush()
            rc_serve = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        panes = ("admissions:", "variant cache:", "variant ledger:")
        if (rc or rc_dead != 1 or rc_serve or top.count("jobs in flight") != 2
                or not all(p in top for p in panes)):
            raise AssertionError(f"cli top: rc {rc}, dead {rc_dead}, serve {rc_serve}\n{top}")
        recs, _ = read_journal_set(rotated_set(str(sj)))
        CENSUS.files.append((str(sj), recs))
        log(f"intro 13.4 cli top {url} --interval 0.5 --count 2 against cli serve (3 jobs, "
            f"2 tenants): exit 0 in {top_s:.2f} s with the admission, cache and ledger panes; "
            f"cli top against a closed port: exit {rc_dead}; cli serve exit {rc_serve}")
        for line in top.splitlines()[:14]:
            log(f"  {line}")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # -- 13.5 every journal of phases 8-13 against the trace contracts -------
    journals = CENSUS.journals()
    checked: dict[str, int] = {}
    n_records = 0
    for label, recs in journals:
        rep = conformance_report(recs)
        n_records += len(recs)
        if not rep["ok"]:
            raise AssertionError(f"13.5 {label}: trace contract violated: {rep['violations'][:3]}")
        for name, row in rep["contracts"].items():
            checked[name] = checked.get(name, 0) + row["checked"]
    log(f"intro 13.5 trace contracts over {len(journals)} journals of phases 8-13 "
        f"({n_records} records): no violation; scoped traces checked {checked}")
    log(f"phase 13 introspection: {time.perf_counter() - t_phase:.1f} s wall [{card}]")


def native_runtime(card, x32, ref32, z, refz, tk, tv, ref_k, ref_v, reset, launched, src,
                   want_bytes, work) -> None:
    """Phase 14: the native runtime.  ``x32`` / ``z`` are phase 4's 2^26
    uniform int32 and 2^24 zipf int64 (``ref32`` / ``refz`` numpy's order),
    ``tk, tv`` phase 5's 2^23 TeraSort records (``ref_k, ref_v`` their
    order), ``src`` phase 4's 10^6-line file (``want_bytes`` its sorted
    text).  The worker processes start first (each imports torch and opens
    its own CUDA context), while the host inputs are made, and idle while
    the host measurements run; every process the phase starts is stopped
    before it returns."""
    import os
    import shutil
    import socket
    import tempfile
    import threading
    from contextlib import contextmanager

    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.models import validate
    from dsort_tpu_torch.models.external_sort import ExternalSort
    from dsort_tpu_torch.models.wave_sort import ExternalWaveTeraSort
    from dsort_tpu_torch.ops import block_sort as tb
    from dsort_tpu_torch.ops import pallas_sort as ps
    from dsort_tpu_torch.ops.merge import merge_pairwise, merge_sorted_host
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.runtime import NativeCoordinator, _build, native
    from dsort_tpu_torch.runtime.worker import SortWorker
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    spill = Path(tempfile.mkdtemp(prefix="native_", dir=work))
    procs: list[subprocess.Popen] = []
    coords: list = []
    blocks = {"bitonic_tile_kernel", "bitonic_global_stage_kernel", "bitonic_tile_merge_kernel"}
    n32, nrec = len(x32), len(tk)

    def spawn(name, argv, k=1, **kw):
        """``k`` processes of ``argv`` from the checkout's root, stderr to a
        file of the spill directory."""
        out = []
        for _ in range(k):
            with open(spill / f"{name}_{len(procs)}.err", "wb") as err:
                out.append(subprocess.Popen(argv, cwd=str(ROOT), stdout=subprocess.DEVNULL,
                                            stderr=err, **kw))
            procs.append(out[-1])
        return out

    def workers(coord, dtype, name, k):
        return spawn(name, [sys.executable, "-m", "dsort_tpu_torch.runtime.worker", "--port",
                            str(coord.port), "--dtype", dtype], k)

    def coordinator():
        c = NativeCoordinator(port=0, heartbeat_timeout_s=120.0)
        coords.append(c)
        return c

    def err_tail(p):
        return "".join((f.read_text(errors="replace")[-1500:] for f in spill.glob(
            f"*_{procs.index(p)}.err")))

    @contextmanager
    def plain_routes():
        """The wrappers run their plain PyTorch versions on the card."""
        saved = tb._route, ps._route
        tb._route = ps._route = lambda x: False
        try:
            yield
        finally:
            tb._route, ps._route = saved

    try:
        # -- 14.1 the library, the selftest; the workers start -----------------
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("14.1: the native library is unavailable (no C++ compiler)")
        lib = _build.build_library()
        load_ms = (time.perf_counter() - t0) * 1e3
        gxx = subprocess.run([_build.compiler(), "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
        log(f"native 14.1 library {lib.name} loaded ({load_ms:.1f} ms; built in phase 1 beside "
            f"the kernels), {gxx}")
        # The drill clusters' first workers start first and join alone (while
        # the selftest builds), so their process is the coordinator's worker
        # 0, the drill's victim; every other process starts after them.
        H, Z, F1, F2 = (coordinator() for _ in range(4))
        fp = [workers(F1, "int32", "drill", 1), workers(F2, "int32", "drill", 1)]
        t_spawn = time.perf_counter()
        st = _build.build_selftest()
        build_s = time.perf_counter() - t_spawn
        t0 = time.perf_counter()
        r = subprocess.run([str(st)], capture_output=True, text=True, timeout=300)
        if r.returncode != 0 or "SELFTEST PASS" not in r.stdout:
            raise AssertionError(f"14.1 selftest exit {r.returncode}:\n{r.stdout[-1500:]}\n"
                                 f"{r.stderr[-1500:]}")
        log(f"native 14.1 selftest {st.name}: exit 0, SELFTEST PASS in "
            f"{time.perf_counter() - t0:.2f} s (built in {build_s:.1f} s)")
        for c, ps_ in zip((F1, F2), fp):
            c.wait_workers(1, timeout_s=600.0)
        for c, ps_ in zip((F1, F2), fp):
            ps_ += workers(c, "int32", "drill", 3)
        hp, zp = workers(H, "int32", "h", 4), workers(Z, "int64", "z", 4)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            cli_port = s.getsockname()[1]
        cli_out, cli_journal = spill / "cli_out.txt", spill / "cli_journal.jsonl"
        cli_coord = spawn("cli_coordinator", [
            sys.executable, "-m", "dsort_tpu_torch.cli", "coordinator", "--workers", "4",
            "--port", str(cli_port), "--join-timeout", "600", "-o", str(cli_out), "--journal",
            str(cli_journal)], stdin=subprocess.PIPE)[0]
        cli_workers = spawn("cli_worker", [sys.executable, "-m", "dsort_tpu_torch.cli", "worker",
                                           "--port", str(cli_port)], 4)
        # 14.2's inputs, while the workers start (nothing here is timed).
        runs8 = [np.sort(c) for c in np.split(x32, 8)]
        x24 = x32[: 1 << 24]
        in24, dst = spill / "in24.txt", spill / "out.txt"
        ingest.write_ints_file(in24, x24)
        sorted24, sorted6 = np.sort(x24), np.sort(ingest.read_ints_file(src))
        rec_in, rec_ref = spill / "tera_in.bin", spill / "tera_ref.bin"
        ingest.write_terasort_file(rec_in, tk, tv)
        ingest.write_terasort_file(rec_ref, ref_k, ref_v)
        buf, sbuf = np.fromfile(rec_in, np.uint8), np.fromfile(rec_ref, np.uint8)
        for c in (H, Z, F1, F2):
            c.wait_workers(4, timeout_s=600.0)
        log(f"native 14.4 {len(procs) - 1} worker processes (--backend torch, cuda, --kernel "
            f"auto) and the cli coordinator started; the 4 clusters joined "
            f"{time.perf_counter() - t_spawn:.1f} s after the spawn")

        # -- 14.2 native against plain, in turns ----------------------------------
        abba = ("plain", "native", "native", "plain")

        def turns(label, plain, fast, check, order=abba):
            """Plain and native alternately (``order``), each result checked."""
            times = {"plain": [], "native": []}
            for which in order:
                t0 = time.perf_counter()
                out = (plain if which == "plain" else fast)()
                times[which].append((time.perf_counter() - t0) * 1e3)
                check(which, out)
            p, n = (float(np.median(times[k])) for k in ("plain", "native"))
            log(f"native 14.2 {label}: identical bits; native {n:.1f} ms, plain {p:.1f} ms "
                f"(medians, in turns {' '.join(order)}: "
                f"{[round(t, 1) for t in times['plain']]} / "
                f"{[round(t, 1) for t in times['native']]}) = {p / n:.2f}x [{card}]")

        def equal_to(truth):
            """A check that every turn returns ``truth``'s bits."""
            def check(which, out):
                if not same_bits(out, truth):
                    raise AssertionError(f"14.2 the {which} turn's result differs")
            return check

        def one_answer():
            """A check that every turn returns the first turn's answer."""
            first = []

            def check(which, out):
                if not first:
                    first.append(out)
                elif not (same_bits(out, first[0]) if isinstance(out, np.ndarray)
                          else out == first[0]):
                    raise AssertionError(f"14.2 the {which} turn's result differs")
            return check

        def no_dip(which, out):
            if out != -1:
                raise AssertionError(f"14.2 the {which} order check found a dip at {out}")

        turns("merge_sorted_host of 8 runs of 2^23 int32 (native kway_merge) against the numpy "
              "pairwise merge", lambda: merge_pairwise(list(runs8)),
              lambda: merge_sorted_host(runs8), equal_to(ref32))
        del runs8
        # The numpy and Python plain versions take seconds at 2^24 lines and
        # 2^23 records: those pairs time the plain version once, between two
        # native runs.
        once = ("native", "plain", "native")
        for label, path, want, order in (("10^6-line cli run file", src, None, None),
                                         ("2^24-line file", in24, x24, once)):
            check = equal_to(want) if want is not None else one_answer()
            turns(f"read_ints_file of the {label} against the numpy grammar",
                  lambda: ingest.parse_ints_plain(path.read_bytes(), np.int32),
                  lambda: ingest.read_ints_file(path, np.int32), check, order or abba)
        for label, data, want, order in (("10^6 sorted keys", sorted6, want_bytes, None),
                                         ("2^24 sorted keys", sorted24, None, once)):
            written = one_answer()

            def check(which, _):
                if want is not None and dst.read_bytes() != want:
                    raise AssertionError(f"14.2 write {label} ({which}): bytes differ")
                written(which, dst.read_bytes())
            turns(f"write_ints_file of the {label} against the Python formatter",
                  lambda: dst.write_bytes(ingest.format_ints_plain(data)),
                  lambda: ingest.write_ints_file(dst, data), check, order or abba)
        del x24, sorted24, sorted6
        in24.unlink()
        turns("fnv_multiset of the 2^23 records against _fnv_multiset_py",
              lambda: validate._fnv_multiset_py(buf, nrec, 100),
              lambda: native.fnv_multiset(buf, nrec, 100), one_answer(), once)
        if native.fnv_multiset(sbuf, nrec, 100) != native.fnv_multiset(buf, nrec, 100):
            raise AssertionError("14.2 the sorted records' multiset checksum differs")
        turns("check_order_be of the sorted 2^23 records against _check_order_chunk",
              lambda: validate._check_order_chunk(sbuf, nrec),
              lambda: native.check_order_be(sbuf, nrec, 100, 10), no_dip)
        dip = native.check_order_be(buf, nrec, 100, 10)
        if dip < 1 or dip != validate._check_order_chunk(buf, nrec):
            raise AssertionError(f"14.2 the unsorted records' first dip: native {dip}")
        del buf, sbuf

        # -- 14.3 out-of-core ------------------------------------------------------
        in32, out32 = spill / "in_int32.bin", spill / "out_int32.bin"
        x32.tofile(in32)
        m = Metrics(journal=EventLog())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ExternalSort(run_elems=n32 // 8, spill_dir=str(spill), job_id="ext32").sort_binary_file(
            str(in32), str(out32), np.int32, m)
        wall = (time.perf_counter() - t0) * 1e3
        if not same_bits(np.fromfile(out32, np.int32), ref32):
            raise AssertionError("14.3 ExternalSort: output differs from numpy")
        if m.counters.get("native_merges", 0) < 1:
            raise AssertionError(f"14.3 ExternalSort: no native merge {dict(m.counters)}")
        log(f"native 14.3 ExternalSort int32 n=2^26 run_elems=2^23 (8 runs): equal to numpy, "
            f"native_merges {m.counters['native_merges']}, {wall:.1f} ms wall, merge "
            f"{m.phase_s['merge'] * 1e3:.1f} ms (PR 14's numpy merge: 1,733-1,991 ms of "
            f"2,512.6-2,738.6), phases {m.summary()['phases_ms']} [{card}]")
        for path in (in32, out32):
            path.unlink()
        shutil.rmtree(spill / "ext32", ignore_errors=True)
        m = Metrics(journal=EventLog())
        rec_out = spill / "tera_out.bin"
        t0 = time.perf_counter()
        ExternalWaveTeraSort(VirtualMesh(8), wave_recs=nrec // 8, spill_dir=str(spill),
                             job_id="tera_wave", resume=False).sort_file(
            str(rec_in), str(rec_out), metrics=m)
        wall = (time.perf_counter() - t0) * 1e3
        if rec_out.read_bytes() != rec_ref.read_bytes():
            raise AssertionError("14.3 ExternalWaveTeraSort: records differ from the key order")
        done = [e for e in m.journal.events() if e.type == "job_done"][-1]
        if done.fields["counters"].get("native_merges", 0) < 1:
            raise AssertionError(f"14.3 ExternalWaveTeraSort: no native merge journaled "
                                 f"{done.fields['counters']}")
        log(f"native 14.3 ExternalWaveTeraSort(VirtualMesh(8)) wave_recs=2^20 of the 2^23 "
            f"records: byte-identical to the key order, native_merges "
            f"{m.counters['native_merges']} (journaled), {wall:.1f} ms wall, merge "
            f"{m.phase_s['merge'] * 1e3:.1f} ms [{card}]")
        for path in (rec_in, rec_ref, rec_out):
            path.unlink()
        shutil.rmtree(spill / "tera_wave", ignore_errors=True)

        # -- 14.4 the reference's job on the card -------------------------------------
        def job(c, data, ref, label):
            m = Metrics(journal=EventLog())
            t0 = time.perf_counter()
            out = c.run_job(data, num_shards=4, metrics=m)
            wall = (time.perf_counter() - t0) * 1e3
            if not same_bits(out, ref):
                raise AssertionError(f"14.4 {label}: output differs from numpy")
            return m, wall

        for label, c, data, ref in (("uniform int32 n=2^26", H, x32, ref32),
                                    ("zipf(1.3) int64 n=2^24", Z, z, refz)):
            for which in ("first", "second"):
                m, wall = job(c, data, ref, label)
                types = m.journal.types()
                if types.count("task_done") != 4 or m.counters["reassignments"] != 0:
                    raise AssertionError(f"14.4 {label}: {types}")
                log(f"native 14.4 NativeCoordinator + 4 workers, {label} ({which} job of the "
                    f"cluster): equal to numpy, {wall:.1f} ms wall, phases "
                    f"{m.summary()['phases_ms']} [{card}]")

        chunk = x32[: 1 << 24]
        dev_chunk = torch.from_numpy(chunk).cuda()
        lib_sorted = torch.sort(dev_chunk).values.cpu().numpy()
        for kernel, need in (("auto", blocks), ("pallas", {"tile_sort_kernel"})):
            with plain_routes():
                plain = (tb.block_sort(dev_chunk) if kernel == "auto"
                         else ps.pallas_sort(dev_chunk)).cpu().numpy()
            K = coordinator()
            w = SortWorker("127.0.0.1", K.port, kernel=kernel)
            th = threading.Thread(target=w.serve_forever, daemon=True)
            th.start()
            K.wait_workers(1, timeout_s=60.0)
            walls = []
            for rep in range(2):
                reset()
                t0 = time.perf_counter()
                out = K.run_job(chunk, num_shards=1)
                walls.append((time.perf_counter() - t0) * 1e3)
                got = launched(f"14.4 SortWorker --kernel {kernel} 2^24 int32", need)
            if not (same_bits(out, plain) and same_bits(out, lib_sorted)
                    and same_bits(out, np.sort(chunk))):
                raise AssertionError(f"14.4 SortWorker --kernel {kernel}: differs from the plain "
                                     f"version / torch.sort")
            K.shutdown()
            th.join(timeout=60)
            if th.is_alive():
                raise AssertionError("14.4 the in-process SortWorker did not stop")
            log(f"native 14.4 SortWorker (in this process) --kernel {kernel}, a 2^24 int32 chunk "
                f"on the card: equal to its plain version (the same network on the card), "
                f"torch.sort and numpy; launches {got}; {walls[0]:.1f} / {walls[1]:.1f} ms "
                f"wall through the coordinator (first / second) [{card}]")
        del dev_chunk

        for c in (F1, F2):  # the drill clusters' first 2^26 job, off the clock
            job(c, x32, ref32, "drill warm-up")

        def faulted(c, victim):
            """One 2^26 job whose worker 0 dies by ``kill -9`` right after its
            chunk is dispatched."""
            submit = c.submit

            def killing_submit(task_id, data):
                submit(task_id, data)
                if task_id == 0:
                    victim.kill()

            c.submit = killing_submit
            m, wall = job(c, x32, ref32, "kill -9 drill")
            types = m.journal.types()
            if ("worker_dead" not in types or "reassign" not in types
                    or m.counters["reassignments"] < 1 or c.num_live != 3):
                raise AssertionError(f"14.4 kill -9 drill: {types} {dict(m.counters)}")
            return m, wall

        walls = {"healthy": [], "faulted": []}
        drill_m = None
        for which, c, victim in (("healthy", H, None), ("faulted", F1, fp[0][0]),
                                 ("faulted", F2, fp[1][0]), ("healthy", H, None)):
            if victim is None:
                _, wall = job(c, x32, ref32, "healthy turn")
            else:
                drill_m, wall = faulted(c, victim)
            walls[which].append(wall)
        h, f = (float(np.median(walls[k])) for k in ("healthy", "faulted"))
        ev = [(e.type, e.fields.get("worker"), e.fields.get("task")) for e in
              drill_m.journal.events() if e.type in ("worker_dead", "reassign", "attempt_start")]
        log(f"native 14.4 SURVEY §0 drill, kill -9 of worker 0 right after its 2^24-key chunk "
            f"was dispatched, 2^26 int32: equal to numpy, reassignments "
            f"{drill_m.counters['reassignments']}, journal {ev}; time to recover {f - h:.1f} ms "
            f"(faulted {f:.1f} - healthy {h:.1f}, medians of 2 in turns healthy faulted faulted "
            f"healthy: {[round(t, 1) for t in walls['faulted']]} / "
            f"{[round(t, 1) for t in walls['healthy']]}) [{card}]")

        # -- 14.4 the CLI's user flow ------------------------------------------------
        golden = subprocess.run(["sort", "-n", str(src)], capture_output=True, check=True,
                                env={**os.environ, "LC_ALL": "C"}).stdout
        t0 = time.perf_counter()
        cli_coord.stdin.write(f"{src}\nexit\n".encode())
        cli_coord.stdin.close()
        rc = cli_coord.wait(timeout=300)
        wall = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            raise AssertionError(f"14.4 cli coordinator exit {rc}:\n{err_tail(cli_coord)}")
        rcs = [p.wait(timeout=60) for p in cli_workers]
        if rcs != [0, 0, 0, 0]:
            raise AssertionError(f"14.4 cli workers exit {rcs}")
        if cli_out.read_bytes() != golden or golden != want_bytes:
            raise AssertionError("14.4 cli coordinator output differs from sort -n")
        types = [r["type"] for r in EventLog.read_jsonl(str(cli_journal))]
        if types.count("worker_join") != 4 or types.count("task_done") != 4:
            raise AssertionError(f"14.4 cli coordinator journal: {types}")
        log(f"native 14.4 cli coordinator --workers 4 with 4 cli worker processes, the 10^6-line "
            f"file on stdin then exit: byte-identical to sort -n, exit 0 (workers 0), "
            f"{wall:.1f} ms from the file name to the exit [{card}]")
    finally:
        for c in coords:
            c.shutdown()
        for p in procs:
            if p.stdin is not None and not p.stdin.closed:
                p.stdin.close()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(spill, ignore_errors=True)
    stray = [p.returncode for p in hp + zp + fp[0] + fp[1] if p.returncode != -9]
    if any(stray) or len(stray) != 14:
        raise AssertionError(f"14 workers' exit codes after shutdown: {stray}")
    log(f"phase 14 native runtime: {time.perf_counter() - t_phase:.1f} s wall [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.data.partition import pad_kv_to_shards, pad_to_shards
    from dsort_tpu_torch.ops import _build
    from dsort_tpu_torch.ops import block_sort as tb
    from dsort_tpu_torch.ops import pallas_sort as ps
    from dsort_tpu_torch.ops import ring_kernel as rk
    from dsort_tpu_torch.ops.float_order import float_to_ordered_int, to_signed_keys
    from dsort_tpu_torch.parallel import exchange as ex
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort, cap_pair_policy
    from dsort_tpu_torch.utils.events import EventLog
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

    def reset():
        tb.reset_launch_counts()
        rk.reset_launch_counts()
        ps.reset_launch_counts()

    def counts():
        return {**tb.launch_counts(), **rk.launch_counts(), **ps.launch_counts()}

    # 1. build --------------------------------------------------------------
    # The native host library (g++, one process a source) builds beside the
    # kernels (nvcc, one process a source), all started together.
    from concurrent.futures import ThreadPoolExecutor

    from dsort_tpu_torch.runtime import _build as native_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_lib = pool.submit(native_build.build_library)
        lib_path = _build.build()
        native_path = native_lib.result()
    nvcc = "reused" if _build.last_build_s is None else f"nvcc {_build.last_build_s:.2f} s"
    gxx = ("reused" if native_build.last_build_s is None
           else f"g++ {native_build.last_build_s:.2f} s")
    _build.library()
    log(f"build: {lib_path.name} ({len(_build.sources())} sources) {nvcc}; {native_path.name} "
        f"({len(native_build.LIB_SOURCES)} sources) {gxx}; total with load "
        f"{time.perf_counter() - t0:.2f} s")
    if sorted(str(p.relative_to(ROOT)) for p in _build.sources()) != sorted(SOURCES.values()):
        raise AssertionError(f"built sources {_build.sources()} are not {SOURCES}")
    built_s_max = {(d, ranked): _build.library().dsort_bitonic_global_stages_max(
        d.itemsize, int(ranked)) for d, ranked in tb.STAGES_MAX}
    if built_s_max != tb.STAGES_MAX:
        raise AssertionError(f"kStagesMax {built_s_max} != STAGES_MAX {tb.STAGES_MAX}")
    log("global-stage S_max: " + ", ".join(
        f"{str(d).removeprefix('torch.')}{RANK if ranked else ''} {v}"
        for (d, ranked), v in tb.STAGES_MAX.items()))

    # 2. kernel vs plain at the main path's shapes ---------------------------
    n32, n64, nrec = 1 << 26, 1 << 24, 1 << 23
    err: dict[str, float] = {}

    def hold(name, label, kernel, plain):
        """Run ``kernel`` and ``plain`` (each returning a tuple of tensors)
        and require equal bits."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        e = 0.0
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name} {label}: disagrees with its plain version")
            if g.dtype != torch.uint8:
                e = max(e, float((g.double() - w.double()).abs().max()))
        log(f"check {name} {label}: bit-identical=True max_abs_err={e}")
        err[name] = max(err.get(name, 0.0), e)

    def hold_stages(x, r, label):
        """The global-stage kernel against ``global_stage_plain(...,
        stages=s)`` for every s up to S_max: the top group of the top level
        (j = row_len/2) and the bottom group of a lower level (j_low = T)."""
        row_len = x.shape[1]
        name = "bitonic_global_stage_kernel" + (RANK if r is not None else "")
        for st in range(1, tb.STAGES_MAX[(x.dtype, r is not None)] + 1):
            j_bot = T << (st - 1)
            for k, j in ((row_len, row_len // 2), (max(row_len // 2, 2 * j_bot), j_bot)):
                def run(fn):
                    t, q = x.clone(), (None if r is None else r.clone())
                    fn(t, k, j, q, stages=st)
                    return (t,) if q is None else (t, q)
                hold(name, f"{label} S={st} k={k} j={j}..{j >> (st - 1)}",
                     lambda: run(tb.bitonic_global_stage), lambda: run(tb.global_stage_plain))

    shapes = {np.int32: (P, n32 // P), np.int64: (P, n64 // P)}
    for dtype, (rows, row_len) in shapes.items():
        x = torch.from_numpy(random_keys(rng, (rows, row_len), dtype)).to(dev)
        checks = [
            ("bitonic_tile_kernel", "k_start=2", lambda t: tb.bitonic_tile(t, T),
             lambda t: tb.tile_sort_plain(t, T)),
            ("bitonic_tile_kernel", "k_start=512", lambda t: tb.bitonic_tile(t, T, 512),
             lambda t: tb.tile_sort_plain(t, T, 512)),
            ("bitonic_tile_merge_kernel", "k=row_len",
             lambda t: tb.bitonic_tile_merge(t, T, row_len),
             lambda t: tb.tile_merge_plain(t, T, row_len)),
            ("bitonic_tile_merge_kernel", "k=2T (tiles of both directions)",
             lambda t: tb.bitonic_tile_merge(t, T, 2 * T),
             lambda t: tb.tile_merge_plain(t, T, 2 * T)),
        ]
        for name, what, kernel, plain in checks:
            hold(name, f"{np.dtype(dtype).name} {rows}x{row_len} {what}",
                 lambda: (kernel(x.clone()),), lambda: (plain(x.clone()),))
        hold_stages(x, None, f"{np.dtype(dtype).name} {rows}x{row_len}")
        del x

    # The rank plane at the records merge shape: 8 rows of 8 slots x 2^18
    # (the fused merge of 2^23 records), int64 and int32 keys, with ties.
    kv_rows, kv_len = P, 1 << 21
    for dtype in (np.int64, np.int32):
        x = torch.from_numpy(random_keys(rng, (kv_rows, kv_len), dtype) % 4096).to(dev)
        r = torch.randperm(kv_rows * kv_len, device=dev, dtype=torch.int32).view(kv_rows, kv_len)
        label = f"{np.dtype(dtype).name} {kv_rows}x{kv_len} + int32 rank"
        hold_stages(x, r, f"{label}, keys % 4096")
        hold_stages(x % 7, r, f"{label}, keys % 7")
        rank_checks = [
            ("bitonic_tile_kernel", "k_start=2", lambda t, q: tb.bitonic_tile(t, T, 2, q),
             lambda t, q: tb.tile_sort_plain(t, T, 2, q)),
            ("bitonic_tile_merge_kernel", "k=row_len",
             lambda t, q: tb.bitonic_tile_merge(t, T, kv_len, q),
             lambda t, q: tb.tile_merge_plain(t, T, kv_len, q)),
            ("bitonic_tile_merge_kernel", "k=2T (tiles of both directions)",
             lambda t, q: tb.bitonic_tile_merge(t, T, 2 * T, q),
             lambda t, q: tb.tile_merge_plain(t, T, 2 * T, q)),
        ]
        for name, what, kernel, plain in rank_checks:
            def run(fn):
                t, q = x.clone(), r.clone()
                fn(t, q)
                return t, q
            hold(name + RANK, f"{label} {what}", lambda: run(kernel), lambda: run(plain))
        del x, r

    # The tile kernel and the tile merge at every shape the wrapper admits:
    # each tile from 2 keys (one thread) to the shared-memory limit, both key
    # types, keys alone and with the rank plane, on small batches; the tile
    # kernel at k_start in {2, 4, T/2, T}, the merge at k in {2T, 4T, 8T}
    # on rows of 8T, so rows hold tiles of both directions.  Own generator,
    # so the data of the phases below stay as they were.
    wrng = np.random.default_rng(5)

    def sweep(name, kernel, plain, params, row_len, what):
        """``kernel(x, tile, p, ranks)`` bit-identical to ``plain`` for every
        admitted tile, each ``p`` in ``params(tile)``, on 3 rows of
        ``row_len(tile)`` keys."""
        for dtype in (np.int32, np.int64):
            for ranked in (False, True):
                cases, tile = 0, 2
                while tile <= tile_limit(dtype, ranked):
                    for p in params(tile):
                        for label, keys, ranks in tile_inputs(wrng, (3, row_len(tile)), dtype,
                                                              ranked):
                            x = torch.from_numpy(keys).to(dev)
                            q = torch.from_numpy(ranks).to(dev) if ranked else None
                            px, pq = x.clone(), (q.clone() if ranked else None)
                            kernel(x, tile, p, q)
                            plain(px, tile, p, pq)
                            torch.cuda.synchronize()
                            if not (torch.equal(x, px) and (not ranked or torch.equal(q, pq))):
                                raise AssertionError(
                                    f"{name} {np.dtype(dtype).name} ranked={ranked} T={tile} "
                                    f"at {p} ({what}) {label}: disagrees with its plain "
                                    "version")
                            cases += 1
                    tile *= 2
                log(f"check {name}{RANK if ranked else ''} sweep {np.dtype(dtype).name}: "
                    f"{cases} cases, T=2..{tile // 2}, {what}, random / ties / extreme keys: "
                    "bit-identical=True")

    sweep("bitonic_tile_kernel", tb.bitonic_tile, tb.tile_sort_plain,
          lambda t: sorted({k for k in (2, 4, t // 2, t) if 2 <= k <= t}), lambda t: 2 * t,
          "k_start in {2, 4, T/2, T}")
    sweep("bitonic_tile_merge_kernel", tb.bitonic_tile_merge, tb.tile_merge_plain,
          lambda t: (2 * t, 4 * t, 8 * t), lambda t: 8 * t, "k in {2T, 4T, 8T = row_len}")
    # S1 at every tile_rows the wrapper admits (T = 128 keys up to 8 CTAs a
    # tile), a few tiles a call, on the tile sweep's keys: random, % 7 ties
    # and extreme keys (its rank planes unused).
    for dtype, top in ((np.int32, 2048), (np.int64, 1024)):
        cases, took, tile_rows = 0, {}, 1
        while tile_rows <= top:
            tile = tile_rows * ps.LANES
            inputs = tile_inputs(wrng, (3 if tile_rows <= 256 else 2, tile), dtype, True)
            for label, keys, _ in inputs[:2] + inputs[3:]:  # [2] repeats [1]'s keys
                x = torch.from_numpy(keys).to(dev)
                px = x.clone()
                ps.tile_sort(x, tile_rows)
                ps.tile_sort_plain(px, tile_rows)
                torch.cuda.synchronize()
                if not torch.equal(x, px):
                    raise AssertionError(f"tile_sort_kernel {np.dtype(dtype).name} tile_rows="
                                         f"{tile_rows} {label}: disagrees with its plain version")
                cases += 1
            took[tile_rows] = ps.tile_sort_cluster_size(tile_rows, x.dtype)
            tile_rows *= 2
        log(f"check tile_sort_kernel sweep {np.dtype(dtype).name}: {cases} cases, tile_rows="
            f"1..{top}, CTAs a tile by tile_rows {took}, random / ties / extreme keys: "
            "bit-identical=True")

    mesh = VirtualMesh(P)
    x32 = random_keys(rng, n32, np.int32)
    shards, cnt = pad_to_shards(x32, P)
    xs_plan, split, hist = ex._ring_plan_shard(
        to_signed_keys(torch.from_numpy(shards).to(dev)), torch.from_numpy(cnt).to(dev),
        mesh=mesh, oversample=32, kernel="auto",
    )
    hist32 = hist.cpu().numpy()
    caps32 = ex.ring_caps(hist32, shards.shape[1], P)
    starts32, lens32 = ex._bucket_bounds(xs_plan, torch.from_numpy(cnt).to(dev), split)
    hold("ring_exchange_kernel", f"keys, plan of 2^26 int32 (caps {caps32})",
         lambda: rk.ring_exchange(xs_plan, starts32, lens32, caps32)[:1],
         lambda: rk.ring_exchange_plain(xs_plan, starts32, lens32, caps32)[:1])

    # R1's edges (its own generator): P of 2, 3, 5 and 8, both key types,
    # slots of 1-2 keys (the scalar form), 4, 8, 128 and several warp
    # chunks; bucket starts at every offset modulo 4, lengths 0, 1, 3,
    # cap - 1, cap and above cap; sentinel-valued keys inside buckets;
    # shards held one key off a 16-byte boundary.
    erng, cases = np.random.default_rng(12), 0
    for p_edge in (2, 3, 5, 8):
        for dtype in (np.int32, np.int64):
            for cap_base, n_local in ((1, 24), (3, 24), (6, 40), (100, 400), (3000, 10000)):
                for sentinel_run in (False, True):
                    exs, est, eln, ecaps = edge_exchange_inputs(erng, p_edge, n_local, dtype,
                                                                cap_base, sentinel_run)
                    args = [torch.from_numpy(a).to(dev) for a in (exs, est, eln)]
                    for shifted in (False, True):
                        if shifted:  # the same keys one key past a 16-byte boundary
                            flat = torch.cat([args[0].new_zeros(1), args[0].reshape(-1)])
                            args[0] = flat[1:].view(p_edge, n_local)
                        got = rk.ring_exchange(*args, ecaps)[0]
                        if not torch.equal(got, rk.ring_exchange_plain(*args, ecaps)[0]):
                            raise AssertionError(
                                f"ring_exchange_kernel P={p_edge} {np.dtype(dtype).name} caps "
                                f"{ecaps} sentinel_run={sentinel_run} shifted={shifted}: "
                                "disagrees with its plain version")
                        cases += 1
    torch.cuda.synchronize()
    log(f"check ring_exchange_kernel edges: {cases} cases, P=2/3/5/8, int32/int64, slots "
        "1..4096, starts at every offset mod 4, lengths 0/1/3/cap-1/cap/cap+5, sentinel keys "
        "in buckets, shards off a 16-byte boundary: bit-identical=True")

    tk, tv = ingest.gen_terasort(nrec, seed=1)
    sk, sv, kcnt = pad_kv_to_shards(tk, tv, P)
    kcnt_d = torch.from_numpy(kcnt).to(dev)
    ks_plan, vs_plan, ksplit, khist = ex._ring_plan_kv_shard(
        to_signed_keys(torch.from_numpy(sk).to(dev)), torch.from_numpy(sv).to(dev), kcnt_d,
        mesh=mesh, oversample=32,
    )
    caps_kv = ex.ring_caps(khist.cpu().numpy(), sk.shape[1], P)
    kstarts, klens = ex._bucket_bounds(ks_plan, kcnt_d, ksplit)
    hold("ring_exchange_kernel+kv", f"kv, plan of 2^23 records (caps {caps_kv})",
         lambda: rk.ring_exchange(ks_plan, kstarts, klens, caps_kv, vs_plan),
         lambda: rk.ring_exchange_plain(ks_plan, kstarts, klens, caps_kv, vs_plan))
    wk, wt, wv = rk.ring_exchange(ks_plan, kstarts, klens, caps_kv, vs_plan)
    tb.merge_alternating_runs(wk, rk._slot_len(caps_kv), wt)
    total_kv = sum(caps_kv)
    tags = wt[:, :total_kv]
    hold("gather_rows_kernel", f"{tuple(wv.shape)} uint8 rows by merged tags",
         lambda: (rk.gather_rows(wv, tags),), lambda: (rk.gather_rows_plain(wv, tags),))
    del wk
    # The gather over row widths of every word path (1 and 13 bytes: bytes;
    # 92 and 100: 4-byte words; 16 and 256: 16-byte words), totals that are
    # and are not multiples of 32, tags a slice of wider rows, tags below 0
    # and at or above total.  Own generator.
    grng, cases = np.random.default_rng(11), 0
    for row_b in (1, 13, 16, 92, 100, 256):
        for gp, gtotal, extra in ((3, 1000, 0), (8, 4099, 61), (2, 31, 5), (5, 65536 + 17, 0)):
            gws = torch.from_numpy(grng.integers(0, 256, (gp, gtotal, row_b), dtype=np.uint8))
            gws = gws.to(dev)
            gtags = torch.from_numpy(grng.integers(-5, 2 * gtotal, (gp, gtotal + extra))
                                     .astype(np.int32)).to(dev)[:, :gtotal]
            if not torch.equal(rk.gather_rows(gws, gtags), rk.gather_rows_plain(gws, gtags)):
                raise AssertionError(f"gather_rows_kernel {gp}x{gtotal}x{row_b} tag stride "
                                     f"{gtags.stride(0)}: disagrees with its plain version")
            cases += 1
    torch.cuda.synchronize()
    log(f"check gather_rows_kernel sweep: {cases} cases, rows of 1/13/16/92/100/256 bytes, "
        "totals 31..65553 (not all multiples of 32), tag strides above total, tags out of "
        "range: bit-identical=True")

    # S1 / S2 at the default tile (256 x 128 keys), on clusters of 8 CTAs.
    # Own generator, so the data of the phases above and below stay as they
    # were.
    srng = np.random.default_rng(3)
    TR = 256
    for dtype, (rows, row_len) in shapes.items():
        x = torch.from_numpy(random_keys(srng, (rows, row_len), dtype)).to(dev)
        hold("tile_sort_kernel", f"{np.dtype(dtype).name} {rows}x{row_len} tile_rows={TR} "
             f"({ps.tile_sort_cluster_size(TR, x.dtype)} CTAs a tile)",
             lambda: (ps.tile_sort(x.clone(), TR),), lambda: (ps.tile_sort_plain(x.clone(), TR),))
        del x
    for dtype in (np.int32, np.int64):  # the padded shape of 2^23 records, many ties
        k = torch.from_numpy(random_keys(srng, nrec, dtype) % 4096).to(dev)
        v = torch.randperm(nrec, device=dev, dtype=torch.int32)
        hold("tile_sort_kv_kernel", f"{np.dtype(dtype).name}+int32 index n=2^23 tile_rows={TR} "
             f"({ps.tile_sort_cluster_size(TR, k.dtype, kv=True)} CTAs a tile)",
             lambda: ps.tile_sort_kv(k.clone(), v.clone(), TR),
             lambda: ps.tile_sort_kv_plain(k.clone(), v.clone(), TR))
        del k, v
    # S2 at every tile_rows the wrapper admits (T = 128 up to 131,072 pairs,
    # 1 to 8 CTAs a tile): random, % 7 and extreme keys, each with the index
    # as an arange, a permutation and in {0, 1, 2} (repeated pairs).
    for dtype in (np.int32, np.int64):
        cases, took, tile_rows = 0, {}, 1
        while tile_rows <= 1024:
            tile = tile_rows * ps.LANES
            shape = (3 if tile_rows <= 256 else 2, tile)
            inputs = tile_inputs(wrng, shape, dtype, True)
            n_s2 = shape[0] * tile
            indices = {"arange": np.arange(n_s2, dtype=np.int32).reshape(shape),
                       "permutation": wrng.permutation(n_s2).astype(np.int32).reshape(shape),
                       "in {0, 1, 2}": wrng.integers(0, 3, shape).astype(np.int32)}
            for label, keys, _ in inputs[:2] + inputs[3:]:  # [2] repeats [1]'s keys
                for iname, index in indices.items():
                    k = torch.from_numpy(keys).to(dev)
                    v = torch.from_numpy(index).to(dev)
                    pk, pv = ps.tile_sort_kv_plain(k.clone(), v.clone(), tile_rows)
                    ps.tile_sort_kv(k, v, tile_rows)
                    torch.cuda.synchronize()
                    if not (torch.equal(k, pk) and torch.equal(v, pv)):
                        raise AssertionError(
                            f"tile_sort_kv_kernel {np.dtype(dtype).name} tile_rows={tile_rows} "
                            f"{label}, index {iname}: disagrees with its plain version")
                    cases += 1
            took[tile_rows] = ps.tile_sort_cluster_size(tile_rows, k.dtype, kv=True)
            tile_rows *= 2
        log(f"check tile_sort_kv_kernel sweep {np.dtype(dtype).name}+int32 index: {cases} cases, "
            f"tile_rows=1..1024, CTAs a tile by tile_rows {took}, random / % 7 / extreme keys x "
            "arange / permuted / repeated indices: bit-identical=True")
    # S3: each digit histogram equal to its plain version, to torch.bincount
    # of the digits, and summing to n.
    hist_in = {np.int32: torch.from_numpy(random_keys(srng, n32, np.int32)).to(dev),
               np.int64: torch.from_numpy(random_keys(srng, n64, np.int64)).to(dev)}
    for dtype, xh in hist_in.items():
        for shift, bits in ((0, 8), (8, 8), (24, 8), (0, 4), (56, 8)):
            if shift >= 32 and dtype == np.int32:
                continue
            hold("radix_histogram_kernel", f"{np.dtype(dtype).name} n={xh.numel()} shift={shift} "
                 f"bits={bits}", lambda: (ps.radix_histogram(xh, shift, bits),),
                 lambda: (ps.radix_histogram_plain(xh, shift, bits),))
            h = ps.radix_histogram(xh, shift, bits)
            ref = torch.bincount(((xh >> shift) & ((1 << bits) - 1)).long(), minlength=1 << bits)
            if not (torch.equal(h.long(), ref) and int(h.sum()) == xh.numel()):
                raise AssertionError(f"radix_histogram {shift},{bits}: not torch.bincount's")
    # S3's edges (its own generator): bases 0-3 keys past a 16-byte boundary,
    # lengths 0, 1, 15 and 2^20 + 7 (a scalar head and tail), 1, 2^13
    # (shared memory) and 2^14 buckets (global atomics), shifts at and past
    # the key's width.
    hrng, cases = np.random.default_rng(13), 0
    for dtype in (np.int32, np.int64, np.uint32, np.uint64):
        width = 8 * np.dtype(dtype).itemsize
        wide = torch.from_numpy(random_keys(hrng, (1 << 20) + 10, dtype)).to(dev)
        for n_h in (0, 1, 15, (1 << 20) + 7):
            for off in range(4):
                xv = wide[off:off + n_h]
                for shift, bits in ((0, 0), (0, 8), (5, 13), (5, 14), (width, 4), (width + 9, 8)):
                    if not torch.equal(ps.radix_histogram(xv, shift, bits),
                                       ps.radix_histogram_plain(xv, shift, bits)):
                        raise AssertionError(
                            f"radix_histogram_kernel {np.dtype(dtype).name} n={n_h} offset "
                            f"{off} shift={shift} bits={bits}: disagrees with its plain version")
                    cases += 1
    torch.cuda.synchronize()
    log(f"check radix_histogram_kernel edges: {cases} cases, int32/int64/uint32/uint64, bases "
        "0-3 keys past 16 bytes, n=0/1/15/2^20+7, bits 0/8/13/14, shift at and past the width: "
        "bit-identical=True")
    reset()
    ps.radix_histogram(hist_in[np.int32], 0, 8)
    hist_launches = counts()["radix_histogram_kernel"]
    if hist_launches != 1:
        raise AssertionError(f"radix_histogram: {hist_launches} launches, expected 1")

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

    # 4. the main paths ---------------------------------------------------------
    ss = SampleSort(mesh)
    ring_kernels = {"ring_exchange_kernel"}
    kv_fused = {"ring_exchange_kernel+kv", "gather_rows_kernel"}
    keys_path = set(tb.WRAPPERS)
    kv_merge = {"bitonic_global_stage_kernel" + RANK, "bitonic_tile_merge_kernel" + RANK}

    def launched(label, need, tally=None):
        """The run's launches; with a `StageTally`, also its global-stage
        passes beside the stages they ran, which must be the least the
        levels allow (ceil(g / S_max) each)."""
        got = counts()
        missing = sorted(k for k in need if not got[k])
        if missing:
            raise AssertionError(f"{label}: kernels of the path not launched: {missing} {got}")
        for ranked in (False, True) if tally is not None else ():
            stages, passes, least = tally.summary(ranked)
            name = "bitonic_global_stage_kernel" + (RANK if ranked else "")
            if passes != got[name] or passes != least:
                raise AssertionError(f"{label}: {got[name]} {name} launches for {stages} "
                                     f"stages, {passes} calls, least {least}")
            if passes:
                log(f"  {name}: {stages} stages in {passes} passes")
        return {k: v for k, v in got.items() if v}

    def drive(label, data, reference, metrics=None, exchange=None, sorter=None, need=None):
        """One main-path sort; returns its launches and per-shard counts."""
        sorter = sorter or ss
        if need is None:
            need = keys_path | (ring_kernels if exchange == "fused" else set())
        tally = StageTally(tb)
        reset()
        t0 = time.perf_counter()
        try:
            out = sorter.sort(data, metrics, exchange=exchange)
        finally:
            tally.close()
        wall = time.perf_counter() - t0
        got = launched(label, need, tally)
        if not same_bits(out, reference):
            raise AssertionError(f"{label}: output differs from numpy")
        log(f"main {label}: equal to numpy, {wall * 1e3:.1f} ms wall, launches {got}")
        keys = data
        if data.dtype.kind == "f":  # sort_ranges takes the mapped keys
            keys = float_to_ordered_int(torch.from_numpy(data)).numpy()
        shard_counts = [len(r) for r in sorter.sort_ranges(keys, exchange=exchange)]
        log(f"  per-shard counts {shard_counts}")
        return got, shard_counts

    ref32 = np.sort(x32)
    main_launches, counts32 = drive("uniform int32 n=2^26", x32, ref32)

    z = np.minimum(rng.zipf(1.3, n64), np.iinfo(np.int64).max).astype(np.int64)
    refz = np.sort(z)
    m = Metrics()
    _, countsz = drive("zipf(1.3) int64 n=2^24", z, refz, m)
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
    # 10^6 < 2^20 keys: the fused route (one padded row of 2^20 through the
    # block kernels, no exchange), as dsort run routes it.
    want_bytes = "".join(f"{v}\n" for v in np.sort(xt).tolist()).encode()
    jpath = work / "journal.jsonl"
    reset()
    t0 = time.perf_counter()
    if cli.main(["run", str(src), "-o", str(dst), "--journal", str(jpath)]) != 0:
        raise AssertionError("cli run failed")
    wall = time.perf_counter() - t0
    got = launched("cli run", keys_path)
    if dst.read_bytes() != want_bytes:
        raise AssertionError("cli output differs from the numpy-formatted sorted file")
    recs = EventLog.read_jsonl(str(jpath))
    if (recs[0]["mode"] != "fused" or recs[-2]["counters"].get("fused_small_jobs") != 1
            or got.get("ring_exchange_kernel")):
        raise AssertionError(f"cli run 10^6 lines did not take the fused route: {recs[0]} {got}")
    cli_wall_ms = wall * 1e3
    log(f"main cli run 10^6 lines: byte-identical, {wall * 1e3:.1f} ms wall, fused route "
        f"(fused_small_jobs 1), launches {got}")
    reset()
    t0 = time.perf_counter()
    if cli.main(["run", str(src), "-o", str(dst), "--kernel", "pallas"]) != 0:
        raise AssertionError("cli run --kernel pallas failed")
    wall = time.perf_counter() - t0
    got = launched("cli run --kernel pallas", {"tile_sort_kernel"})
    if dst.read_bytes() != want_bytes:
        raise AssertionError("cli run --kernel pallas output differs from sort -n order")
    log(f"main cli run --kernel pallas 10^6 lines: byte-identical, {wall * 1e3:.1f} ms wall, "
        f"launches {got}")

    # Keys through the ring: no retry, one exchange launch per fused sort.
    ring_launches = {}
    for label, data, ref in (("uniform int32 n=2^26", x32, ref32),
                             ("zipf(1.3) int64 n=2^24", z, refz)):
        for exchange in ("ring", "fused"):
            m = Metrics(journal=Journal())
            got, _ = drive(f"{label} exchange={exchange}", data, ref, m, exchange)
            if m.counters.get("capacity_retries", 0):
                raise AssertionError(f"{label} {exchange}: capacity retry on the ring")
            if exchange == "fused" and (
                m.counters["fused_exchange_launches"] != 1 or got["ring_exchange_kernel"] != 1
            ):
                raise AssertionError(f"{label}: not one exchange launch per fused sort")
            caps = [e["cap"] for e in m.journal.of("exchange_step")]
            skew = m.journal.of("skew_report")[0]
            log(f"  plan caps (steps 1..7) {caps}, skew max_mean_ratio "
                f"{skew['max_mean_ratio']}, counters {dict(m.counters)}")
            if exchange == "fused" and label.startswith("uniform"):
                ring_launches = got

    # local_kernel="pallas": phase 1 sorts through the tile kernel and, the
    # combine resolving to the flat re-sort, so does phase 5 — two tile
    # launches per alltoall attempt; the default path's bits and counts.
    ss_pallas = SampleSort(mesh, JobConfig(local_kernel="pallas"))
    pallas_launches = {}
    for label, data, ref, want_counts, exchange in (
        ("uniform int32 n=2^26", x32, ref32, counts32, "alltoall"),
        ("uniform int32 n=2^26", x32, ref32, counts32, "ring"),
        ("zipf(1.3) int64 n=2^24", z, refz, countsz, "alltoall"),
    ):
        m = Metrics()
        got, shard_counts = drive(f"{label} local_kernel=pallas exchange={exchange}", data, ref,
                                  m, exchange, ss_pallas, {"tile_sort_kernel"})
        if shard_counts != want_counts:
            raise AssertionError(f"{label} pallas {exchange}: per-shard counts differ from auto's")
        attempts = m.counters.get("capacity_retries", 0) + 1
        if got["tile_sort_kernel"] != 2 * attempts:
            raise AssertionError(f"{label} pallas {exchange}: {got['tile_sort_kernel']} tile "
                                 f"launches over {attempts} attempt(s), expected 2 each")
        if label.startswith("zipf") and attempts < 2:
            raise AssertionError("zipf int64 under pallas did not take the capacity retry")
        log(f"  equal to the default path's bits and per-shard counts; {attempts} attempt(s)")
        if exchange == "alltoall" and label.startswith("uniform"):
            pallas_launches = got
    # merge_kernel="bitonic": the received runs merged by the bitonic tree.
    x24 = x32[: 1 << 24]
    ref24 = np.sort(x24)
    ss_mb = SampleSort(mesh, JobConfig(local_kernel="lax", merge_kernel="bitonic"))
    for exchange in ("alltoall", "ring"):
        drive(f"int32 n=2^24 merge_kernel=bitonic exchange={exchange}", x24, ref24, None,
              exchange, ss_mb, set())

    # Records: 2^23 TeraSort records under every exchange.
    if len(np.unique(tk)) != nrec:
        raise AssertionError("the 8-byte prefixes of the 2^23 records are not unique")
    order = np.argsort(tk, kind="stable")
    ref_k, ref_v = tk[order], tv[order]
    outs = {}
    kv_launches = {}
    for exchange in ("alltoall", "ring", "fused"):
        need = kv_merge | (kv_fused if exchange == "fused" else set())
        tally = StageTally(tb)
        reset()
        m = Metrics()
        t0 = time.perf_counter()
        try:
            ok, ov = ss.sort_kv(tk, tv, m, exchange=exchange)
        finally:
            tally.close()
        wall = time.perf_counter() - t0
        got = launched(f"sort_kv {exchange}", need, tally)
        if not (np.array_equal(ok, ref_k) and np.array_equal(ov, ref_v)):
            raise AssertionError(f"sort_kv {exchange}: records differ from numpy's order")
        outs[exchange] = ov
        log(f"main sort_kv 2^23 TeraSort records exchange={exchange}: keys equal np.sort, "
            f"payloads equal the stable argsort order, {wall * 1e3:.1f} ms wall, "
            f"counters {dict(m.counters)}, launches {got}")
        if exchange == "fused":
            kv_launches = got
    if not np.array_equal(outs["ring"], outs["fused"]):
        raise AssertionError("ring and fused payloads differ")
    del outs

    # 2^22 zipf records (repeated keys) under fused: the record multiset of
    # every key, through an index stamped into the first 8 payload bytes.
    nz = 1 << 22
    zk = rng.zipf(1.3, nz).astype(np.uint64)
    zv = rng.integers(0, 256, (nz, 92), dtype=np.uint8)
    zv[:, :8] = np.arange(nz, dtype=np.uint64).view(np.uint8).reshape(nz, 8)
    reset()
    ok, ov = ss.sort_kv(zk, zv, exchange="fused")
    launched("sort_kv zipf fused", kv_merge | kv_fused)
    idx = np.ascontiguousarray(ov[:, :8]).view(np.uint64).reshape(-1)
    if not (np.array_equal(np.sort(idx), np.arange(nz, dtype=np.uint64))
            and np.array_equal(zk[idx], ok) and np.array_equal(zv[idx], ov)
            and np.array_equal(ok, np.sort(zk))):
        raise AssertionError("zipf records: a record moved away from its key")
    log(f"main sort_kv 2^22 zipf(1.3) uint64 records exchange=fused: keys equal np.sort, "
        f"every record kept with its key ({len(np.unique(zk))} distinct keys)")

    # The bitonic kv merge tree: 2^23 TeraSort records (unique keys) give
    # exactly the default path's records.
    reset()
    t0 = time.perf_counter()
    ok, ov = SampleSort(mesh, JobConfig(merge_kernel="bitonic")).sort_kv(
        tk, tv, exchange="alltoall")
    wall = time.perf_counter() - t0
    if not (np.array_equal(ok, ref_k) and np.array_equal(ov, ref_v)):
        raise AssertionError("sort_kv merge_kernel=bitonic: records differ")
    log(f"main sort_kv 2^23 TeraSort records merge_kernel=bitonic exchange=alltoall: "
        f"the default path's records, {wall * 1e3:.1f} ms wall")

    # pallas_sort_kv: stable, so payloads follow the stable argsort exactly,
    # repeated keys included.
    kv_tile_launches = {}
    for label, keys, rows in (("2^23 TeraSort records", tk, tv), ("2^22 zipf(1.3) uint64", zk, zv)):
        kd, rd = torch.from_numpy(keys).to(dev), torch.from_numpy(rows).to(dev)
        reset()
        t0 = time.perf_counter()
        got_k, got_v = ps.pallas_sort_kv(kd, rd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launched(f"pallas_sort_kv {label}", {"tile_sort_kv_kernel"})
        kv_tile_launches = kv_tile_launches or got
        order = np.argsort(keys, kind="stable")
        if not (np.array_equal(got_k.cpu().numpy(), keys[order])
                and np.array_equal(got_v.cpu().numpy(), rows[order])):
            raise AssertionError(f"pallas_sort_kv {label}: not the stable order")
        log(f"main pallas_sort_kv {label}: keys equal np.sort, payloads equal the stable "
            f"argsort order, {wall * 1e3:.1f} ms wall, launches {got}")
        del kd, rd, got_k, got_v

    # The TeraSort job: cli terasort on 2^20 records.
    ck, cv = ingest.gen_terasort(1 << 20, seed=2)
    ck[::5] = ck[0]  # shared prefixes: the secondary key decides
    tsrc, tdst = work / "tera_in.bin", work / "tera_out.bin"
    ingest.write_terasort_file(tsrc, ck, cv)
    t0 = time.perf_counter()
    if cli.main(["terasort", str(tsrc), "-o", str(tdst)]) != 0:
        raise AssertionError("cli terasort failed")
    wall = time.perf_counter() - t0
    raw = np.fromfile(tsrc, np.uint8).reshape(-1, ingest.RECORD_BYTES)
    if tdst.read_bytes() != raw[np.lexsort((ingest.terasort_secondary(cv), ck))].tobytes():
        raise AssertionError("cli terasort output differs from numpy's 10-byte order")
    log(f"main cli terasort 2^20 records: byte-identical to np.lexsort order, "
        f"{wall * 1e3:.1f} ms wall")

    # 5. timings at the main path's shapes ------------------------------------
    rows, row_len = shapes[np.int32]
    n = rows * row_len
    x = torch.from_numpy(random_keys(rng, (rows, row_len), np.int32)).to(dev)
    log_t = T.bit_length() - 1
    stages_tile = log_t * (log_t + 1) // 2  # levels 2..T, log2(k) stages each
    kernels = []

    def entry(name, source, launches, kernel, plain, library, nbytes, ops, label):
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=3, warmup=1)
        ms_alone = cuda_ms_alone(kernel)
        library_ms = cuda_ms(library) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name.removesuffix(RANK)], "launches": launches,
            "max_abs_err": err[name], "ms": ms, "ms_alone": ms_alone, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        log(f"time {name} {label}: {ms:.4f} ms one call, {ms_alone:.4f} ms alone (50 back to "
            f"back), plain {plain_ms:.4f} ms, library {library_ms} ms, bound {b_ms:.4f} ms "
            f"({b_by}) [{card}]")

    entry("bitonic_tile_kernel", SOURCES["block"], main_launches["bitonic_tile_kernel"],
          lambda: tb.bitonic_tile(x, T), lambda: tb.tile_sort_plain(x, T),
          lambda: torch.sort(x.view(-1, T), dim=-1), 2 * n * 4, n * stages_tile,
          f"int32 {rows}x{row_len}")
    # One pass of S_max stages (the top group of the top level); its bound is
    # one pass over the keys whatever S is, plus n S / 2 compare-exchanges.
    s32 = tb.STAGES_MAX[(x.dtype, False)]
    entry("bitonic_global_stage_kernel", SOURCES["block"],
          main_launches["bitonic_global_stage_kernel"],
          lambda: tb.bitonic_global_stage(x, row_len, row_len // 2, stages=s32),
          lambda: tb.global_stage_plain(x, row_len, row_len // 2, stages=s32), None, 2 * n * 4,
          n * s32, f"int32 {rows}x{row_len} S={s32}, library null: a stage is two torch calls "
          "(minimum and maximum of strided views), S stages 2S")
    # At k = row_len every tile ascends and the merge sorts a bitonic tile:
    # torch.sort of the tile rows computes the same function.
    entry("bitonic_tile_merge_kernel", SOURCES["block"],
          main_launches["bitonic_tile_merge_kernel"],
          lambda: tb.bitonic_tile_merge(x, T, row_len),
          lambda: tb.tile_merge_plain(x, T, row_len),
          lambda: torch.sort(x.view(-1, T), dim=-1), 2 * n * 4, n * log_t,
          f"int32 {rows}x{row_len}, library torch.sort of the {T}-key tile rows")
    # The post-exchange merge levels run at 8 x 2^24 (P slots of cap_pair
    # keys a row, padded to a power of two): 3 of the 2^26 sort's launches.
    x24 = torch.from_numpy(random_keys(rng, (rows, 2 * row_len), np.int32)).to(dev)
    m24_ms = cuda_ms(lambda: tb.bitonic_tile_merge(x24, T, 2 * row_len))
    m24_lib = cuda_ms(lambda: torch.sort(x24.view(-1, T), dim=-1))
    m24_bound, m24_by = bound_ms(2 * x24.numel() * 4, x24.numel() * log_t)
    log(f"time bitonic_tile_merge_kernel int32 {rows}x{2 * row_len} (post-exchange merge): "
        f"{m24_ms:.4f} ms, library {m24_lib:.4f} ms, bound {m24_bound:.4f} ms ({m24_by}) "
        f"[{card}]")
    del x24
    # K1b: the tile kernel entered at k_start = 512 (runs of 256 merged up to
    # the tile), as block_merge_runs does for runs shorter than a tile.
    k1b_ms = cuda_ms(lambda: tb.bitonic_tile(x, T, 512))
    k1b_plain = cuda_ms(lambda: tb.tile_sort_plain(x, T, 512), reps=3, warmup=1)
    k1b_stages = sum(range(10, log_t + 1))  # levels 512..T
    k1b_bound, k1b_by = bound_ms(2 * n * 4, n * k1b_stages)
    log(f"time bitonic_tile_kernel k_start=512 (K1b) int32 {rows}x{row_len}: {k1b_ms:.4f} ms, "
        f"plain {k1b_plain:.4f} ms, bound {k1b_bound:.4f} ms ({k1b_by}) [{card}]")
    del x

    xk = torch.from_numpy(random_keys(rng, (kv_rows, kv_len), np.int64) % 4096).to(dev)
    rq = torch.randperm(kv_rows * kv_len, device=dev, dtype=torch.int32).view(kv_rows, kv_len)
    nk = kv_rows * kv_len
    ktile_ms = cuda_ms(lambda: tb.bitonic_tile(xk, T, 2, rq))
    ktile_plain = cuda_ms(lambda: tb.tile_sort_plain(xk, T, 2, rq), reps=3, warmup=1)
    ktile_bound, ktile_by = bound_ms(2 * nk * 12, nk * stages_tile)
    log(f"time bitonic_tile_kernel{RANK} int64+int32 {kv_rows}x{kv_len}: {ktile_ms:.4f} ms, "
        f"plain {ktile_plain:.4f} ms, bound {ktile_bound:.4f} ms ({ktile_by}) (not on the "
        f"records path at this size) [{card}]")
    s64r = tb.STAGES_MAX[(xk.dtype, True)]
    entry("bitonic_global_stage_kernel" + RANK, SOURCES["block"],
          kv_launches["bitonic_global_stage_kernel" + RANK],
          lambda: tb.bitonic_global_stage(xk, kv_len, kv_len // 2, rq, s64r),
          lambda: tb.global_stage_plain(xk, kv_len, kv_len // 2, rq, s64r), None, 2 * nk * 12,
          nk * s64r, f"int64+int32 rank {kv_rows}x{kv_len} S={s64r}, library null: torch has "
          "no lexicographic (key, rank) compare-exchange")
    # The global-stage pass at every S it takes, and the tile merge, per key
    # type and plane, at the main path's shapes (8 x 2^23 int32, 8 x 2^21
    # int64, the records' 8 x 2^21 with the rank plane): ms a pass and a
    # stage, and the bound.
    trng = np.random.default_rng(7)
    for dtype, ranked, (prow, plen) in (
        (np.int32, False, (rows, row_len)), (np.int64, False, shapes[np.int64]),
        (np.int32, True, (kv_rows, kv_len)), (np.int64, True, (kv_rows, kv_len)),
    ):
        xs_ = torch.from_numpy(random_keys(trng, (prow, plen), dtype)).to(dev)
        rs_ = (torch.randperm(prow * plen, device=dev, dtype=torch.int32).view(prow, plen)
               if ranked else None)
        nb = 2 * prow * plen * (xs_.element_size() + (4 if ranked else 0))
        b_ms, _ = bound_ms(nb)
        parts = []
        for st in range(1, tb.STAGES_MAX[(xs_.dtype, ranked)] + 1):
            ms = cuda_ms(lambda: tb.bitonic_global_stage(xs_, plen, plen // 2, rs_, st))
            parts.append(f"S={st} {ms:.4f} ms ({ms / st:.4f} a stage)")
        log(f"time bitonic_global_stage_kernel{RANK if ranked else ''} by S "
            f"{np.dtype(dtype).name} {prow}x{plen}: {', '.join(parts)}; bound {b_ms:.4f} ms "
            f"a pass [{card}]")
        tm_ms = cuda_ms(lambda: tb.bitonic_tile_merge(xs_, T, plen, rs_))
        log(f"time bitonic_tile_merge_kernel{RANK if ranked else ''} {np.dtype(dtype).name} "
            f"{prow}x{plen}: {tm_ms:.4f} ms; bound {b_ms:.4f} ms [{card}]")
        del xs_, rs_
    entry("bitonic_tile_merge_kernel" + RANK, SOURCES["block"],
          kv_launches["bitonic_tile_merge_kernel" + RANK],
          lambda: tb.bitonic_tile_merge(xk, T, kv_len, rq),
          lambda: tb.tile_merge_plain(xk, T, kv_len, rq), None, 2 * nk * 12, nk * log_t,
          f"int64+int32 rank {kv_rows}x{kv_len}")
    del xk, rq

    real32 = int(lens32.sum())
    entry("ring_exchange_kernel", SOURCES["ring"], ring_launches["ring_exchange_kernel"],
          lambda: rk.ring_exchange(xs_plan, starts32, lens32, caps32),
          lambda: rk.ring_exchange_plain(xs_plan, starts32, lens32, caps32), None,
          (real32 + P * sum(caps32)) * 4, 0, f"keys, plan of 2^26 int32 (no one torch call)")
    row_b = tv.shape[1]
    entry("ring_exchange_kernel+kv", SOURCES["ring"], kv_launches["ring_exchange_kernel+kv"],
          lambda: rk.ring_exchange(ks_plan, kstarts, klens, caps_kv, vs_plan),
          lambda: rk.ring_exchange_plain(ks_plan, kstarts, klens, caps_kv, vs_plan), None,
          nrec * (8 + row_b) + P * total_kv * (8 + 4 + row_b), 0,
          f"kv, plan of 2^23 records (no one torch call)")
    flat_rows = wv.view(-1, row_b)
    flat_idx = (torch.where(tags < total_kv, tags, 0).long()
                + torch.arange(P, device=dev).unsqueeze(1) * total_kv).view(-1)
    entry("gather_rows_kernel", SOURCES["ring"], kv_launches["gather_rows_kernel"],
          lambda: rk.gather_rows(wv, tags), lambda: rk.gather_rows_plain(wv, tags),
          lambda: flat_rows.index_select(0, flat_idx),
          2 * P * total_kv * row_b + P * total_kv * 4, 0,
          f"{tuple(wv.shape)} uint8, library torch.index_select")
    # A contiguous copy of the same rows: what the card's memory gives a
    # copy of these bytes without the gather's scattered reads.
    copy_out = torch.empty_like(wv)
    log(f"time copy_ of the gather's {wv.numel()} bytes (contiguous, no tags): "
        f"{cuda_ms(lambda: copy_out.copy_(wv)):.4f} ms [{card}]")
    del copy_out, wv, wt, tags, flat_rows, flat_idx, vs_plan, ks_plan

    # S1-S3 at their main-path shapes: the pallas sort's phase-1 tiles (8 x
    # 2^23 int32), the 2^23-record key+index tiles (uint64 keys as int64),
    # the 2^26 int32 digit histogram.
    tile = TR * ps.LANES
    log_s = tile.bit_length() - 1
    stages_s = log_s * (log_s + 1) // 2  # 120 at 32,768 keys
    xs1 = torch.from_numpy(random_keys(srng, (rows, row_len), np.int32)).to(dev)
    entry("tile_sort_kernel", SOURCES["tile"], pallas_launches["tile_sort_kernel"],
          lambda: ps.tile_sort(xs1, TR), lambda: ps.tile_sort_plain(xs1, TR),
          lambda: torch.sort(xs1.view(-1, tile), dim=-1), 2 * n * 4, n * stages_s,
          f"int32 {rows}x{row_len}, library torch.sort of the {tile}-key tile rows")
    del xs1
    ks2 = to_signed_keys(torch.from_numpy(tk).to(dev))
    vs2 = torch.arange(nrec, dtype=torch.int32, device=dev)
    entry("tile_sort_kv_kernel", SOURCES["tile"], kv_tile_launches["tile_sort_kv_kernel"],
          lambda: ps.tile_sort_kv(ks2, vs2, TR), lambda: ps.tile_sort_kv_plain(ks2, vs2, TR),
          lambda: torch.sort(ks2.view(-1, tile), dim=-1, stable=True), 2 * nrec * 12,
          nrec * stages_s, f"int64+int32 n=2^23, library stable torch.sort of the tile rows")
    xh = hist_in[np.int32]
    entry("radix_histogram_kernel", SOURCES["tile"], hist_launches,
          lambda: ps.radix_histogram(xh, 0, 8), lambda: ps.radix_histogram_plain(xh, 0, 8),
          lambda: torch.bincount((xh & 255).long(), minlength=256), n32 * 4 + 256 * 4,
          2 * n32, "int32 n=2^26 shift=0 bits=8, library torch.bincount of the digits")
    x64t = torch.from_numpy(random_keys(srng, shapes[np.int64], np.int64)).to(dev)
    c64_ms = cuda_ms(lambda: ps.tile_sort(x64t, TR))
    c64_lib = cuda_ms(lambda: torch.sort(x64t.view(-1, tile), dim=-1))
    c64_bound, c64_by = bound_ms(2 * n64 * 8, n64 * stages_s)
    log(f"time tile_sort_kernel int64 {shapes[np.int64]} "
        f"({ps.tile_sort_cluster_size(TR, x64t.dtype)} CTAs a tile): {c64_ms:.4f} ms, plain "
        f"{cuda_ms(lambda: ps.tile_sort_plain(x64t, TR), reps=3, warmup=1):.4f} ms, library "
        f"(torch.sort of the tile rows) {c64_lib:.4f} ms, bound {c64_bound:.4f} ms ({c64_by}) "
        f"[{card}]")
    # Phase 5's launch in the pallas sort of 2^26 int32: P rows of P * cap
    # received keys, padded with the sentinel to a power-of-two count of
    # whole tiles.
    x5 = ps._padded_tiles(torch.from_numpy(random_keys(srng, (P, P * cap), np.int32)).to(dev),
                          tile)
    n5 = x5.numel()
    p5_lib = cuda_ms(lambda: torch.sort(x5.view(-1, tile), dim=-1))
    p5_bound, p5_by = bound_ms(2 * n5 * 4, n5 * stages_s)
    log(f"time tile_sort_kernel int32 {tuple(x5.shape)} (phase 5 of the pallas sort of 2^26, "
        f"{P}x{P * cap} keys padded): {cuda_ms(lambda: ps.tile_sort(x5, TR)):.4f} ms, library "
        f"(torch.sort of the tile rows) {p5_lib:.4f} ms, bound {p5_bound:.4f} ms ({p5_by}) "
        f"[{card}]")
    del x5, x64t, hist_in, xh

    xf = torch.from_numpy(x32).to(dev)
    p_ms = cuda_ms(lambda: ps.pallas_sort(xf), reps=3, warmup=1)
    ts_ms = cuda_ms(lambda: torch.sort(xf), reps=5)
    log(f"time pallas_sort int32 n=2^26 (1-D: 2048 tiles, 11 merge levels): {p_ms:.3f} ms, "
        f"torch.sort {ts_ms:.3f} ms [{card}]")
    tkd, tvd = torch.from_numpy(tk).to(dev), torch.from_numpy(tv).to(dev)

    def stable_sort_kv():
        k, perm = torch.sort(to_signed_keys(tkd), stable=True)
        return k, tvd.index_select(0, perm)

    pk_ms = cuda_ms(lambda: ps.pallas_sort_kv(tkd, tvd), reps=3, warmup=1)
    sk_ms = cuda_ms(stable_sort_kv, reps=5)
    log(f"time pallas_sort_kv 2^23 TeraSort records: {pk_ms:.3f} ms, stable torch.sort + "
        f"index_select {sk_ms:.3f} ms [{card}]")
    by_name = profile(lambda: ps.pallas_sort_kv(tkd, tvd), "pallas_sort_kv 2^23 TeraSort records",
                      card)
    g_ms, g_n = traced(by_name, "tile_sort_kv_kernel")
    log(f"traced tile_sort_kv_kernel in pallas_sort_kv 2^23 TeraSort records: {g_ms:.3f} ms over "
        f"{g_n} launches [{card}]")
    del tkd, tvd, ks2, vs2
    bs_ms = cuda_ms(lambda: tb.block_sort(xf), reps=5)
    log(f"time block_sort int32 n=2^26: {bs_ms:.3f} ms ({n32 / bs_ms / 1e6:.3f} Gkeys/s), "
        f"torch.sort {ts_ms:.3f} ms ({n32 / ts_ms / 1e6:.3f} Gkeys/s) [{card}]")
    by_name = profile(lambda: tb.block_sort(xf), "block_sort int32 n=2^26", card)
    for kname in ("bitonic_global_stage_kernel", "bitonic_tile_merge_kernel"):
        g_ms, g_n = traced(by_name, kname)
        log(f"traced {kname} in block_sort int32 n=2^26: {g_ms:.3f} ms over {g_n} launches; "
            f"torch.sort of the same {ts_ms:.3f} ms [{card}]")
    del xf
    def by_exchange(label, run, unit, scale):
        """Host-to-host time of ``run(exchange)`` per exchange, in turns
        (A, B, C, C, B, A; two runs each), so drift hits all three alike."""
        parts = []
        for exchange in ("alltoall", "ring", "fused", "fused", "ring", "alltoall"):
            parts += [(exchange, t) for t in host_times(lambda: run(exchange), 2)]
        for exchange in ("alltoall", "ring", "fused"):
            ts = [t for e, t in parts if e == exchange]
            ms = float(np.median(ts))
            log(f"time {label} exchange={exchange} host-to-host: {ms:.3f} ms median of "
                f"{len(ts)} ({scale / ms:.3f} {unit}; runs {[round(t, 3) for t in ts]}) [{card}]")

    by_exchange("SampleSort(VirtualMesh(8)).sort int32 n=2^26",
                lambda e: ss.sort(x32, exchange=e), "Gkeys/s", n32 / 1e6)
    by_exchange("SampleSort(VirtualMesh(8)).sort zipf(1.3) int64 n=2^24",
                lambda e: ss.sort(z, exchange=e), "Gkeys/s", n64 / 1e6)
    log(f"  library_ms (torch.sort of 2^26 int32 on device) {ts_ms:.3f} ms [{card}]")
    by_exchange("SampleSort(VirtualMesh(8)).sort_kv 2^23 records",
                lambda e: ss.sort_kv(tk, tv, exchange=e), "Mrec/s", nrec / 1e3)
    # local_kernel="pallas" against "auto", alltoall, in turns (A B B A).
    turns = []
    for name, sorter in (("auto", ss), ("pallas", ss_pallas), ("pallas", ss_pallas), ("auto", ss)):
        turns += [(name, t) for t in host_times(lambda: sorter.sort(x32), 2)]
    for name in ("auto", "pallas"):
        ts = [t for k, t in turns if k == name]
        ms = float(np.median(ts))
        log(f"time SampleSort(VirtualMesh(8)).sort int32 n=2^26 local_kernel={name} alltoall "
            f"host-to-host: {ms:.3f} ms median of {len(ts)} ({n32 / ms / 1e6:.3f} Gkeys/s; "
            f"runs {[round(t, 3) for t in ts]}) [{card}]")

    m = Metrics()
    ss.sort(x32, m)
    log(f"phases SampleSort int32 n=2^26 alltoall: {json.dumps(m.summary())} [{card}]")
    for exchange in ("alltoall", "fused"):
        m = Metrics()
        ss.sort_kv(tk, tv, m, exchange=exchange)
        log(f"phases sort_kv 2^23 records {exchange}: {json.dumps(m.summary())} [{card}]")
    by_name = profile(lambda: ss.sort(x32), "SampleSort int32 n=2^26 alltoall", card)
    for kname in ("bitonic_global_stage_kernel", "bitonic_tile_merge_kernel"):
        g_ms, g_n = traced(by_name, kname)
        log(f"traced {kname} in SampleSort int32 n=2^26 alltoall: {g_ms:.3f} ms over {g_n} "
            f"launches [{card}]")
    profile(lambda: ss.sort(x32, exchange="fused"), "SampleSort int32 n=2^26 fused", card)
    by_name = profile(lambda: ss.sort_kv(tk, tv, exchange="fused"), "sort_kv 2^23 records fused",
                      card)
    for kname in ("bitonic_global_stage_kernel", "bitonic_tile_merge_kernel"):
        g_ms, g_n = traced(by_name, kname)
        log(f"traced {kname} (rank plane) in sort_kv 2^23 records fused: {g_ms:.3f} ms over "
            f"{g_n} launches [{card}]")
    g_ms, g_n = traced(by_name, "gather_rows_kernel")
    log(f"traced gather_rows_kernel in sort_kv 2^23 records fused: {g_ms:.3f} ms over {g_n} "
        f"launches [{card}]")
    by_name = profile(lambda: ss_pallas.sort(x32), "SampleSort int32 n=2^26 local_kernel=pallas",
                      card)
    g_ms, g_n = traced(by_name, "tile_sort_kernel")
    log(f"traced tile_sort_kernel in SampleSort int32 n=2^26 local_kernel=pallas alltoall: "
        f"{g_ms:.3f} ms over {g_n} launches (each: "
        f"{[round(ms, 3) for ms in traced_launches(by_name, 'tile_sort_kernel')]}) [{card}]")
    by_name = profile(lambda: cli.main(["run", str(src), "-o", str(dst), "--kernel", "pallas"]),
                      "cli run --kernel pallas 10^6 lines", card)
    g_ms, g_n = traced(by_name, "tile_sort_kernel")
    log(f"traced tile_sort_kernel in cli run --kernel pallas 10^6 lines: {g_ms:.3f} ms over "
        f"{g_n} launches [{card}]")

    # 6. the fault plane on the card ------------------------------------------
    fault_plane(card, ss, x32, ref32, z, refz, reset, counts, launched, keys_path)

    # 7. the small-job route, cli run --mode, the task pool ------------------
    small_jobs_and_taskpool(card, hold, reset, counts, launched, keys_path, src, want_bytes, work)

    # From here on every journal written is held to the trace contracts in
    # phase 13.5.
    global CENSUS
    CENSUS = JournalCensus()

    # 8. device-resident results and validation ------------------------------
    device_resident(card, ss, x32, ref32, z, refz, reset, launched, keys_path, src, want_bytes,
                    work, cli_wall_ms)

    # 9. hier, the coded plane, radix -----------------------------------------
    ring_gb = exchange_plane(card, ss, x32, ref32, counts32, z, refz, tk, tv, ref_k, ref_v,
                             hist32, reset, counts, launched, keys_path, kv_merge, src,
                             want_bytes, work)

    # 10. recovery and out-of-core ----------------------------------------------
    out_of_core(card, ss, x32, ref32, z, refz, tk, tv, ref_k, ref_v, reset, counts, launched,
                keys_path, src, want_bytes, work, ring_gb)

    # 11. the batch and multi-process planes -------------------------------------
    batch_and_multiprocess(card, ss, reset, counts, launched, keys_path, work)

    # 12. the serving plane -------------------------------------------------------
    serving(card, x32, ref32, z, refz, reset, counts, launched, keys_path, work)

    # 13. the introspection plane ---------------------------------------------------
    introspection(card, x32, ref32, tk, tv, ref_k, ref_v, reset, counts, launched, keys_path,
                  kv_merge, work)
    CENSUS.close()

    # 14. the native runtime ------------------------------------------------------
    native_runtime(card, x32, ref32, z, refz, tk, tv, ref_k, ref_v, reset, launched, src,
                   want_bytes, work)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    CHILDREN = {"--real-error-child": real_error_child,
                "--serve-real-error-child": serve_real_error_child}
    sys.exit(CHILDREN[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in CHILDREN else main())
