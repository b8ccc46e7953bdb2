"""``python -m dsort_tpu_torch.cli bench``: the counterpart of ``dsort bench``.

Every mode drives the port's own paths over a ``VirtualMesh`` of
``--workers`` virtual workers (default 8) on the card, or on the CPU with
``--device cpu``, and prints the reference's JSON lines: the same metric
names in the same order, the same keys, the same count and gate fields at
the same seed, and its own times.  Every time is host to host through the
public API and the minimum over ``--reps`` (the noise of a shared host is
one-sided).  The exit code follows the mode's gates.

- plain (no mode flag): ``--reps`` sorts of ``--n`` uniform keys through the
  ``--mode`` sorter (`cli._make_sorter`), one ``sort_throughput_*`` line;
- ``--suite``: the config ladder (`_bench_suite`);
- ``--device-resident``: ``sort(keep_on_device=True)`` and the on-device
  validator, one line each;
- ``--exchange-ab``: alltoall / ring / fused over uniform int32, zipf int64
  and TeraSort records (`_bench_exchange_ab`);
- ``--coded-ab``, ``--coded-v2-ab``: the coded plane's failure A/B and its
  parity / straggler acceptance (`_bench_coded_ab`, `_bench_coded_v2_ab`);
- ``--hier-ab``: flat ring against the two-level exchange at every host
  grouping the mesh divides into, and the device- and host-loss drills;
- ``--autotune-ab``: hand-set exchanges against the planner's pick;
- ``--serve-mixed``: `serve.SortService` under a three-tenant mix, packed
  slices against one slice;
- ``--analyze-smoke``: the introspection plane's price and the analyzer end
  to end;
- ``--external-wave``: the wave pipeline on a file 8 times its per-wave
  budget, overlap on against off, and a mid-wave loss;
- ``--fleet-mixed``: two `fleet.FleetAgent`s, each a `serve.SortService`
  over half the workers on the card, behind a `fleet.FleetController` over
  loopback TCP, under locality, random and health routing
  (`_bench_fleet_mixed`).

Each mode flag is a benchmark of its own: `cmd_bench` refuses two at once
with the reference's texts.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from dsort_tpu_torch.cli import _load_config, _make_sorter, _maybe_memwatch, _open_journal
from dsort_tpu_torch.config import JobConfig, SortConfig
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics

log = get_logger("cli")

#: The C reference's measured rate on its host CPU (BASELINE.md: its 16,384-key
#: maximum job in 0.374 s), the denominator of every ``vs_baseline``.
_REF_KEYS_PER_SEC = 16_384 / 0.374

#: The mode flags in the reference's precedence: a mode refuses every flag
#: before it in this list, and of several modes given the last one decides.
_MODES = ("suite", "device_resident", "exchange_ab", "serve_mixed", "analyze_smoke",
          "external_wave", "fleet_mixed", "coded_ab", "autotune_ab", "hier_ab", "coded_v2_ab")


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _workers(cfg: SortConfig) -> int:
    return cfg.mesh.num_workers or 8


def _mesh(args, cfg: SortConfig):
    from dsort_tpu_torch.parallel.mesh import VirtualMesh

    return VirtualMesh(_workers(cfg), getattr(args, "device", None))


def _sync(device: torch.device) -> None:
    """Close a timed window on the card: kernel launches return before the
    work ends.  On the CPU the work is done when the call returns."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write_journal(journal, args) -> None:
    if journal is not None:
        journal.flush_jsonl(args.journal)
        log.info("event journal written to %s (%d events)", args.journal, len(journal))


class _Reps:
    """The counters of one arm summed over its reps.  Each timed sort gets a
    `Metrics` of its own (`metrics`), so each is one job, with its own
    ``job`` ordinal, in the journal, and its trace holds to the trace
    contracts; one `Metrics` across reps would merge them into one trace."""

    def __init__(self, journal):
        self.journal, self._runs = journal, []

    def metrics(self) -> Metrics:
        m = Metrics(journal=self.journal)
        self._runs.append(m)
        return m

    @property
    def counters(self) -> Counter:
        total = Counter()
        for m in self._runs:
            total.update(m.counters)
        return total


def _needs(p: int, least: int, flag: str, why: str) -> None:
    if p < least:
        raise SystemExit(f"{flag} needs {why}; run with --workers {least} or more")


def _bench_suite(args) -> int:
    """The BASELINE config ladder, one JSON line per config.

    1. the reference's own workload (its 16,384-key maximum, ``server.c:13``)
    2. 1M uniform int32, SPMD sample sort over the mesh
    3. 1M uniform int64
    4. TeraSort records (full 10-byte key + 90 B payload), kv shuffle
    5. 1M Zipf-skewed keys WITH one injected worker failure

    ``args.emit`` (optional) receives each line instead of stdout, so a
    harness can collect the ladder; ``args.workers`` / ``args.device`` may be
    absent there (8 workers on the card).
    """
    from dsort_tpu_torch.data.ingest import gen_terasort, gen_uniform, gen_zipf, terasort_secondary
    from dsort_tpu_torch.models.pipelines import _fused_small_fn, fused_sort_small, pad_rung
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler

    reps = args.reps
    if reps < 1:  # a harness may call this directly, not through cmd_bench
        raise SystemExit("--reps must be >= 1")
    workers = getattr(args, "workers", None) or 8
    mesh = VirtualMesh(workers, getattr(args, "device", None))
    dev = mesh.device
    emit = getattr(args, "emit", None) or _emit

    def timed(label, n, unit, fn, **extra):
        fn()  # warm: the kernels' first calls
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        dt = float(min(times))
        line = {
            "metric": label,
            "value": round(n / dt, 1),
            "unit": unit,
            # Host-to-host time of the public API: the upload, the kernels
            # and the copy back all count.
            "includes_host_roundtrip": True,
        }
        if unit == "keys/sec":
            # rec/sec against the reference's keys/sec is not like for like:
            # only keys/sec lines carry a vs_baseline ratio.
            line["vs_baseline"] = round(n / dt / _REF_KEYS_PER_SEC, 2)
        line.update(extra)
        emit(line)

    ss32 = SampleSort(mesh)
    ref = gen_uniform(16_384, seed=0)
    # Config 1 routes as `cli run` would: one fused device program.  Its
    # wall splits into `device_ms`, the program alone (the slope over 10
    # against 2 back-to-back runs on a row already on the device, each
    # window closed by a synchronize), and `fixed_overhead_ms_per_dispatch`,
    # the rest of the single-job wall: the upload, the launch and the copy
    # back that bound the ratio.
    c1_label = "config1_reference_workload_16384_int32"
    try:
        n1 = len(ref)
        f1 = _fused_small_fn(pad_rung(n1), str(ref.dtype), "auto")  # 2^14 is a rung: no pad
        buf1 = torch.from_numpy(np.ascontiguousarray(ref)).to(dev)
        f1(buf1, n1)[-1:].cpu()  # warm: the first call per stream

        def _dev_total(k: int) -> float:
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                for _ in range(k):
                    f1(buf1, n1)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            return float(min(times))

        device_s = max((_dev_total(10) - _dev_total(2)) / 8, 0.0)
        fused_sort_small(ref, device=dev)  # warm the host-path wrapper
        e2e_times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fused_sort_small(ref, device=dev)
            e2e_times.append(time.perf_counter() - t0)
        e2e_s = float(min(e2e_times))
        emit({
            "metric": c1_label,
            "value": round(n1 / e2e_s, 1),
            "unit": "keys/sec",
            "includes_host_roundtrip": True,
            "vs_baseline": round(n1 / e2e_s / _REF_KEYS_PER_SEC, 2),
            "mode": "fused_local",
            "device_ms": round(device_s * 1e3, 3),
            "fixed_overhead_ms_per_dispatch": round(max(e2e_s - device_s, 0.0) * 1e3, 2),
        })
    except Exception as e:  # the decomposition must never sink the ladder
        log.warning("config1 floor decomposition failed: %s", e)
        timed(c1_label, len(ref), "keys/sec", lambda: fused_sort_small(ref, device=dev),
              mode="fused_local")
    u32 = gen_uniform(1 << 20, seed=1)
    timed("config2_uniform_1M_int32_spmd", len(u32), "keys/sec", lambda: ss32.sort(u32))
    u64 = gen_uniform(1 << 20, dtype=np.int64, seed=2)
    ss64 = SampleSort(mesh, JobConfig(key_dtype=np.int64))
    timed("config3_uniform_1M_int64_spmd", len(u64), "keys/sec", lambda: ss64.sort(u64))
    tk, tv = gen_terasort(1 << 16, seed=3)
    tsec = terasort_secondary(tv)
    sst = SampleSort(mesh, JobConfig(key_dtype=np.uint64))
    timed("config4_terasort_65536_records_kv", len(tk), "rec/sec",
          lambda: sst.sort_kv(tk, tv, secondary=tsec))
    z = gen_zipf(1 << 20, a=1.3, seed=4)
    if workers >= 4:
        # One scheduler across reps (its SampleSort per live set keeps the
        # shard programs built); the injector re-arms each call, so every
        # rep really loses a virtual worker and re-forms — checked below.
        inj = FaultInjector()
        sched = SpmdScheduler(workers, dev, JobConfig(settle_delay_s=0.01), injector=inj)

        def faulted():
            inj.fail_once(2, "spmd")
            m = Metrics()
            sched.sort(z, metrics=m)
            if not m.counters.get("mesh_reforms"):
                raise RuntimeError("config5: injected failure did not fire")

        timed("config5_zipf_1M_with_injected_failure", len(z), "keys/sec", faulted)
    else:
        # A mesh this small has no worker to lose and still sort: measure
        # and say so in the label.
        log.warning("config5: <4 workers, failure injection inactive")
        ss5 = SampleSort(mesh)
        timed("config5_zipf_1M_no_failure_single_device", len(z), "keys/sec",
              lambda: ss5.sort(z))
    return 0


def _bench_device_resident(args, cfg: SortConfig) -> int:
    """``--device-resident``: the sort that keeps its result on the device,
    and the on-device validator, one JSON line each (min over reps).  The
    card is synchronized before each clock read, so each window holds its
    own work."""
    from dsort_tpu_torch.data.ingest import gen_uniform
    from dsort_tpu_torch.models.validate import _multiset
    from dsort_tpu_torch.scheduler import SpmdScheduler

    dtype = np.dtype(cfg.job.key_dtype)
    data = gen_uniform(args.n, dtype=dtype, seed=0)
    sched = SpmdScheduler(_workers(cfg), getattr(args, "device", None), cfg.job)
    dev = sched.device
    journal = _open_journal(args)
    handle = sched.sort(data, keep_on_device=True)  # warm the sort
    handle.validate_on_device()                     # warm the validator
    sort_times, val_times = [], []
    rep = None
    try:
        for _ in range(args.reps):
            metrics = Metrics(journal=journal)
            t0 = time.perf_counter()
            handle = sched.sort(data, metrics=metrics, keep_on_device=True)
            _sync(dev)
            sort_times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            rep = handle.validate_on_device()
            _sync(dev)
            val_times.append(time.perf_counter() - t0)
    finally:
        _write_journal(journal, args)
    in_sum = _multiset(data, len(data), dtype.itemsize)
    ok = bool(rep.sorted_ok and rep.records == len(data) and rep.checksum == in_sum)
    dt, dtv = float(min(sort_times)), float(min(val_times))
    _emit({
        "metric": f"sort_e2e_device_resident_{dtype}_{args.n}_keys",
        "value": round(args.n / dt, 1),
        "unit": "keys/sec",
        "vs_baseline": round(args.n / dt / _REF_KEYS_PER_SEC, 2),
    })
    _emit({
        "metric": f"device_validate_{dtype}_{args.n}_keys",
        "value": round(args.n / dtv, 1),
        "unit": "keys/sec",
        "validated_ok": ok,
    })
    return 0 if ok else 1


def _bench_exchange_ab(args, cfg: SortConfig) -> int:
    """``--exchange-ab``: alltoall against ring against fused on the mesh.

    For a uniform int32, a zipf-skewed int64 and a TeraSort kv workload,
    sorts the same data through every schedule, requires bit-identical
    outputs, and prints per workload (a) the ring-against-alltoall line
    with both rates and each schedule's measured ``bytes_on_wire`` a sort
    (the counter charges every attempt, a retried capacity's shipment
    too), and (b) the ``exchange_fused_vs_ring_*`` line, whose structural
    axis is ``dispatches_per_exchange``: the ring issues P-1 shifts an
    exchange, the fused schedule one kernel launch (R1 for keys, R2's
    exchange and the row gather for records, ``csrc/ring_exchange.cu``).
    """
    from dsort_tpu_torch.data.ingest import gen_terasort, gen_uniform, gen_zipf
    from dsort_tpu_torch.parallel.exchange import dispatches_per_exchange
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    mesh = _mesh(args, cfg)
    # On one worker every schedule is the same program (resolve_exchange
    # turns ring back into alltoall at P=1): refuse rather than compare a
    # schedule with itself.
    _needs(mesh.num_workers, 2, "--exchange-ab",
           "a multi-worker mesh (the ring and the all_to_all are the same program on "
           "one worker)")
    journal = _open_journal(args)
    tk, tv = gen_terasort(1 << 16, seed=3)
    kern = cfg.job.local_kernel
    cases = [
        (f"uniform_int32_{args.n}", gen_uniform(args.n, seed=0), None,
         JobConfig(local_kernel=kern)),
        (f"zipf_int64_{args.n}", gen_zipf(args.n, a=1.3, seed=4), None,
         JobConfig(key_dtype=np.int64, local_kernel=kern)),
        ("kv_65536_records", tk, tv, JobConfig(key_dtype=np.uint64, local_kernel=kern)),
    ]
    ok_all = True
    try:
        for label, keys, payload, job in cases:
            ss = SampleSort(mesh, job)

            def run(exch, m=None):
                if payload is None:
                    return ss.sort(keys, metrics=m, exchange=exch)
                return ss.sort_kv(keys, payload, metrics=m, exchange=exch)

            def canonical(out):
                # kv: the keys must be bit-identical AND the records the same
                # multiset; the order of equal keys' payloads is unspecified
                # under every schedule, so records compare in (key, payload
                # bytes) order — which still catches sorted keys shipped over
                # scrambled payloads.
                if payload is None:
                    return out
                k, v = out
                order = np.lexsort(tuple(v[:, i] for i in range(v.shape[1])) + (k,))
                return k, k[order].tobytes() + v[order].tobytes()

            results, stats = {}, {}
            for exch in ("alltoall", "ring", "fused"):
                run(exch)  # warm: the kernels' first calls
                times = []
                m = _Reps(journal)
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    out = run(exch, m.metrics())
                    times.append(time.perf_counter() - t0)
                results[exch] = canonical(out)
                # Counters summed over the reps, reported a sort (each rep
                # starts from the policy capacity, so retries divide evenly).
                stats[exch] = {
                    "dt": float(min(times)),
                    "bytes": m.counters.get("exchange_bytes_on_wire", 0) // args.reps,
                    "retries": m.counters.get("capacity_retries", 0) // args.reps,
                    "saved": m.counters.get("exchange_bytes_saved", 0) // args.reps,
                    "launches": m.counters.get("fused_exchange_launches", 0) // args.reps,
                }

            def same(a, b):
                if payload is None:
                    return bool(np.array_equal(results[a], results[b]))
                return bool(np.array_equal(results[a][0], results[b][0])) and \
                    results[a][1] == results[b][1]

            identical = same("alltoall", "ring")
            fused_identical = same("ring", "fused")
            ok_all = ok_all and identical and fused_identical
            n = len(keys)
            p = mesh.num_workers
            unit = "keys/sec" if payload is None else "rec/sec"
            _emit({
                "metric": f"exchange_ring_vs_alltoall_{label}",
                "value": round(n / stats["ring"]["dt"], 1),
                "unit": unit,
                "alltoall_keys_per_sec": round(n / stats["alltoall"]["dt"], 1),
                "speedup_vs_alltoall": round(stats["alltoall"]["dt"] / stats["ring"]["dt"], 2),
                "bytes_on_wire": stats["ring"]["bytes"],
                "bytes_on_wire_alltoall": stats["alltoall"]["bytes"],
                "bytes_saved": stats["ring"]["saved"],
                "capacity_retries_alltoall": stats["alltoall"]["retries"],
                "capacity_retries_ring": stats["ring"]["retries"],
                "bit_identical": identical,
            })
            _emit({
                "metric": f"exchange_fused_vs_ring_{label}",
                "value": round(n / stats["fused"]["dt"], 1),
                "unit": unit,
                "ring_keys_per_sec": round(n / stats["ring"]["dt"], 1),
                "speedup_vs_ring": round(stats["ring"]["dt"] / stats["fused"]["dt"], 2),
                "dispatches_per_exchange": dispatches_per_exchange("fused", p),
                "dispatches_per_exchange_ring": dispatches_per_exchange("ring", p),
                "fused_launches_per_sort": stats["fused"]["launches"],
                "bytes_on_wire": stats["fused"]["bytes"],
                "capacity_retries": stats["fused"]["retries"],
                "bit_identical": fused_identical,
            })
    finally:
        _write_journal(journal, args)
    return 0 if ok_all else 1


def _bench_coded_ab(args, cfg: SortConfig) -> int:
    """``--coded-ab``: the coded plane's failure A/B.

    The same zipf workload through `SpmdScheduler` four ways: redundancy 1
    against 2, healthy against one injected mid-ring worker loss.  The
    uncoded faulted arm recovers by re-forming and re-running; the coded
    faulted arm by a local merge of replica slots — exactly one
    ``coded_recoveries`` a faulted sort, gated.  Every arm's output must be
    bit-identical to ``np.sort``.  Healthy arms warm once and report the
    minimum over reps; each faulted rep runs on a fresh scheduler (its
    healthy warm pass off the clock), so the timed sort pays its whole
    recovery: for the re-run arm the re-dispatch and the re-formed mesh's
    first calls, which the coded arm never makes.
    """
    from dsort_tpu_torch.data.ingest import gen_zipf
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler

    p = _workers(cfg)
    _needs(p, 2, "--coded-ab",
           "a multi-worker mesh (there is no replica holder on one worker)")
    # The victim exists on any mesh: worker 3 on the 8-worker mesh, the
    # last otherwise (its r = 2 replica holder is worker 0, round the ring).
    victim = min(3, p - 1)
    device = getattr(args, "device", None)
    journal = _open_journal(args)
    data = gen_zipf(args.n, a=1.3, seed=5)
    expect = np.sort(data)
    n = len(data)

    def make_sched(red: int):
        inj = FaultInjector()
        return inj, SpmdScheduler(
            p, device,
            JobConfig(settle_delay_s=0.01, exchange="ring", redundancy=red,
                      key_dtype=np.int64, local_kernel=cfg.job.local_kernel),
            injector=inj,
        )

    def run_arm(red: int, fault: bool):
        times = []
        m = _Reps(journal)
        out = None
        if not fault:
            _, sched = make_sched(red)
            sched.sort(data)  # warm the healthy P-worker programs
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = sched.sort(data, metrics=m.metrics())
                times.append(time.perf_counter() - t0)
            return float(min(times)), m, out
        for _ in range(args.reps):
            inj, sched = make_sched(red)
            sched.sort(data)  # healthy warm pass, off the clock
            inj.fail_once(victim, "ring")
            t0 = time.perf_counter()
            out = sched.sort(data, metrics=m.metrics())
            times.append(time.perf_counter() - t0)
        return float(min(times)), m, out

    try:
        arms = {}
        ok_all = True
        for red, fault in ((1, False), (2, False), (1, True), (2, True)):
            dt, m, out = run_arm(red, fault)
            identical = bool(np.array_equal(out, expect))
            ok_all = ok_all and identical
            arms[(red, fault)] = {
                "dt": dt,
                "identical": identical,
                "coded_recoveries": m.counters.get("coded_recoveries", 0) // args.reps,
                "recovered_keys": m.counters.get("coded_recovered_keys", 0) // args.reps,
                "replica_bytes": m.counters.get("coded_replica_bytes", 0) // args.reps,
                "mesh_reforms": m.counters.get("mesh_reforms", 0) // args.reps,
            }
        h1, h2 = arms[(1, False)], arms[(2, False)]
        f1, f2 = arms[(1, True)], arms[(2, True)]
        # Gate: the coded faulted arm recovers locally, once a sort.
        ok_all = ok_all and f2["coded_recoveries"] == 1
        _emit({
            "metric": f"coded_redundancy_healthy_zipf_{args.n}",
            "value": round(n / h2["dt"], 1),
            "unit": "keys/sec",
            "baseline_keys_per_sec": round(n / h1["dt"], 1),
            "replica_overhead_frac": round(max(h2["dt"] - h1["dt"], 0.0) / h1["dt"], 4),
            "redundancy": 2,
            "coded_replica_bytes": h2["replica_bytes"],
            "bit_identical": h1["identical"] and h2["identical"],
        })
        _emit({
            "metric": f"coded_redundancy_failure_zipf_{args.n}",
            "value": round(n / f2["dt"], 1),
            "unit": "keys/sec",
            "baseline_keys_per_sec": round(n / h1["dt"], 1),
            "rerun_keys_per_sec": round(n / f1["dt"], 1),
            "throughput_under_failure_ratio": round(h1["dt"] / f2["dt"], 3),
            "rerun_failure_ratio": round(h1["dt"] / f1["dt"], 3),
            "redundancy": 2,
            "coded_recoveries": f2["coded_recoveries"],
            "recovered_keys": f2["recovered_keys"],
            "mesh_reforms": f2["mesh_reforms"],
            "includes_reform_and_recompile": True,
            "bit_identical": all(a["identical"] for a in arms.values()),
        })
    finally:
        _write_journal(journal, args)
    return 0 if ok_all else 1


def _bench_coded_v2_ab(args, cfg: SortConfig) -> int:
    """``--coded-v2-ab``: replicate against parity at redundancy 2, and the
    straggler drill.  Three lines, all gated (ok -> exit 0):

    - ``coded_v2_parity_premium``: parity must ship under 0.75x
      replicate's measured ``coded_replica_bytes`` on the same plan (one
      XOR slot against a full replica a range);
    - ``coded_v2_parity_failure``: one injected mid-ring loss a mode; both
      recover locally, exactly one coded recovery a faulted sort and zero
      re-sorted keys (faulted reps on a fresh scheduler, warm pass off the
      clock);
    - ``coded_v2_straggler``: `FaultInjector.slow` names a live but slow
      owner; the plane races the owner's fetch against reconstruction, and
      the p99 sort time with serving on must beat the owner leg's own
      completion in the same reps (drained with `join_stragglers`), which
      pays the injected delay the serve dodged; exactly one
      ``coded_straggler_serves`` a rep, no re-form.

    Every arm's output must be bit-identical to ``np.sort``.
    """
    from dsort_tpu_torch.data.ingest import gen_zipf
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler

    p = _workers(cfg)
    _needs(p, 2, "--coded-v2-ab",
           "a multi-worker mesh (there is no parity holder on one worker)")
    victim = min(3, p - 1)  # its replica / parity holder wraps the ring
    slow_s = 0.5  # the injected straggler's extra owner-fetch latency
    device = getattr(args, "device", None)
    journal = _open_journal(args)
    data = gen_zipf(args.n, a=1.3, seed=5)
    expect = np.sort(data)
    n = len(data)

    def make_sched(red: int, mode: str):
        inj = FaultInjector()
        return inj, SpmdScheduler(
            p, device,
            JobConfig(settle_delay_s=0.01, exchange="ring", redundancy=red,
                      redundancy_mode=mode, key_dtype=np.int64,
                      local_kernel=cfg.job.local_kernel),
            injector=inj,
        )

    def drain(sched) -> None:
        for ss in sched._sorters.values():
            ss.join_stragglers()

    def p99(times: list) -> float:
        ts = sorted(times)
        return float(ts[max(0, math.ceil(0.99 * len(ts)) - 1)])

    def run_arm(red: int, mode: str, shape: str):
        """``shape``: healthy, loss or slow.  Returns (times, owner times,
        the arm's metrics, the last output); loss and slow reps each run on
        a fresh scheduler with a healthy warm pass off the clock."""
        times, owner_times = [], []
        m = _Reps(journal)
        out = None
        if shape == "healthy":
            _, sched = make_sched(red, mode)
            sched.sort(data)  # warm the healthy P-worker programs
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = sched.sort(data, metrics=m.metrics())
                times.append(time.perf_counter() - t0)
            return times, owner_times, m, out
        for _ in range(args.reps):
            inj, sched = make_sched(red, mode)
            sched.sort(data)  # healthy warm pass, off the clock
            if shape == "loss":
                inj.fail_once(victim, "ring")
            else:
                inj.slow(victim, slow_s)
            t0 = time.perf_counter()
            out = sched.sort(data, metrics=m.metrics())
            times.append(time.perf_counter() - t0)
            # The losing owner leg is still sleeping out its delay; its
            # completion is this rep's wait-on-owner baseline.  Drain it
            # before the next rep so serves stay one a rep.
            drain(sched)
            owner_times.append(time.perf_counter() - t0)
        return times, owner_times, m, out

    try:
        arms = {}
        ok_all = True
        for red, mode, shape in (
            (1, "replicate", "healthy"),
            (2, "replicate", "healthy"),
            (2, "parity", "healthy"),
            (2, "replicate", "loss"),
            (2, "parity", "loss"),
            (2, "parity", "slow"),
        ):
            times, owner_times, m, out = run_arm(red, mode, shape)
            identical = bool(np.array_equal(out, expect))
            ok_all = ok_all and identical
            arms[(red, mode, shape)] = {
                "dt": float(min(times)),
                "p99": p99(times),
                "p99_owner": p99(owner_times) if owner_times else 0.0,
                "identical": identical,
                "coded_recoveries": m.counters.get("coded_recoveries", 0) // args.reps,
                "recovered_keys": m.counters.get("coded_recovered_keys", 0) // args.reps,
                "replica_bytes": m.counters.get("coded_replica_bytes", 0) // args.reps,
                "straggler_serves": m.counters.get("coded_straggler_serves", 0) // args.reps,
                "resort_keys": m.counters.get("shuffle_resort_keys", 0),
                "mesh_reforms": m.counters.get("mesh_reforms", 0) // args.reps,
            }
        h0 = arms[(1, "replicate", "healthy")]
        hr, hp = arms[(2, "replicate", "healthy")], arms[(2, "parity", "healthy")]
        fr, fp = arms[(2, "replicate", "loss")], arms[(2, "parity", "loss")]
        sl = arms[(2, "parity", "slow")]
        premium = hp["replica_bytes"] / max(hr["replica_bytes"], 1)
        # Gate 1: parity's premium undercuts replication.
        ok_all = ok_all and hp["replica_bytes"] > 0 and premium < 0.75
        # Gate 2: both modes recover the injected loss locally.
        for f in (fr, fp):
            ok_all = ok_all and f["coded_recoveries"] == 1 and f["resort_keys"] == 0
        # Gate 3: serving beats waiting on the slow owner, exactly once a
        # rep, with no failure machinery involved.
        ok_all = (ok_all and sl["straggler_serves"] == 1 and sl["p99"] < sl["p99_owner"]
                  and sl["mesh_reforms"] == 0)
        _emit({
            "metric": f"coded_v2_parity_premium_zipf_{args.n}",
            "value": round(n / hp["dt"], 1),
            "unit": "keys/sec",
            "baseline_keys_per_sec": round(n / h0["dt"], 1),
            "replicate_keys_per_sec": round(n / hr["dt"], 1),
            "replica_overhead_frac": round(max(hp["dt"] - h0["dt"], 0.0) / h0["dt"], 4),
            "redundancy": 2,
            "redundancy_mode": "parity",
            "coded_replica_bytes": hp["replica_bytes"],
            "replicate_replica_bytes": hr["replica_bytes"],
            "premium_ratio": round(premium, 4),
            "bit_identical": hp["identical"] and hr["identical"],
        })
        _emit({
            "metric": f"coded_v2_parity_failure_zipf_{args.n}",
            "value": round(n / fp["dt"], 1),
            "unit": "keys/sec",
            "baseline_keys_per_sec": round(n / h0["dt"], 1),
            "replicate_keys_per_sec": round(n / fr["dt"], 1),
            "throughput_under_failure_ratio": round(h0["dt"] / fp["dt"], 3),
            "redundancy": 2,
            "redundancy_mode": "parity",
            "coded_recoveries": fp["coded_recoveries"],
            "recovered_keys": fp["recovered_keys"],
            "mesh_reforms": fp["mesh_reforms"],
            "includes_reform_and_recompile": True,
            "bit_identical": fp["identical"] and fr["identical"],
        })
        _emit({
            "metric": f"coded_v2_straggler_zipf_{args.n}",
            "value": round(n / sl["p99"], 1),
            "unit": "keys/sec",
            "baseline_keys_per_sec": round(n / h0["dt"], 1),
            "p99_serve_s": round(sl["p99"], 4),
            "p99_owner_s": round(sl["p99_owner"], 4),
            "speedup_vs_wait": round(sl["p99_owner"] / sl["p99"], 2),
            "slow_s": slow_s,
            "redundancy": 2,
            "redundancy_mode": "parity",
            "straggler_serves": sl["straggler_serves"],
            "mesh_reforms": sl["mesh_reforms"],
            "bit_identical": sl["identical"],
        })
    finally:
        _write_journal(journal, args)
    return 0 if ok_all else 1


def _bench_hier_ab(args, cfg: SortConfig) -> int:
    """``--hier-ab``: flat ring against the two-level exchange.

    One zipf workload sorted under the flat ring and under ``hier`` at
    every ``H x D`` grouping the mesh divides into, then the fault drills.
    On one card the hosts are groups of virtual workers, so the DCN-leg
    bytes (``dcn_bytes``, ``ring_dcn_bytes``) are the exchange plan's
    counts of what would cross a host boundary, not measured wire.  Gates
    (ok -> exit 0):

    - every arm's output bit-identical to ``np.sort``;
    - at every grouping the planned ``dcn_bytes_on_wire`` is below what the
      flat ring would push across the same boundary for the same measured
      histogram (``dcn_bytes_saved`` is the difference, and must be > 0);
    - the worker-loss drill re-forms within the host: losing workers of
      one host mid-exchange keeps the H-host grouping (``hier_reform`` with
      ``hosts_before == hosts_after``), bit-identical;
    - the host-loss drill re-plans: losing all of one host's workers
      re-forms the survivors under the largest divisor they still allow
      (``hosts_after < hosts_before``), bit-identical.

    One line a grouping and one a drill.
    """
    from dsort_tpu_torch.data.ingest import gen_zipf
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
    from dsort_tpu_torch.utils.events import EventLog

    mesh = _mesh(args, cfg)
    p = mesh.num_workers
    _needs(p, 4, "--hier-ab",
           ">= 4 workers (two simulated hosts of two workers is the smallest two-level "
           "topology)")
    journal = _open_journal(args) or EventLog()
    data = gen_zipf(args.n, a=1.3, seed=6)
    expect = np.sort(data)
    n = len(data)
    # Every grouping of >= 2 hosts with >= 2 workers a host: 2x4 and 4x2 on
    # the 8-worker mesh.
    topologies = [h for h in (2, 4, 8) if h < p and p % h == 0 and p // h >= 2]
    job_kw = dict(key_dtype=np.int64, local_kernel=cfg.job.local_kernel)
    ok_all = True
    try:
        ss_ring = SampleSort(mesh, JobConfig(exchange="ring", **job_kw))
        ss_ring.sort(data)  # warm: the kernels' first calls
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            ring_out = ss_ring.sort(data)
            times.append(time.perf_counter() - t0)
        ring_dt = float(min(times))
        for hosts in topologies:
            ss = SampleSort(mesh, JobConfig(exchange="hier", hier_hosts=hosts, **job_kw))
            ss.sort(data)  # warm
            m = _Reps(journal)
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = ss.sort(data, metrics=m.metrics())
                times.append(time.perf_counter() - t0)
            dt = float(min(times))
            identical = bool(np.array_equal(out, expect)) and bool(
                np.array_equal(ring_out, expect))
            dcn = m.counters.get("dcn_bytes_on_wire", 0) // args.reps
            intra = m.counters.get("intra_host_bytes_on_wire", 0) // args.reps
            saved = m.counters.get("dcn_bytes_saved", 0) // args.reps
            ring_dcn = dcn + saved  # the flat baseline, same histogram
            ok_all = ok_all and identical and saved > 0
            _emit({
                "metric": f"hier_exchange_zipf_{args.n}_h{hosts}",
                "value": round(n / dt, 1),
                "unit": "keys/sec",
                "hosts": hosts,
                "dev_per_host": p // hosts,
                "ring_keys_per_sec": round(n / ring_dt, 1),
                "dcn_bytes": int(dcn),
                "ring_dcn_bytes": int(ring_dcn),
                "dcn_reduction_frac": round(saved / ring_dcn, 4) if ring_dcn else 0.0,
                "intra_host_bytes": int(intra),
                "hier_exchanges": m.counters.get("hier_exchanges", 0) // args.reps,
                "bit_identical": identical,
            })

        # The drills: the hook fires between the (H, H) plan and the
        # exchange, so a loss invalidates the planned exchange and the
        # survivors re-plan.
        def drill(hosts: int, victims: list[int]):
            inj = FaultInjector()
            sched = SpmdScheduler(
                p, mesh.device,
                JobConfig(settle_delay_s=0.01, exchange="hier", hier_hosts=hosts, **job_kw),
                injector=inj,
            )
            sched.sort(data)  # healthy warm pass, off the clock
            for w in victims:
                inj.fail_once(w, "ring")
            m = Metrics(journal=journal)
            t0 = time.perf_counter()
            out = sched.sort(data, metrics=m)
            dt = time.perf_counter() - t0
            reforms = [e for e in journal.events() if e.type == "hier_reform"][-1:]
            rf = reforms[0].fields if reforms else {}
            return dt, m, rf, bool(np.array_equal(out, expect))

        # Worker loss, H = 2: workers of host 0 (never all of it) die; the
        # survivors' count still divides by 2, as a re-formed host group on
        # real hosts would keep its grouping.
        dev_victims = [1] if (p - 1) % 2 == 0 else [1, 2]
        dt_dev, m_dev, rf_dev, id_dev = drill(2, dev_victims)
        ok_dev = (id_dev and rf_dev.get("hosts_before") == 2
                  and rf_dev.get("hosts_after") == 2 and not rf_dev.get("downgraded"))
        ok_all = ok_all and ok_dev
        _emit({
            "metric": f"hier_device_loss_drill_zipf_{args.n}",
            "value": round(n / dt_dev, 1),
            "unit": "keys/sec",
            "hosts_before": rf_dev.get("hosts_before"),
            "hosts_after": rf_dev.get("hosts_after"),
            "downgraded": rf_dev.get("downgraded"),
            "survivors": rf_dev.get("survivors"),
            "mesh_reforms": m_dev.counters.get("mesh_reforms", 0),
            "bit_identical": id_dev,
        })
        # Host loss, H = 4 (where the mesh allows it): all of host 1's
        # workers die; the survivors no longer divide by 4, so the re-plan
        # lands on the largest divisor they do allow.
        if 4 in topologies:
            dh = p // 4
            dt_host, m_host, rf_host, id_host = drill(4, list(range(dh, 2 * dh)))
            ok_host = (id_host and rf_host.get("hosts_before") == 4
                       and 2 <= int(rf_host.get("hosts_after") or 0) < 4
                       and not rf_host.get("downgraded"))
            ok_all = ok_all and ok_host
            _emit({
                "metric": f"hier_host_loss_drill_zipf_{args.n}",
                "value": round(n / dt_host, 1),
                "unit": "keys/sec",
                "hosts_before": rf_host.get("hosts_before"),
                "hosts_after": rf_host.get("hosts_after"),
                "downgraded": rf_host.get("downgraded"),
                "survivors": rf_host.get("survivors"),
                "mesh_reforms": m_host.counters.get("mesh_reforms", 0),
                "bit_identical": id_host,
            })
    finally:
        if getattr(args, "journal", None):
            journal.flush_jsonl(args.journal)
    return 0 if ok_all else 1


def _bench_autotune_ab(args, cfg: SortConfig) -> int:
    """``--autotune-ab``: does the planner pay for itself?

    A zipf-skewed int64 and a uniform int32 workload, each sorted three
    ways: the exchange hand-set to alltoall, hand-set to ring, and a third
    arm with ``autotune=True`` and the knob unset, where the planner's skew
    probe picks the schedule a dispatch and journals a ``plan_decision``.
    Gates (ok -> exit 0):

    - every arm's output bit-identical;
    - the planner's pick: on the zipf workload the skewed schedule — the
      fused ring where the planner is told fused is available (a mesh on
      the card: one exchange launch), the ring on the CPU — and alltoall
      on the uniform one;
    - the autotune arm at >= 0.95x the best hand-set arm from 1M keys up;
      below that the fixed cost of a sort drowns the difference, and the
      structural checks alone apply.

    The arms run in turns, rep by rep, where the reference runs them one
    after another; the lines are the same.  One line a workload.
    """
    from dsort_tpu_torch.data.ingest import gen_uniform, gen_zipf
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.utils.events import EventLog

    mesh = _mesh(args, cfg)
    _needs(mesh.num_workers, 2, "--autotune-ab",
           "a multi-worker mesh (every exchange schedule is the same program on one "
           "worker)")
    journal = _open_journal(args) or EventLog()
    # The planner's `fused_ok` (SampleSort._dispatch_keys): a mesh on the card.
    skewed = "fused" if mesh.device.type == "cuda" else "ring"
    cases = [
        (f"zipf_int64_{args.n}", gen_zipf(args.n, a=1.3, seed=4),
         JobConfig(key_dtype=np.int64, local_kernel=cfg.job.local_kernel), skewed),
        (f"uniform_int32_{args.n}", gen_uniform(args.n, seed=0),
         JobConfig(local_kernel=cfg.job.local_kernel), "alltoall"),
    ]
    ok_all = True
    try:
        for label, keys, job, expected in cases:
            ss_hand = SampleSort(mesh, job)
            # The autotune arm: the knob unset, the planner decides a
            # dispatch, and every timed rep journals its plan_decision.
            ss_auto = SampleSort(mesh, dataclasses.replace(job, autotune=True))
            for exch in ("alltoall", "ring"):
                ss_hand.sort(keys, exchange=exch)  # warm
            ss_auto.sort(keys)  # warm (the probe runs, unjournaled)
            start = len(journal)
            m = _Reps(journal)
            times = {"alltoall": [], "ring": [], "auto": []}
            order = list(times)
            outs = {}
            for i in range(args.reps):
                # The three arms in turns, the order rotated a rep: drift on
                # the host, and what one arm leaves the next, fall on all
                # alike; each arm keeps its minimum.
                for arm in order[i % 3:] + order[:i % 3]:
                    t0 = time.perf_counter()
                    if arm == "auto":
                        outs[arm] = ss_auto.sort(keys, metrics=m.metrics())
                    else:
                        outs[arm] = ss_hand.sort(keys, exchange=arm)
                    times[arm].append(time.perf_counter() - t0)
            arms = {a: {"dt": float(min(times[a])), "out": outs[a]} for a in ("alltoall", "ring")}
            auto_out, auto_dt = outs["auto"], float(min(times["auto"]))
            plans = [e for e in journal.events()[start:]
                     if e.type == "plan_decision" and e.fields.get("policy") == "exchange"]
            chosen = plans[-1].fields.get("chosen") if plans else None
            identical = bool(np.array_equal(auto_out, arms["alltoall"]["out"])) and bool(
                np.array_equal(auto_out, arms["ring"]["out"]))
            best_arm = min(arms, key=lambda a: arms[a]["dt"])
            best_dt = arms[best_arm]["dt"]
            vs_best = best_dt / auto_dt if auto_dt > 0 else 0.0
            fast_enough = vs_best >= 0.95 or args.n < (1 << 20)
            ok = identical and chosen == expected and len(plans) == args.reps and fast_enough
            ok_all = ok_all and ok
            n = len(keys)
            _emit({
                "metric": f"autotune_ab_{label}",
                "value": round(n / auto_dt, 1),
                "unit": "keys/sec",
                "chosen_exchange": chosen,
                "expected_exchange": expected,
                "best_arm": best_arm,
                "best_keys_per_sec": round(n / best_dt, 1),
                "alltoall_keys_per_sec": round(n / arms["alltoall"]["dt"], 1),
                "ring_keys_per_sec": round(n / arms["ring"]["dt"], 1),
                "autotune_vs_best": round(vs_best, 3),
                "plan_decisions": len(plans),
                "bit_identical": identical,
            })
    finally:
        if getattr(args, "journal", None):
            journal.flush_jsonl(args.journal)
    return 0 if ok_all else 1


def _queue_fairness(events, tenants) -> tuple[float, float]:
    """``(p95_wait_s, fairness_p95_ratio)`` from journaled ``job_dequeued``
    records.  Big jobs stay out of the per-tenant comparison: a big job's
    long wait is deficit round robin accumulating the whole mesh for it,
    not a tenant starved."""
    waits: dict[str, list[float]] = {}
    all_waits: list[float] = []
    for e in events:
        if e.type == "job_dequeued":
            w = float(e.fields.get("wait_s", 0.0))
            all_waits.append(w)
            if not e.fields.get("big"):
                waits.setdefault(e.fields.get("tenant", "?"), []).append(w)
    p95 = float(np.percentile(all_waits, 95)) if all_waits else 0.0
    tenant_p95 = {t: float(np.percentile(ws, 95)) for t, ws in waits.items()
                  if t in tenants and ws}
    fairness = (max(tenant_p95.values()) / max(min(tenant_p95.values()), 1e-9)
                if len(tenant_p95) > 1 else 1.0)
    return p95, fairness


def _bench_serve_mixed(args, cfg: SortConfig) -> int:
    """``--serve-mixed``: the multi-tenant serving benchmark.

    4 small jobs from each of 3 tenants (two repeat sizes, so the variant
    cache must show reuse) plus one large job, submitted together through
    admission onto the packed mesh: small jobs on slices, each slice on its
    own CUDA stream, the large job on the whole mesh.  Every output must be
    numpy's bits.  One line: jobs/s over the mix, the p95 queue wait from
    the journal's ``job_dequeued`` records, the per-tenant p95 fairness
    ratio, the variant cache's hit rate, and the packed window against the
    same small jobs through a one-slice service (``speedup_vs_serial``, as
    the card gives it: the host work around each small job bounds it).
    """
    from dsort_tpu_torch.obs import Telemetry
    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.utils.events import EventLog

    n_devs = _workers(cfg)
    _needs(n_devs, 2, "--serve-mixed",
           "a multi-worker mesh (packing small jobs onto slices of one worker is serial "
           "dispatch by another name)")
    device = getattr(args, "device", None)
    n_small = max(min(args.n, 1 << 19), 1 << 10)
    n_large = 1 << 20  # >= FUSED_SMALL_JOB_MAX: takes the whole mesh
    tenants = ("acme", "blue", "coral")
    rng = np.random.default_rng(0)
    # Two repeat sizes a tenant: repeats are where the cache must hit.
    small_jobs = []
    for j in range(4):
        for t in tenants:
            n = n_small if j % 2 == 0 else max(n_small // 2, 1 << 9)
            small_jobs.append((t, rng.integers(0, 1 << 30, n).astype(np.int32)))
    large = rng.integers(0, 1 << 30, n_large).astype(np.int32)
    serve_cfg = dataclasses.replace(
        cfg.serve,
        max_queue_depth=max(cfg.serve.max_queue_depth, len(small_jobs) + 4),
        max_tenant_inflight=max(cfg.serve.max_tenant_inflight, len(small_jobs) + 2),
    )
    journal = _open_journal(args) or EventLog()
    tel = Telemetry()

    def run_window(svc, jobs, with_large: bool) -> tuple[float, bool]:
        t0 = time.perf_counter()
        tickets = [svc.submit(d, tenant=t)[1] for t, d in jobs]
        if with_large:
            tickets.append(svc.submit(large, tenant="acme")[1])
        ok = True
        for (_, d), ticket in zip(jobs + ([("acme", large)] if with_large else []), tickets):
            out = ticket.result(timeout=600)
            ok = ok and bool(np.array_equal(out, np.sort(d)))
        return time.perf_counter() - t0, ok

    # Serial baseline: the same small jobs through a one-slice service
    # (slice_devices = the mesh), prewarmed like the packed one, so the
    # difference is the packing alone.
    sizes = sorted({len(d) for _, d in small_jobs})
    serial = SortService(n_devs, device, job=cfg.job,
                         serve=dataclasses.replace(serve_cfg, slice_devices=n_devs))
    serial.prewarm(sizes=sizes)
    dt_serial, ok_serial = run_window(serial, small_jobs, with_large=False)
    serial.shutdown()

    svc = SortService(n_devs, device, job=cfg.job, serve=serve_cfg, telemetry=tel,
                      journal=journal)
    prewarmed = svc.prewarm(sizes=sizes)
    svc._sched.sort(large)  # warm the whole-mesh sort once
    dt_packed, ok_packed = run_window(svc, small_jobs, with_large=False)
    mixed_start = len(journal)
    dt_mixed, ok_mixed = run_window(svc, small_jobs, with_large=True)
    stats = svc.stats()
    hit_rate = svc.variants.hit_rate()
    svc.shutdown()
    try:
        if getattr(args, "journal", None):
            journal.flush_jsonl(args.journal)
    except OSError as e:
        log.warning("serve-mixed journal write failed: %s", e)
    p95, fairness = _queue_fairness(journal.events()[mixed_start:], tenants)
    ok = ok_serial and ok_packed and ok_mixed
    jobs_total = len(small_jobs) + 1
    _emit({
        "metric": "service_mixed_workload",
        "value": round(jobs_total / dt_mixed, 2),
        "unit": "jobs/sec",
        "jobs": jobs_total,
        "tenants": len(tenants),
        "p95_queue_wait_ms": round(p95 * 1e3, 2),
        "fairness_p95_ratio": round(fairness, 2),
        "cache_hit_rate": round(hit_rate, 3),
        "prewarmed": prewarmed,
        "speedup_vs_serial": round(dt_serial / dt_packed, 2),
        "bit_identical": ok,
        "slices": stats["slices"],
    })
    return 0 if ok else 1


def _bench_fleet_mixed(args, cfg: SortConfig) -> int:
    """``--fleet-mixed``: the fleet benchmark, the reference's arms.

    Two execution agents, each a real `fleet.FleetAgent` over a
    `serve.SortService` of half the ``--workers`` on the card (its own
    slices and streams), spoken to over loopback TCP, behind a
    `fleet.FleetController`, driven with a mixed workload (4 small jobs x
    3 tenants at two repeat sizes, twice, plus one 2^20-key job for a
    ``big_jobs`` agent) under ``random`` (run first, so the later arms run
    warm), ``locality`` and ``health`` routing.  The A/B axis is variant-
    cache locality: under locality the repeat sizes stick to the agent that
    already ran their rung, under random they scatter.  Exit 1 unless every
    output is numpy's bits, locality's fleet-wide hit rate is above
    random's, and the health arm journaled verdicts.  A heartbeats-only
    locality arm (telemetry off) against the locality arm gives
    ``telemetry_overhead_frac`` (min over ``--reps`` a side; printed, not
    gated, as the reference's); the p95 queue wait and the tenants' p95
    ratio come from the controller's ``job_dequeued`` records.
    """
    from dsort_tpu_torch.fleet.agent import FleetAgent
    from dsort_tpu_torch.fleet.controller import FleetController
    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.utils.events import EventLog

    n_devs = _workers(cfg)
    _needs(n_devs, 2, "--fleet-mixed", "at least 2 workers (each agent owns half of them)")
    device = getattr(args, "device", None)
    half = max(n_devs // 2, 1)
    n_small = max(min(args.n, 1 << 19), 1 << 10)
    n_large = 1 << 20  # >= FLEET_SMALL_JOB_MAX: routes by size
    tenants = ("acme", "blue", "coral")
    rng = np.random.default_rng(0)
    # Two repeat sizes x two rounds: repeats are where locality must show
    # its cache hits over random.
    small_jobs = []
    for _ in range(2):
        for j in range(4):
            for t in tenants:
                n = n_small if j % 2 == 0 else max(n_small // 2, 1 << 9)
                small_jobs.append((t, rng.integers(0, 1 << 30, n).astype(np.int32)))
    large = rng.integers(0, 1 << 30, n_large).astype(np.int32)
    jobs = small_jobs + [("acme", large)]
    refs = [np.sort(d) for _, d in jobs]
    serve_cfg = dataclasses.replace(
        cfg.serve,
        max_queue_depth=max(cfg.serve.max_queue_depth, len(small_jobs) + 8),
        max_tenant_inflight=max(cfg.serve.max_tenant_inflight, len(small_jobs) + 2),
    )
    journal = _open_journal(args) or EventLog()

    def run_arm(routing: str, arm_journal, td: str, name: str, telemetry_on: bool = True):
        agents = [
            FleetAgent(service=SortService(workers, device, job=cfg.job, serve=serve_cfg),
                       agent_id=f"{name}-{side}")
            for side, workers in (("a", half), ("b", n_devs - half))
        ]
        ctl = FleetController(
            [ag.addr for ag in agents], state_dir=os.path.join(td, name),
            max_queue_depth=serve_cfg.max_queue_depth,
            max_tenant_inflight=serve_cfg.max_tenant_inflight, routing=routing,
            heartbeat_s=0.5, journal=arm_journal, health_telemetry=telemetry_on,
        )
        try:
            t0 = time.perf_counter()
            tickets = [ctl.submit(d, tenant=t)[1] for t, d in jobs]
            outs = [ticket.result(timeout=900) for ticket in tickets]
            dt = time.perf_counter() - t0
            ok = all(np.array_equal(out, ref) for out, ref in zip(outs, refs))
            events = arm_journal.events()
            rerouted = sum(1 for e in events if e.type == "job_rerouted")
            verdicts = sum(1 for e in events if e.type == "health_verdict")
            hits = misses = 0
            for ag in agents:
                st = ag.service.variants.stats()
                hits += st["hits"]
                misses += st["misses"]
            hit_rate = hits / (hits + misses) if (hits + misses) else 0.0
            return dt, ok, hit_rate, rerouted, verdicts
        finally:
            ctl.shutdown(drain=True)
            for ag in agents:
                ag.close()

    rand_journal, health_journal = EventLog(), EventLog()
    with tempfile.TemporaryDirectory() as td:
        # The random arm runs first and warms the process (the kernels' first
        # calls, the allocator), so the arms after it compare warm.
        dt_rand, ok_rand, hit_rand, _, _ = run_arm("random", rand_journal, td, "random")
        # Heartbeats only against the live health plane: the same locality
        # workload, the telemetry opt-in the only difference; min of reps a
        # side.
        dt_hb = dt_loc = None
        ok_hb = ok_loc = True
        for i in range(args.reps):
            dt, ok, _, _, _ = run_arm("locality", EventLog(), td, f"hb-only{i}",
                                      telemetry_on=False)
            ok_hb = ok_hb and ok
            dt_hb = dt if dt_hb is None else min(dt_hb, dt)
            dt, ok, hit_loc, rerouted, _ = run_arm("locality", journal, td, f"locality{i}")
            ok_loc = ok_loc and ok
            dt_loc = dt if dt_loc is None else min(dt_loc, dt)
        dt_health, ok_health, hit_health, _, verdicts = run_arm(
            "health", health_journal, td, "health")
    try:
        if getattr(args, "journal", None):
            journal.flush_jsonl(args.journal)
    except OSError as e:
        log.warning("fleet-mixed journal write failed: %s", e)
    p95, fairness = _queue_fairness(journal.events(), tenants)
    ok = ok_rand and ok_loc and ok_hb and ok_health and hit_loc > hit_rand and verdicts > 0
    _emit({
        "metric": "fleet_mixed_workload_2agents",
        "value": round(len(jobs) / dt_loc, 2),
        "unit": "jobs/sec",
        "jobs": len(jobs),
        "tenants": len(tenants),
        "agents": 2,
        "cache_hit_rate": round(hit_loc, 3),
        "cache_hit_rate_random": round(hit_rand, 3),
        "p95_queue_wait_ms": round(p95 * 1e3, 2),
        "fairness_p95_ratio": round(fairness, 2),
        "speedup_vs_random": round(dt_rand / dt_loc, 2),
        "rerouted": rerouted,
        "telemetry_overhead_frac": round(dt_loc / dt_hb - 1.0, 4),
        "bit_identical": ok_rand and ok_loc,
    })
    _emit({
        "metric": "fleet_mixed_health_routing_2agents",
        "value": round(len(jobs) / dt_health, 2),
        "unit": "jobs/sec",
        "jobs": len(jobs),
        "tenants": len(tenants),
        "agents": 2,
        "cache_hit_rate": round(hit_health, 3),
        "health_verdicts": verdicts,
        "speedup_vs_locality": round(dt_loc / dt_health, 2),
        "bit_identical": ok_health,
    })
    return 0 if ok else 1


def _nlabel(n: int) -> str:
    return f"{n >> 20}M" if n % (1 << 20) == 0 and n >= (1 << 20) else f"{n}_keys"


def _bench_external_wave(args, cfg: SortConfig) -> int:
    """``--external-wave``: the out-of-core wave pipeline.

    Sorts a binary key file ``W`` times its per-wave device budget
    (``over_hbm_factor`` = W = 8) through `ExternalWaveSort` on the mesh:

    - ``external_wave_sort_uniform_*``: keys/s with the overlap on,
      bit-identical to ``np.sort``, beside the same data without it
      (``overlap_speedup`` = sequential / pipelined: the value of
      overlapping wave k's exchange with wave k-1's spill);
    - ``external_wave_fault_drill_*``: the same job with a worker lost in a
      middle wave's ring, repaired at run granularity in flight;
      ``resume_fraction`` (re-sorted runs / all runs) must stay within
      1/num_waves plus one run, and the output bit-identical.

    On the card the peak device allocation of the pipelined runs is logged
    beside the dataset's bytes (`torch.cuda.max_memory_allocated`).
    """
    from dsort_tpu_torch.data.ingest import gen_uniform
    from dsort_tpu_torch.models.wave_sort import ExternalWaveSort
    from dsort_tpu_torch.scheduler.fault import WorkerFailure

    mesh = _mesh(args, cfg)
    p = mesh.num_workers
    _needs(p, 2, "--external-wave",
           "a multi-worker mesh (the wave exchange is the pipeline under test)")
    n = max(args.n, 1 << 14)
    num_waves = 8  # the dataset is 8x the per-wave device budget
    wave_elems = -(-n // num_waves)
    journal = _open_journal(args)
    rows: list[dict] = []
    on_card = mesh.device.type == "cuda"

    with tempfile.TemporaryDirectory() as td:
        in_path = os.path.join(td, "in.bin")
        data = gen_uniform(n, dtype=np.int32, seed=3)
        data.tofile(in_path)
        mm = np.memmap(in_path, dtype=np.int32, mode="r")
        expect = np.sort(data)

        def run(tag, overlap, fault_wave=None, reps=1):
            # One sorter a mode: its programs persist across reps, so the
            # minimum over reps times the pipeline, not the first calls.
            s = ExternalWaveSort(
                mesh, wave_elems=wave_elems, spill_dir=os.path.join(td, "spill"),
                job_id=f"bench_{tag}", resume=False, overlap=overlap,
            )
            if fault_wave is not None:
                calls = {"n": 0}

                def hook():
                    calls["n"] += 1
                    if calls["n"] == fault_wave + 1:
                        raise WorkerFailure("injected mid-ring device loss (bench drill)")

                s.fault_hook = hook
            best, counters, all_ok = None, None, True
            for _ in range(reps):
                m = Metrics(journal=journal)
                out = np.empty(n, np.int32)
                t0 = time.perf_counter()
                s.sort(mm, out=out, metrics=m)
                dt = time.perf_counter() - t0
                # EVERY rep must be bit-identical: a wrong fast rep fails the
                # line, it does not hide behind a right slower one.
                all_ok = all_ok and bool(np.array_equal(out, expect))
                if best is None or dt < best:
                    best = dt
                counters = dict(m.counters)
            return best, all_ok, counters

        run("warm", overlap=True)  # the page cache and the first calls, off the clock
        dt_seq, ok_seq, _ = run("seq", overlap=False, reps=args.reps)
        if on_card:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        dt_pipe, ok_pipe, c_pipe = run("pipe", overlap=True, reps=args.reps)
        if on_card:
            log.info("external wave: peak device allocation %d bytes in the pipelined "
                     "runs, the dataset %d bytes", torch.cuda.max_memory_allocated(mesh.device),
                     data.nbytes)
        total_runs = num_waves * p
        rows.append({
            "metric": f"external_wave_sort_uniform_{_nlabel(n)}",
            "value": round(n / dt_pipe, 1),
            "unit": "keys/sec",
            "bit_identical": bool(ok_pipe and ok_seq),
            "over_hbm_factor": num_waves,
            "num_waves": num_waves,
            "overlap_speedup": round(dt_seq / dt_pipe, 3),
            "resume_fraction": 0.0,
            "bytes_on_wire": int(c_pipe.get("exchange_bytes_on_wire", 0)),
            "exchange": "ring",
        })
        dt_f, ok_f, c_f = run("fault", overlap=True, fault_wave=num_waves // 2)
        resorted = int(c_f.get("wave_runs_resorted", 0))
        frac = resorted / total_runs
        rows.append({
            "metric": f"external_wave_fault_drill_{_nlabel(n)}",
            "value": round(n / dt_f, 1),
            "unit": "keys/sec",
            "bit_identical": bool(ok_f),
            "over_hbm_factor": num_waves,
            "num_waves": num_waves,
            "runs_resorted": resorted,
            "resume_fraction": round(frac, 4),
            "exchange": "ring",
        })
        ok = (ok_seq and ok_pipe and ok_f and 0 < resorted
              and frac <= 1.0 / num_waves + 1.0 / total_runs)
    for row in rows:
        _emit(row)
    _write_journal(journal, args)
    return 0 if ok else 1


def _bench_analyze_smoke(args, cfg: SortConfig) -> int:
    """``--analyze-smoke``: the introspection plane's own price.

    The same ring sort with and without the always-on plane (the journal
    and the first-call ledger's drain) attached, in turns rep by rep
    (where the reference runs the arms one after the other), and one line
    whose ``overhead_frac`` is the measured cost of observing: under 5%
    from 2^20 keys up is the contract the exit code enforces (below that a
    sort is short enough that the host's jitter, not the journal, decides
    the A/B).  The same run exercises the analyzer end to end: a zipf ring
    sort's journal must give a skew ratio above the uniform sort's, and
    the verdict's dominant phase rides along.  The memory tap is opt in
    (each snapshot costs a walk of the allocator's state), so it rides the
    verdict run, outside the timed A/B.
    """
    from dsort_tpu_torch.data.ingest import gen_uniform, gen_zipf
    from dsort_tpu_torch.obs.analyze import analyze_records
    from dsort_tpu_torch.obs.prof import MemWatch
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.utils.events import EventLog

    mesh = _mesh(args, cfg)
    _needs(mesh.num_workers, 2, "--analyze-smoke",
           "a multi-worker mesh (the skew report rides the ring plan)")
    ss = SampleSort(mesh, JobConfig(key_dtype=np.int64, local_kernel=cfg.job.local_kernel))
    n = args.n
    uni = gen_uniform(n, dtype=np.int64, seed=0)
    zipf = gen_zipf(n, a=1.3, seed=4)

    ss.sort(uni, exchange="ring")  # warm both plans
    ss.sort(zipf, exchange="ring")
    uni_journal = EventLog()
    bare, observed = [], []
    for i in range(args.reps):
        # The two arms in turns (A B, B A, ...): drift on the host falls on
        # both alike, and each arm keeps its minimum.
        for journal in ((None, uni_journal) if i % 2 == 0 else (uni_journal, None)):
            m = Metrics(journal=journal)
            t0 = time.perf_counter()
            ss.sort(uni, metrics=m, exchange="ring")
            (bare if journal is None else observed).append(time.perf_counter() - t0)
    bare_s, obs_s = float(min(bare)), float(min(observed))
    overhead = (obs_s - bare_s) / bare_s
    zipf_journal = EventLog()
    mz = Metrics(journal=zipf_journal)
    MemWatch().attach(mz)
    ss.sort(zipf, metrics=mz, exchange="ring")
    vz = analyze_records([e.to_dict() for e in zipf_journal.events()])
    vu = analyze_records([e.to_dict() for e in uni_journal.events()])
    skew_z = (vz.get("skew") or {}).get("max_mean_ratio", 0.0)
    skew_u = (vu.get("skew") or {}).get("max_mean_ratio", 0.0)
    if getattr(args, "journal", None):
        zipf_journal.flush_jsonl(args.journal)
    overhead_ok = overhead < 0.05 or n < (1 << 20)
    ok = overhead_ok and skew_u > 0 and skew_z > skew_u
    _emit({
        "metric": "analyze_overhead_1M" if n == 1 << 20 else f"analyze_overhead_{n}_keys",
        "value": round(max(overhead, 0.0), 4),
        "unit": "frac",
        "overhead_frac": round(overhead, 4),
        "bare_keys_per_sec": round(n / bare_s, 1),
        "journaled_keys_per_sec": round(n / obs_s, 1),
        "dominant_phase": str(vz.get("dominant_phase")),
        "skew_ratio_zipf": round(skew_z, 3),
        "skew_ratio_uniform": round(skew_u, 3),
        "hbm_watermark_bytes": int((vz.get("hbm") or {}).get("bytes_in_use", 0)),
        "introspection_ok": ok,
    })
    return 0 if ok else 1


#: The standalone modes, each after every flag it refuses (see `_MODES`).
_RUNNERS = {
    "exchange_ab": _bench_exchange_ab,
    "serve_mixed": _bench_serve_mixed,
    "analyze_smoke": _bench_analyze_smoke,
    "external_wave": _bench_external_wave,
    "fleet_mixed": _bench_fleet_mixed,
    "coded_ab": _bench_coded_ab,
    "autotune_ab": _bench_autotune_ab,
    "hier_ab": _bench_hier_ab,
    "coded_v2_ab": _bench_coded_v2_ab,
}


def cmd_bench(args) -> int:
    from dsort_tpu_torch.data.ingest import gen_uniform

    if args.reps < 1:
        raise SystemExit("--reps must be >= 1")
    given = [m for m in _MODES if getattr(args, m, False)]
    if given and given[-1] in _RUNNERS:
        mode = given[-1]
        if len(given) > 1:
            flag = "--" + mode.replace("_", "-")
            raise SystemExit(
                f"{flag} is its own benchmark: run it as a separate invocation"
            )
        return _RUNNERS[mode](args, _load_config(args))
    if args.suite and args.device_resident:
        # The ladder has its own lines: dropping one of two explicit flags
        # would leave out lines the caller asked for.
        raise SystemExit(
            "--suite and --device-resident are separate benchmarks: run them as two "
            "invocations"
        )
    if args.suite:
        return _bench_suite(args)
    cfg = _load_config(args)
    if args.device_resident:
        if args.mode != "spmd":
            raise SystemExit("--device-resident requires --mode spmd")
        return _bench_device_resident(args, cfg)
    sorter = _make_sorter(cfg.job, args.mode, _workers(cfg), args.device)
    data = gen_uniform(args.n, dtype=np.dtype(cfg.job.key_dtype), seed=0)
    journal = _open_journal(args)
    sorter(data, Metrics())  # warm: the kernels' first calls
    times = []
    try:
        for _ in range(args.reps):
            m = Metrics(journal=journal)
            _maybe_memwatch(args, m)
            t0 = time.perf_counter()
            sorter(data, m)
            times.append(time.perf_counter() - t0)
    finally:
        # A rep that fails must not lose the journal of the reps before it.
        _write_journal(journal, args)
    dt = float(min(times))
    _emit({
        "metric": f"sort_throughput_{np.dtype(cfg.job.key_dtype)}_{args.n}_keys_{args.mode}",
        "value": round(args.n / dt, 1),
        "unit": "keys/sec",
        "vs_baseline": round(args.n / dt / _REF_KEYS_PER_SEC, 2),
    })
    return 0
