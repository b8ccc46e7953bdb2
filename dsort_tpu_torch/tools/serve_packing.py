"""What slice packing buys a served small job on one card, and where its time goes.

    python3 -m dsort_tpu_torch.tools.serve_packing [--reps 6]

Needs one GPU (exits 2 without one).  Prints the card's name and power
limit, then:

1. `serve.SortService` windows of 12 int32 jobs (6 of 2^19 keys, 6 of
   2^18, the fused route) on 1, 2, 4 and 8 slices (``slice_devices`` 8,
   4, 2, 1), each service prewarmed: the window's median over ``--reps``
   windows after one untimed window, and the median of a job's
   ``local_sort`` phase (its upload, sort and download on the slice's
   stream); at Python's default thread switch interval (5 ms) and at
   10 us, which tells GIL contention from device contention;
2. the same 48 jobs without the service, on 1 thread and on 8 threads
   each with a stream of its own: ``pageable`` (the service's copies:
   ``tensor.to(card)`` and ``.cpu()`` of pageable numpy memory),
   ``pinned`` (a pinned staging buffer a thread, non-blocking copies, one
   ``torch.cuda.Event(blocking=True)`` waited before the result is read)
   and ``pageable_event`` (pageable copies, a blocking event before the
   download); the 48 jobs' wall and a job's median.

Every result is held to numpy's sort.  Times are host wall times around
work that ends in a synchronisation.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time

import numpy as np
import torch


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _median(xs) -> float:
    return round(float(np.median(xs)), 3)


def _jobs(seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int32)
    return [rng.integers(info.min, info.max, 1 << (19 - i % 2), dtype=np.int32, endpoint=True)
            for i in range(12)]


def service_windows(jobs, reps: int, card: str) -> None:
    from dsort_tpu_torch.config import JobConfig, ServeConfig
    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.utils.events import EventLog

    refs = [np.sort(d) for d in jobs]
    for switch in (0.005, 1e-5):
        sys.setswitchinterval(switch)
        for slice_devices in (8, 4, 2, 1):
            journal = EventLog()
            svc = SortService(8, job=JobConfig(settle_delay_s=0.01),
                              serve=ServeConfig(slice_devices=slice_devices), journal=journal)
            svc.prewarm(sizes=[1 << 18, 1 << 19])
            walls = []
            for rep in range(reps + 1):
                n0 = len(journal)
                t0 = time.perf_counter()
                tickets = [svc.submit(d)[1] for d in jobs]
                outs = [t.result() for t in tickets]
                walls.append((time.perf_counter() - t0) * 1e3)
                if not all(np.array_equal(o, r) for o, r in zip(outs, refs)):
                    raise AssertionError("a served job differs from numpy")
            local = [e.fields["seconds"] * 1e3 for e in journal.events()[n0:]
                     if e.type == "phase_end" and e.fields["phase"] == "local_sort"]
            svc.shutdown()
            print(f"service, {8 // slice_devices} slice(s), switch interval {switch * 1e3:g} ms: "
                  f"12 jobs in {_median(walls[1:])} ms (median of {reps}; "
                  f"{[round(w, 1) for w in walls[1:]]}), a job's local_sort {_median(local)} ms "
                  f"[{card}]", flush=True)
    sys.setswitchinterval(0.005)


def bare_threads(jobs, card: str) -> None:
    from dsort_tpu_torch.models.pipelines import _fused_small_fn, pad_for_fused, pad_rung

    dev = torch.device("cuda", torch.cuda.current_device())
    fns = {n: _fused_small_fn(pad_rung(n), "int32", "auto") for n in (1 << 18, 1 << 19)}
    bufs = [pad_for_fused(d) for d in jobs]
    refs = [np.sort(d) for d in jobs]

    def worker(idx, nthreads, variant, stream, out, barrier):
        pin_in = torch.empty(1 << 19, dtype=torch.int32).pin_memory()
        pin_out = torch.empty(1 << 19, dtype=torch.int32).pin_memory()
        times, got = [], []
        barrier.wait()
        for k in range(idx, 4 * len(jobs), nthreads):
            buf, n = bufs[k % 12], len(jobs[k % 12])
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                if variant == "pageable":
                    y = fns[n](torch.from_numpy(buf).to(dev), n).cpu().numpy()[:n]
                elif variant == "pinned":
                    pin_in[:n].copy_(torch.from_numpy(buf[:n]))
                    r = fns[n](pin_in[:n].to(dev, non_blocking=True), n)
                    pin_out[:n].copy_(r, non_blocking=True)
                    ev = torch.cuda.Event(blocking=True)
                    ev.record(stream)
                    ev.synchronize()
                    y = pin_out[:n].numpy()
                else:
                    r = fns[n](torch.from_numpy(buf).to(dev), n)
                    ev = torch.cuda.Event(blocking=True)
                    ev.record(stream)
                    ev.synchronize()
                    y = r.cpu().numpy()[:n]
            times.append((time.perf_counter() - t0) * 1e3)
            got.append((k % 12, y.copy()))
        out[idx] = (times, got)

    for variant in ("pageable", "pinned", "pageable_event"):
        for nthreads in (1, 8):
            streams = [torch.cuda.Stream(dev) for _ in range(nthreads)]
            for _ in range(2):  # the first pass warms the streams and buffers
                out: dict = {}
                barrier = threading.Barrier(nthreads + 1)
                threads = [threading.Thread(target=worker,
                                            args=(i, nthreads, variant, streams[i], out, barrier))
                           for i in range(nthreads)]
                for t in threads:
                    t.start()
                barrier.wait()
                t0 = time.perf_counter()
                for t in threads:
                    t.join()
                wall = (time.perf_counter() - t0) * 1e3
            per = [x for i in range(nthreads) for x in out[i][0]]
            for i in range(nthreads):
                for k, y in out[i][1]:
                    if not np.array_equal(y, refs[k]):
                        raise AssertionError(f"{variant}: a job differs from numpy")
            print(f"bare {variant}, {nthreads} thread(s): 48 jobs in {wall:.1f} ms, a job "
                  f"{_median(per)} ms (median) [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve_packing")
    ap.add_argument("--reps", type=int, default=6, help="timed windows a service")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_packing: no CUDA device available", file=sys.stderr)
        return 2
    from dsort_tpu_torch.ops import _build

    _build.build()
    _build.library()
    card = _card()
    print(card, flush=True)
    jobs = _jobs()
    service_windows(jobs, args.reps, card)
    bare_threads(jobs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
