"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m sortbench.run --workload W --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up makes the cell's pool of inputs
from ``--seed``, builds the program's entry and runs each input once (the
first run in a checkout builds the kernels there, and its result line
says so under ``setup_built``, so its set-up is recorded apart).  The window then runs
whole jobs, one client in a closed loop, cycling through the pool, until
``--seconds`` have passed; the job in flight is finished.  After the
window the plain reference checks a sample of the answers, drawn from the
seed.  ``--trace 1`` captures a few whole jobs after the window's first
with torch.profiler and reports the per-layer metrics; ``--trace 0``
reports the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with a trace
``breakdown``, the card's power limit, and last ``checks``: each number
compared beside its limit, which are also the last lines of standard
error).  Exit codes: 0 with a result; 2 without a card or without the
program; 3 when ``jax``, ``jaxlib``, ``flax`` or ``dsort_tpu`` was loaded;
4 when a captured job holds no kernel.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from sortbench import manifest, reference  # noqa: E402
from sortbench import trace as tracing  # noqa: E402
from sortbench.record import Job, Run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names the process must not hold once the window closes.
BANNED = ("jax", "jaxlib", "flax", "dsort_tpu")
CAPTURE_AFTER = 2  # window jobs before the traced sub-window
CAPTURE_JOBS = 3  # whole jobs the traced sub-window holds
ANSWER_BYTES = 4 << 30  # host bytes of answers kept for the comparison
MAX_ANSWERS = 64


class CaptureError(RuntimeError):
    """The traced sub-window did not capture what it must."""


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_T0 = process_age_s()


def banned_modules() -> list:
    """Banned top-level names in ``sys.modules``, compared whole:
    ``dsort_tpu_torch`` is not ``dsort_tpu``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(BANNED))


class Answers:
    """A sample of the window's answers drawn from the seed: a reservoir of
    at most ``k``, so each answer is as likely to be kept."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0x5EED]))

    def offer(self, pool_index: int, answer) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((pool_index, answer))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = (pool_index, answer)


def _items(kind: str, job_input) -> int:
    return len(job_input) if kind == "keys" else len(job_input[0])


def _card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"nvidia_smi": f"unreadable: {e}"}
    name, _, limit = out.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def builds_s() -> dict:
    """Seconds this process spent building the program's CUDA kernels and
    native runtime, by the program's own build modules: the first run in a
    checkout builds them, a later one loads what it built."""
    out = {}
    for part in ("ops", "runtime"):
        s = getattr(sys.modules.get(f"dsort_tpu_torch.{part}._build"), "last_build_s", None)
        if s is not None:
            out[part] = s
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             items: int | None = None, wrap=None, t0: float = _T0,
             age: float = _AGE_AT_T0) -> dict:
    """One run of ``cell``; returns its result object.  ``items`` shrinks
    the jobs and ``wrap(run, kind)`` replaces the entry's run (both for
    tests on the CPU); ``t0`` / ``age`` place the process's start."""
    import torch
    from torch.profiler import record_function

    from dsort_tpu_torch.utils.tracing import TRACE_NAME, profile_trace

    cuda = torch.device(device).type == "cuda"
    marks = {"imports": time.perf_counter()}
    entry = cell.entry()
    kind = entry.KIND
    readers = cell.readers(trace)
    run = entry.build(cell.config, device)
    if wrap is not None:
        run = wrap(run, kind)
    marks["entry"] = time.perf_counter()
    pool = cell.generator().make_pool(cell.traffic, cell.config, seed, device, items)
    marks["inputs"] = time.perf_counter()
    card = _card() if cuda else {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    per_answer = _items(kind, pool[0]) * int(cell.config["item_bytes"])
    answers = Answers(max(1, min(MAX_ANSWERS, ANSWER_BYTES // per_answer)), seed)
    jobs: list = []
    with tempfile.TemporaryDirectory(prefix="sortbench-") as tmp:
        if trace:
            # A process's first capture pays the profiler's start-up: pay it here.
            with profile_trace(os.path.join(tmp, "prime")):
                torch.ones(8, device=device).sum().item()
        marks["card"] = time.perf_counter()
        for job_input in pool:
            run(job_input)
        if cuda:
            torch.cuda.synchronize()
        start = marks["warm"] = time.perf_counter()
        setup_s = start - t0 + age
        last_captured = CAPTURE_AFTER + CAPTURE_JOBS - 1
        with contextlib.ExitStack() as capture:
            i = 0
            while i == 0 or time.perf_counter() - start < seconds or (trace and i <= last_captured):
                captured = trace and CAPTURE_AFTER <= i <= last_captured
                if captured and i == CAPTURE_AFTER:
                    capture.enter_context(profile_trace(os.path.join(tmp, "window")))
                job_input = pool[i % len(pool)]
                with record_function(tracing.JOB_RANGE) if captured else contextlib.nullcontext():
                    t_a = time.perf_counter()
                    try:
                        out, metrics = run(job_input)
                        error = None
                    except Exception as e:  # a failed job is counted, and the window goes on
                        traceback.print_exc()
                        out, metrics, error = None, None, f"{type(e).__name__}: {e}"
                    t_b = time.perf_counter()
                jobs.append(Job(
                    t_a, t_b, _items(kind, job_input),
                    dict(metrics.phase_s) if metrics else {},
                    dict(metrics.counters) if metrics else {}, captured, error,
                ))
                if error is None:
                    answers.offer(i % len(pool), out)
                if captured and i == last_captured:
                    capture.close()
                i += 1
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        kind_name = torch.cuda.get_device_name(0) if cuda else "cpu"
        del run, out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        tr = tracing.read(os.path.join(tmp, "window", TRACE_NAME)) if trace else None
    if tr is not None:
        if len(tr.jobs) != CAPTURE_JOBS:
            raise CaptureError(f"the trace holds {len(tr.jobs)} job ranges, not {CAPTURE_JOBS}")
        empty = tr.jobs_without_kernel() if cuda else []
        if empty:
            raise CaptureError(f"captured job(s) {empty} of {CAPTURE_JOBS} hold no kernel")

    refs: dict = {}
    wrong = 0
    for pool_index, answer in answers.kept:
        if pool_index not in refs:
            refs[pool_index] = reference.reference(kind, pool[pool_index], cell.config)
        wrong += reference.mismatched(kind, answer, refs[pool_index], cell.config)
    failed = sum(j.error is not None for j in jobs)
    checks = {
        f"mismatched_{kind}": {"value": wrong, "limit": 0},
        "failed_jobs": {"value": failed, "limit": 0},
    }
    record = Run(cell.config, kind_name, setup_s, start, jobs, tr)
    values = {}
    for m in cell.metrics(trace):
        v = readers[m["name"]].read(record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(answers.kept) and all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(jobs),
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if cuda else "cpu", "kind": kind_name, "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_by_phase()}
    result["card"] = card
    # Where set-up went: the process's start to each mark, by the mark's stage.
    stamps = [("imports", t0 - age)] + list(marks.items())
    result["setup_parts_s"] = {b[0]: b[1] - a[1] for a, b in zip(stamps, stamps[1:])}
    # A run that built the program is recorded apart: its set-up holds the build.
    result["setup_built_s"] = builds_s()
    result["setup_built"] = bool(result["setup_built_s"])
    result["program_counters"] = {
        k: sum(j.counters.get(k, 0) for j in record.steady)
        for k in sorted({k for j in record.steady for k in j.counters})
    }
    result["job_ms"] = [round(1e3 * (j.end - j.start), 3) for j in jobs]
    result["answers_compared"] = len(answers.kept)
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sortbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sortbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import dsort_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"sortbench: the program is missing: {e}", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except CaptureError as e:
        print(f"sortbench: {e}", file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"sortbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
