"""The port's profiling hooks (`dsort_tpu_torch.utils.tracing`) and ``cli
run --profile-dir``, on the CPU: the capture is a Chrome trace holding each
phase of the job as a ``dsort:<phase>`` range, as the JAX package's
``jax.profiler`` capture holds its ``dsort:<phase>`` annotations; off-capture
the hooks cost nothing and change nothing."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from dsort_tpu_torch import cli
from dsort_tpu_torch.utils import tracing
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer


def _ranges(trace_dir, tids=None) -> set:
    """The ``dsort:`` range names of the Chrome trace in ``trace_dir``; with
    ``tids``, only those of the threads of those native ids.  A capture
    records every thread of the process, so a test that checks what its own
    threads recorded reads them alone: a thread an earlier test left behind
    may run a phase meanwhile."""
    with open(os.path.join(trace_dir, tracing.TRACE_NAME), encoding="utf-8") as f:
        trace = json.load(f)
    return {
        e["name"] for e in trace["traceEvents"]
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("dsort:")
        and (tids is None or e.get("tid") in tids)
    }


def _journal_types(path) -> list:
    """The journal's event types, less ``variant_compiled``: the first-call
    ledger is process-wide, so only the first run in a process journals
    its compile."""
    with open(path, encoding="utf-8") as f:
        types = [json.loads(line)["type"] for line in f]
    return [t for t in types if t != "variant_compiled"]


def test_profile_trace_none_is_a_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("profiled without a directory")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with tracing.profile_trace(None):
        pass
    with tracing.profile_trace(""):
        pass


def test_annotate_records_nothing_off_capture(monkeypatch):
    """Off-capture a phase enters no profiler range at all: the phases'
    launch counts and walls are what they were before the hooks."""
    def refuse(name):
        raise AssertionError(f"range {name} entered off-capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.annotate("dsort:x"):
        pass
    m = Metrics()
    with PhaseTimer(m).phase("partition"):
        pass
    assert "partition" in m.phase_s


def test_annotate_and_phases_propagate_body_exceptions(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with tracing.annotate("dsort:x"):
            raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        with tracing.profile_trace(str(tmp_path / "t")):
            with PhaseTimer(Metrics()).phase("p"):
                raise RuntimeError("boom")
    # The failed region's trace is written too, with its phase.
    assert _ranges(tmp_path / "t", {threading.get_native_id()}) == {"dsort:p"}


def test_profile_trace_captures_phases_of_threads_started_under_it(tmp_path):
    tids = {threading.get_native_id()}

    def work():
        tids.add(threading.get_native_id())
        timer = PhaseTimer(Metrics())
        with timer.phase("spmd_sort"):
            torch.sort(torch.arange(1000, 0, -1))

    with tracing.profile_trace(str(tmp_path)):
        with PhaseTimer(Metrics()).phase("partition"):
            pass
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert len(tids) == 2
    assert _ranges(tmp_path, tids) == {"dsort:partition", "dsort:spmd_sort"}


@pytest.fixture(scope="module")
def keys_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    path = d / "in.txt"
    x = np.random.default_rng(23).integers(-10**6, 10**6, 20_000)
    np.savetxt(path, x, fmt="%d")
    return path, np.sort(x)


@pytest.mark.parametrize("route,extra,phases", [
    ("fused", [], {"dsort:partition", "dsort:local_sort", "dsort:assemble"}),
    # A checkpointed spmd job skips the fused route: the scheduler runs it.
    ("scheduler", ["--checkpoint-dir", "ck"],
     {"dsort:partition", "dsort:spmd_sort", "dsort:assemble"}),
])
def test_cli_run_profile_dir_traces_the_job_phases(
    keys_file, tmp_path, monkeypatch, route, extra, phases
):
    """``run --profile-dir`` writes a Chrome trace holding the job's phase
    ranges, and the same output and journal as the run without it; without
    the flag nothing is profiled."""
    monkeypatch.chdir(tmp_path)
    src, want = keys_file
    argv = ["run", str(src), "--device", "cpu", *extra]
    rc = cli.main(argv + ["-o", "a.txt", "--journal", "a.jsonl", "--profile-dir", "prof"])
    assert rc == 0
    assert np.array_equal(np.loadtxt("a.txt", dtype=np.int64), want)
    assert _ranges("prof") == phases

    def refuse(*a, **k):
        raise AssertionError("profiled without --profile-dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    if extra:  # a fresh store: the same job, not a resume
        argv = ["run", str(src), "--device", "cpu", "--checkpoint-dir", "ck2"]
    assert cli.main(argv + ["-o", "b.txt", "--journal", "b.jsonl"]) == 0
    assert np.array_equal(np.loadtxt("b.txt", dtype=np.int64), want)
    assert _journal_types("a.jsonl") == _journal_types("b.jsonl")
