"""``cli run``'s routing and the fused small-job route against the JAX CLI's.

Both packages' ``_make_sorter(..., "spmd")`` on the same seeded inputs: a
job under 2^20 keys takes the fused route (``fused_small_jobs``), a job of
2^20 goes through the SPMD scheduler; a device error or a lapsed wait on
the fused route falls back to the scheduler (``fused_fallbacks``), a
program error propagates; and the three latches (the warm wedge, the cold
lane-stuck ceiling with its expiry, the fail-slow backstop) close and
reopen the route alike.  The JAX side's device errors are XLA statuses,
the port's CUDA ones.  Compared: the output bits, the fused route's
counters, and the order of its events (``job_start`` with its mode,
``fused_fallback``, ``job_done``).  Then ``cli run --mode spmd|taskpool|
local`` against ``dsort run --mode ...``: byte-identical output files and
the same journal event order.

The drills run with a cold fused wait of 1.6 s and a warm one of 0.6 s
(the reference's drills: 2.6 s and 0.6 s), every stall at least 0.5 s
away from the wait it tests.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from dsort_tpu import cli as jcli
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.config import SortConfig
from dsort_tpu.data.ingest import gen_uniform
from dsort_tpu.models import pipelines as jpl
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli as tcli
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.models import pipelines as tpl
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

FUSED = dict(settle_delay_s=0.01, heartbeat_timeout_s=0.3, compile_grace_s=1.0,
             exec_allowance_floor_s=0.3, exec_allowance_keys_per_s=1e9,
             max_transient_retries=5)
ROUTE_EVENTS = ("job_start", "fused_fallback", "job_done")


def _xla_error(msg):
    from jax.errors import JaxRuntimeError

    return JaxRuntimeError(msg)


class Route:
    """One package's CLI module, pipelines module and spmd sorter."""

    def __init__(self, port: bool, monkeypatch, job_kw=FUSED):
        self.port, self.mp = port, monkeypatch
        self.cli, self.pl = (tcli, tpl) if port else (jcli, jpl)
        self.job = JaxJobConfig(**job_kw)
        self.device_error = (RuntimeError("CUDA error: unspecified launch failure") if port
                             else _xla_error("UNAVAILABLE: device tunnel dropped"))

    def sorter(self):
        if self.port:
            return tcli._make_sorter(JobConfig.from_dict(dataclasses.asdict(self.job)),
                                     "spmd", 8, "cpu")
        return jcli._make_sorter(SortConfig(job=self.job), "spmd")

    def fused(self, fake):
        """Route the sorter's fused calls through ``fake(real, data, kernel,
        metrics, **kw)``; takes effect for sorters built after it."""
        real = self.pl.fused_sort_small

        def wrapper(data, kernel="auto", metrics=None, **kw):
            return fake(real, data, kernel, metrics, **kw)

        self.mp.setattr(self.pl, "fused_sort_small", wrapper)

    def metrics(self):
        return Metrics(journal=EventLog()) if self.port else JaxMetrics(journal=JaxEventLog())


def _route(m) -> list:
    """The fused route's events in order: (type, mode) for job_start."""
    return [(e.type, e.fields.get("mode")) for e in m.journal.events() if e.type in ROUTE_EVENTS]


def _both(monkeypatch, drill, job_kw=FUSED, together=False):
    """``drill(route)`` for the JAX package, then the port (``together``:
    at once, on two threads — for drills that mostly sleep); each returns a
    list of ``(label, output, metrics)``.  Outputs equal numpy's and each
    other's; counters and route events equal label by label."""
    routes = [Route(port, monkeypatch, job_kw) for port in (False, True)]
    if together:
        runs, errors = [None, None], []

        def go(i):
            try:
                runs[i] = drill(routes[i])
            except BaseException as e:  # re-raised on the test's thread
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
    else:
        runs = [drill(route) for route in routes]
    for (label, jout, jm), (plabel, tout, tm) in zip(*runs):
        assert label == plabel
        if jout is not None:
            assert np.array_equal(tout, jout) and tout.dtype == jout.dtype
        for k in ("fused_small_jobs", "fused_fallbacks"):
            assert tm.counters.get(k, 0) == jm.counters.get(k, 0), (label, k)
        assert _route(tm) == _route(jm), label
    return runs[1]


def _run(route, sorter, label, data, check=True):
    m = route.metrics()
    out = sorter(data, m)
    if check:
        assert np.array_equal(out, np.sort(data)), label
    return label, out, m


def test_cli_spmd_mode_routes_small_jobs_fused(monkeypatch):
    rng = np.random.default_rng(8)
    small = rng.integers(0, 10**6, 16_384).astype(np.int32)
    big = rng.integers(0, 10**6, 1 << 20).astype(np.int32)

    def drill(route):
        sorter = route.sorter()
        return [_run(route, sorter, "small", small), _run(route, sorter, "big", big)]

    (_, _, m_small), (_, _, m_big) = _both(monkeypatch, drill)
    assert m_small.counters["fused_small_jobs"] == 1 and "fused_small_jobs" not in m_big.counters
    assert _route(m_small) == [("job_start", "fused"), ("job_done", None)]
    assert _route(m_big) == [("job_start", "spmd"), ("job_done", None)]
    assert m_big.journal.types().count("attempt_start") == 1


def test_cli_spmd_fused_falls_back_to_scheduler_on_device_error(monkeypatch):
    """A device error on the fused route retries on the SPMD scheduler; a
    program error propagates with no fallback."""
    small = np.random.default_rng(11).integers(0, 10**6, 10_000).astype(np.int32)

    def drill(route):
        def dying(real, data, kernel, metrics, **kw):
            raise route.device_error

        route.fused(dying)
        return [_run(route, route.sorter(), "device error", small)]

    [(_, _, m)] = _both(monkeypatch, drill)
    assert m.counters["fused_fallbacks"] == 1 and "fused_small_jobs" not in m.counters
    assert _route(m) == [("job_start", "fused"), ("fused_fallback", None),
                         ("job_start", "spmd"), ("job_done", None)]
    for port in (False, True):
        route = Route(port, monkeypatch)

        def broken(real, data, kernel, metrics, **kw):
            raise ValueError("INVALID_ARGUMENT: a genuine program bug")

        route.fused(broken)
        m = route.metrics()
        with pytest.raises(ValueError, match="genuine program bug"):
            route.sorter()(small, m)
        assert _route(m) == [("job_start", "fused")]


def test_fused_small_job_hang_falls_back_to_scheduler(monkeypatch):
    """A hang on the fused route lapses at the cold wait and falls back."""
    data = gen_uniform(20_000, seed=93)

    def drill(route):
        state = {"first": True}

        def hang_once(real, data, kernel, metrics, **kw):
            if state["first"]:
                state["first"] = False
                time.sleep(30.0)
            return real(data, kernel, metrics, **kw)

        route.fused(hang_once)
        t0 = time.monotonic()
        run = _run(route, route.sorter(), "hang", data)
        assert time.monotonic() - t0 < 15.0
        return [run]

    [(_, _, m)] = _both(monkeypatch, drill)
    assert m.counters["fused_fallbacks"] == 1 and "fused_small_jobs" not in m.counters


def test_fused_path_latched_off_after_wedge(monkeypatch):
    """A wedge on a warm bucket latches the route off for good: the third
    job goes straight to the scheduler, with no fused attempt."""
    data = gen_uniform(10_000, seed=96)

    def drill(route):
        calls = {"n": 0}

        def hang_after_first(real, data, kernel, metrics, **kw):
            calls["n"] += 1
            if calls["n"] > 1:
                time.sleep(30.0)
            return real(data, kernel, metrics, **kw)

        route.fused(hang_after_first)
        sorter = route.sorter()
        runs = [_run(route, sorter, "warm", data), _run(route, sorter, "wedge", data)]
        t0 = time.monotonic()
        runs.append(_run(route, sorter, "latched", data))
        assert time.monotonic() - t0 < 2.0 and calls["n"] == 2
        return runs

    runs = _both(monkeypatch, drill)
    assert [r[2].counters.get("fused_small_jobs", 0) for r in runs] == [1, 0, 0]
    assert [r[2].counters.get("fused_fallbacks", 0) for r in runs] == [0, 1, 0]
    assert _route(runs[2][2]) == [("job_start", "spmd"), ("job_done", None)]


def test_fused_cold_lapse_does_not_latch(monkeypatch):
    """A cold lapse (a slow first build) falls back for that job only: once
    the stall has drained, the next job takes the fused route again."""
    data = gen_uniform(10_000, seed=97)

    def drill(route):
        state = {"n": 0}

        def stall_once(real, data, kernel, metrics, **kw):
            state["n"] += 1
            if state["n"] == 1:
                time.sleep(2.2)  # past the 1.6 s cold wait
            return real(data, kernel, metrics, **kw)

        route.fused(stall_once)
        sorter = route.sorter()
        first = _run(route, sorter, "cold lapse", data)
        time.sleep(1.0)  # the stalled attempt drains off the lane
        return [first, _run(route, sorter, "reopened", data)]

    runs = _both(monkeypatch, drill, together=True)
    assert runs[0][2].counters["fused_fallbacks"] == 1
    assert runs[1][2].counters["fused_small_jobs"] == 1


def test_fused_repeated_cold_lapses_latch(monkeypatch):
    """A card wedged on first contact: cold lapses alone never latch, the
    lane stuck past the ceiling does; the cold latch expires, and the retry
    re-latches on its one lapse while the lane is still stuck."""
    data = gen_uniform(10_000, seed=98)

    def drill(route):
        calls = {"n": 0}

        def wedge(real, data, kernel, metrics, **kw):
            calls["n"] += 1
            time.sleep(120.0)  # wedged from the first contact

        route.fused(wedge)
        sorter = route.sorter()
        mp = route.mp
        mp.setattr(route.cli, "FUSED_COLD_WEDGE_CEILING_S", 1e9)
        runs = [_run(route, sorter, f"lapse {i}", data) for i in range(2)]
        assert calls["n"] == 1  # the second attempt queued behind the stuck lane
        mp.setattr(route.cli, "FUSED_COLD_WEDGE_CEILING_S", 2.0)
        runs.append(_run(route, sorter, "ceiling", data))
        t0 = time.monotonic()
        runs.append(_run(route, sorter, "latched", data))
        assert time.monotonic() - t0 < 2.0
        mp.setattr(route.cli, "FUSED_COLD_RETRY_S", 0.3)
        time.sleep(0.4)
        runs.append(_run(route, sorter, "expired retry", data))
        mp.setattr(route.cli, "FUSED_COLD_RETRY_S", 1800.0)
        t1 = time.monotonic()
        runs.append(_run(route, sorter, "re-latched", data))
        assert time.monotonic() - t1 < 2.0
        return runs

    runs = _both(monkeypatch, drill, together=True)
    assert [r[2].counters.get("fused_fallbacks", 0) for r in runs] == [1, 1, 1, 0, 1, 0]


def test_fused_fail_slow_backstop_latches(monkeypatch):
    """A fail-slow card (each fused call ends after the wait lapsed, so the
    lane drains and the ceiling never trips): the backstop latches after 3
    consecutive cold lapses, and the retry after expiry re-latches at once."""
    data = gen_uniform(10_000, seed=99)

    def drill(route):
        def fail_slow(real, data, kernel, metrics, **kw):
            time.sleep(2.2)  # past the 1.6 s cold wait, then drains

        route.fused(fail_slow)
        mp = route.mp
        mp.setattr(route.cli, "FUSED_COLD_LAPSE_BACKSTOP", 3)
        sorter = route.sorter()
        runs = [_run(route, sorter, f"lapse {i}", data) for i in range(3)]
        t0 = time.monotonic()
        runs.append(_run(route, sorter, "latched", data))
        assert time.monotonic() - t0 < 2.0
        mp.setattr(route.cli, "FUSED_COLD_RETRY_S", 0.3)
        time.sleep(0.4)
        runs.append(_run(route, sorter, "expired retry", data))
        mp.setattr(route.cli, "FUSED_COLD_RETRY_S", 1800.0)
        t1 = time.monotonic()
        runs.append(_run(route, sorter, "re-latched", data))
        assert time.monotonic() - t1 < 2.0
        return runs

    runs = _both(monkeypatch, drill, together=True)
    assert [r[2].counters.get("fused_fallbacks", 0) for r in runs] == [1, 1, 1, 0, 1, 0]


def test_fused_route_constants_are_the_references():
    for name in ("FUSED_COLD_WEDGE_CEILING_S", "FUSED_COLD_RETRY_S", "FUSED_COLD_LAPSE_BACKSTOP"):
        assert getattr(tcli, name) == getattr(jcli, name)


@pytest.mark.parametrize("mode", ["spmd", "taskpool", "local"])
def test_cli_run_modes_match_jax(tmp_path, mode):
    """``cli run --mode M`` and ``dsort run --mode M`` write byte-identical
    files and journals with the same event order (the reference's compile
    ledger events, ``variant_compiled``, are not ported)."""
    x = gen_uniform(7_000, seed=31)
    src = tmp_path / "in.txt"
    src.write_text("# header\n" + "".join(f"{v}\n" for v in x.tolist()))
    ref, out, jref, jout = (tmp_path / n for n in ("ref.txt", "out.txt", "r.jsonl", "o.jsonl"))
    assert jcli.main(["run", str(src), "-o", str(ref), "--mode", mode,
                      "--journal", str(jref)]) == 0
    assert tcli.main(["run", str(src), "-o", str(out), "--mode", mode, "--device", "cpu",
                      "--journal", str(jout)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert out.read_bytes() == "".join(f"{v}\n" for v in np.sort(x).tolist()).encode()
    want = [r for r in EventLog.read_jsonl(str(jref)) if r["type"] != "variant_compiled"]
    got = EventLog.read_jsonl(str(jout))
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert [r.get("phase") for r in got] == [r.get("phase") for r in want]
    assert got[0]["mode"] == want[0]["mode"] == {"spmd": "fused"}.get(mode, mode)
    assert got[-2]["counters"].get("fused_small_jobs") == want[-2]["counters"].get(
        "fused_small_jobs")
    if mode == "taskpool":
        assert (sorted(r["worker"] for r in got if r["type"] == "attempt_start")
                == sorted(r["worker"] for r in want if r["type"] == "attempt_start"))


def test_cli_run_mode_local_and_taskpool_need_a_device(monkeypatch, tmp_path):
    import os

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("taskpool", "local"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["run", os.devnull, "--mode", mode])
