"""The port's task-pool `Scheduler` against the JAX package's, drill by drill.

Each drill of the reference's task-pool fault suite runs through both
schedulers on the same `gen_uniform` / `gen_zipf` input: JAX's
``Scheduler(DeviceExecutor())`` over the 8 CPU devices and the port's
``Scheduler(DeviceExecutor(8, "cpu"))``, with the same `JobConfig`
(``from_dict``) and the same injected faults.  Compared: the output bits,
the dead workers, the named counters, and the scheduler's events — their
order by type, and each shard's attempts, deaths and reassignments.  The
reference's ``CANCELLED`` drills have no CUDA status: the port's
``transient`` branch is driven through the classifier's table instead.

Drills with a hang wait until both packages' lanes are idle before they
end, so the next drill's lanes start empty on both sides; each wait keeps
at least 0.5 s of slack on both sides of its lapse.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.scheduler import DeviceExecutor as JaxDeviceExecutor
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import JobFailedError as JaxJobFailedError
from dsort_tpu.scheduler import Scheduler as JaxScheduler
from dsort_tpu.scheduler import scheduler as jsched
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.scheduler import (
    DeviceExecutor,
    FaultInjector,
    JobFailedError,
    Scheduler,
    WorkerTable,
)
from dsort_tpu_torch.scheduler import fault
from dsort_tpu_torch.scheduler import scheduler as tsched
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

POOL_EVENTS = {"job_start", "attempt_start", "worker_dead", "reassign", "heartbeat_lapse",
               "transient_retry", "job_failed", "job_done"}
NAMED = ("reassignments", "heartbeat_timeouts", "cold_wait_retries", "device_runtime_errors",
         "transient_retries")
FAST = dict(settle_delay_s=0.01, heartbeat_timeout_s=5.0)


def _xla_error(msg):
    from jax.errors import JaxRuntimeError

    return JaxRuntimeError(msg)


class Side:
    """One package's task pool, injector, journal and metrics for a drill."""

    def __init__(self, port: bool, job_kw: dict):
        self.port = port
        jjob = JaxJobConfig(**job_kw)
        if port:
            self.inj = FaultInjector()
            self.sched = Scheduler(DeviceExecutor(8, "cpu", self.inj),
                                   JobConfig.from_dict(dataclasses.asdict(jjob)))
            self.new_metrics = lambda: Metrics(journal=EventLog())
            self.failed = JobFailedError
        else:
            self.inj = JaxFaultInjector()
            self.sched = JaxScheduler(JaxDeviceExecutor(injector=self.inj), jjob)
            self.new_metrics = lambda: JaxMetrics(journal=JaxEventLog())
            self.failed = JaxJobFailedError
        self.metrics = self.new_metrics()

    def run(self, data, metrics=None):
        return self.sched.run_job(data, metrics=metrics or self.metrics)

    def result(self, metrics=None):
        m = metrics or self.metrics
        events = [e for e in m.journal.events() if e.type in POOL_EVENTS]
        per_shard = sorted(
            (e.type, tuple(sorted((k, v) for k, v in e.fields.items()
                                  if k not in ("job", "tenant", "counters", "job_id"))))
            for e in events if e.type not in ("job_start", "job_done", "job_failed")
        )
        return {
            "dead": [w for w in range(8) if not self.sched.table.is_alive(w)],
            "counters": {k: m.counters.get(k, 0) for k in NAMED},
            "types": [e.type for e in events],
            "per_shard": per_shard,
        }


def _pair(job_kw=FAST):
    return Side(False, job_kw), Side(True, job_kw)


def _same(j, t, jax_out=None, port_out=None, jm=None, tm=None, racy=False):
    """Both sides' results equal; returns the port's.  ``racy``: the shard
    threads race for the same dead workers (every worker dead), so only the
    dead set and the job's first and last events are compared."""
    if jax_out is not None:
        assert port_out.dtype == jax_out.dtype
        assert np.array_equal(port_out.view(f"u{port_out.dtype.itemsize}"),
                              jax_out.view(f"u{jax_out.dtype.itemsize}"))
    got, want = t.result(tm), j.result(jm)
    assert got["dead"] == want["dead"]
    assert got["types"][0] == want["types"][0] == "job_start"
    assert got["types"][-1] == want["types"][-1]
    if not racy:
        assert got["counters"] == want["counters"]
        assert sorted(got["types"]) == sorted(want["types"])
        assert got["per_shard"] == want["per_shard"]
    return got


def _drain(workers, limit_s=20.0):
    """Wait until both packages' attempt lanes of ``workers`` are idle."""
    import jax

    lanes = [jsched._lane_for_device(jax.devices()[w]) for w in workers]
    lanes += [tsched._lane_for_device(tsched.resolve_device("cpu"), w) for w in workers]
    t0 = time.monotonic()
    while any(lane.stuck_for() > 0 or not lane._q.empty() for lane in lanes):
        assert time.monotonic() - t0 < limit_s, "an attempt lane stayed busy"
        time.sleep(0.02)
    time.sleep(0.05)


def test_healthy_job():
    data = gen_uniform(10_000, seed=1)
    j, t = _pair()
    got = _same(j, t, j.run(data), t.run(data))
    assert got["types"].count("attempt_start") == 8 and got["types"][-1] == "job_done"
    assert got["dead"] == []


def test_one_worker_killed_before_dispatch():
    """The kill -9 experiment: worker 3 killed before dispatch; the job
    completes with one reassignment, and the journal reads worker_dead ->
    reassign -> job_done, with the final counters on job_done."""
    data = gen_uniform(20_000, seed=2)
    j, t = _pair()
    for s in (j, t):
        s.inj.kill(3)
    got = _same(j, t, j.run(data), t.run(data))
    types = got["types"]
    assert got["counters"]["reassignments"] >= 1 and 3 in got["dead"]
    assert types[-1] == "job_done"
    assert types.index("worker_dead") < types.index("reassign") < types.index("job_done")
    assert t.metrics.journal.events()[-1].fields["counters"]["reassignments"] >= 1
    assert ("worker_dead", (("stage", "send"), ("worker", 3))) in got["per_shard"]


def test_transient_failure_during_recv():
    data = gen_uniform(5_000, seed=3)
    j, t = _pair()
    for s in (j, t):
        s.inj.fail_once(2, "recv")
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["reassignments"] == 1 and got["dead"] == [2]
    assert ("reassign", (("frm", 2), ("shard", 2), ("to", 0))) in got["per_shard"]


def test_multiple_workers_killed():
    data = gen_uniform(30_000, seed=4)
    j, t = _pair()
    for s in (j, t):
        for w in (1, 3, 5, 7):
            s.inj.kill(w)
    got = _same(j, t, j.run(data), t.run(data))
    assert got["dead"] == [1, 3, 5, 7] and got["counters"]["reassignments"] == 4


def test_all_workers_dead_fails_cleanly_and_cluster_survives():
    data = gen_uniform(1_000, seed=5)
    j, t = _pair()
    for s in (j, t):
        for w in range(8):
            s.inj.kill(w)
        with pytest.raises(s.failed, match="no live workers remain"):
            s.run(data)
    got = _same(j, t, racy=True)
    assert got["dead"] == list(range(8)) and got["types"][-1] == "job_failed"
    assert got["counters"]["reassignments"] >= 8
    # Per-job optimistic revival: the next job on the same scheduler succeeds.
    outs, ms = [], []
    for s in (j, t):
        for w in range(8):
            s.inj.revive(w)
        ms.append(s.new_metrics())
        outs.append(s.run(data, ms[-1]))
    _same(j, t, *outs, *ms)
    assert np.array_equal(outs[1], np.sort(data))


def test_taskpool_zipf_skew_with_kill():
    data = gen_zipf(60_000, a=1.3, seed=14)
    j, t = _pair()
    for s in (j, t):
        s.inj.kill(2)
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["reassignments"] >= 1


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "float16",
                                   "uint32", "float32", "int64"])
def test_taskpool_key_dtypes(dtype):
    """Narrow, unsigned and float keys (NaN included) through both pools,
    with worker 5 killed."""
    rng = np.random.default_rng(33)
    if dtype.startswith("float"):
        data = rng.standard_normal(6_000).astype(dtype)
        data[::37] = np.nan
        data[1::37] = -0.0
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 6_000, endpoint=True).astype(dtype)
    j, t = _pair()
    for s in (j, t):
        s.inj.kill(5)
    _same(j, t, j.run(data), t.run(data))


@pytest.mark.parametrize("kernel", ["block", "pallas"])
def test_taskpool_block_and_pallas_kernels_reassign(kernel):
    """The block and tile kernels' plain versions on the port's workers,
    8-bit keys widened for them, with a reassignment: the bits, counters
    and events of the JAX pool (on ``lax``: its Pallas kernels would run
    interpreted once per device)."""
    data = np.random.default_rng(35).integers(-128, 128, 4_000).astype(np.int8)
    j = Side(False, FAST)
    t = Side(True, dict(FAST, local_kernel=kernel))
    for s in (j, t):
        s.inj.fail_once(6, "sort")
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["reassignments"] == 1 and t.sched.executor.kernel == kernel


def _flaky(monkeypatch, side, worker, err, times=1):
    """``sort_shard`` raises ``err`` on ``worker``'s first ``times`` calls."""
    real = side.sched.executor.sort_shard
    left = {"n": times}

    def flaky(w, data):
        if w == worker and left["n"] > 0:
            left["n"] -= 1
            raise err
        return real(w, data)

    monkeypatch.setattr(side.sched.executor, "sort_shard", flaky)


def test_taskpool_real_runtime_error_reassigns(monkeypatch):
    """A device error from a worker (a CUDA one on the port) reassigns like
    an injected failure."""
    data = gen_uniform(10_000, seed=7)
    j, t = _pair()
    _flaky(monkeypatch, j, 1, _xla_error("INTERNAL: Failed to enqueue program"))
    _flaky(monkeypatch, t, 1, RuntimeError("CUDA error: unspecified launch failure"))
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["reassignments"] == 1
    assert got["counters"]["device_runtime_errors"] == 1 and got["dead"] == [1]
    assert ("worker_dead", (("stage", "device-runtime"), ("worker", 1))) in got["per_shard"]


def test_taskpool_non_device_error_propagates(monkeypatch):
    """A program error is not eaten by the fault machinery: no death, no
    reassignment, the error reaches the caller."""
    data = gen_uniform(1_000, seed=8)
    j, t = _pair()
    for s, err in ((j, _xla_error("INVALID_ARGUMENT: bad shape in user program")),
                   (t, RuntimeError("CUDA error: device-side assert triggered"))):
        def broken(worker, data, err=err):
            raise err

        monkeypatch.setattr(s.sched.executor, "sort_shard", broken)
        with pytest.raises(Exception, match="INVALID_ARGUMENT|device-side assert"):
            s.run(data)
    got = _same(j, t)
    assert got["dead"] == [] and got["counters"]["reassignments"] == 0


def _transient(monkeypatch):
    """A CUDA status marked ``transient`` in the classifier's table (no CUDA
    status is one by default)."""
    monkeypatch.setitem(fault.CUDA_ERROR_KINDS, "cudaErrorUnknown", ("transient", "test"))
    return RuntimeError("CUDA error: unknown error")


def test_taskpool_cancelled_retries_same_worker(monkeypatch):
    """A transient error retries on the same worker, which stays alive."""
    data = gen_uniform(10_000, seed=21)
    j, t = _pair()
    _flaky(monkeypatch, j, 1, _xla_error("CANCELLED: work cancelled by sibling failure"))
    _flaky(monkeypatch, t, 1, _transient(monkeypatch))
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["transient_retries"] == 1
    assert got["counters"]["reassignments"] == 0 and got["dead"] == []
    assert ("transient_retry", (("shard", 1), ("worker", 1))) in got["per_shard"]


def test_taskpool_cancelled_escalates_after_budget(monkeypatch):
    """A persistent transient error on one worker escalates to reassignment."""
    data = gen_uniform(10_000, seed=22)
    j, t = _pair(dict(FAST, max_transient_retries=1))
    _flaky(monkeypatch, j, 0, _xla_error("CANCELLED: persistently cancelled"), 10**6)
    _flaky(monkeypatch, t, 0, _transient(monkeypatch), 10**6)
    got = _same(j, t, j.run(data), t.run(data))
    assert got["counters"]["transient_retries"] == 1 and got["counters"]["reassignments"] == 1
    assert got["dead"] == [0]


def test_taskpool_genuine_timeout_inside_attempt_propagates(monkeypatch):
    """A TimeoutError raised inside an attempt is not a lapsed wait: it
    surfaces; no heartbeat timeout, no reassignment."""
    j, t = _pair()
    for s in (j, t):
        def boom(worker, data):
            raise TimeoutError("nfs io timed out")

        monkeypatch.setattr(s.sched.executor, "sort_shard", boom)
        with pytest.raises(TimeoutError, match="nfs io"):
            s.run(gen_uniform(4_000, seed=97))
    got = _same(j, t)
    assert got["counters"]["heartbeat_timeouts"] == 0 and got["counters"]["reassignments"] == 0


def test_warm_shapes_keyed_per_worker():
    """Compile grace per (worker, shape, dtype, kernel): warming a shape on
    worker 0 leaves worker 1's first attempt its grace."""
    shard = gen_uniform(1_000, seed=84)
    for s in _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=1.0, compile_grace_s=100.0)):
        assert s.sched._attempt_timeout(0, shard) == pytest.approx(101.0)
        s.sched._attempt(0, shard)
        assert s.sched._attempt_timeout(0, shard) == pytest.approx(1.0)
        assert s.sched._attempt_timeout(1, shard) == pytest.approx(101.0)
    t = _pair()[1]
    key = t.sched._warm_key(3, shard)
    assert key == (3, shard.shape, "int32", "auto")


def test_worker_table_first_live_linear_scan():
    t = WorkerTable(4)
    assert t.first_live() == 0
    t.mark_dead(0)
    t.mark_dead(1)
    assert t.first_live() == 2
    assert t.first_live(exclude=2) == 3
    t.mark_dead(2)
    t.mark_dead(3)
    assert t.first_live() is None
    t.revive_all()
    assert t.live_workers() == [0, 1, 2, 3]


# -- hangs ---------------------------------------------------------------------


def test_hung_worker_detected_by_timeout():
    """A hung worker is declared dead at the heartbeat wait (1 s; the stall
    is 2 s) and its shard reassigned; heartbeat_lapse precedes worker_dead."""
    data = gen_uniform(4_000, seed=6)
    j, t = _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=1.0, compile_grace_s=0.0))
    outs = []
    for s in (j, t):
        s.inj.hang_once(0, "sort", seconds=2.0)
        outs.append(s.run(data))
    got = _same(j, t, *outs)
    types = got["types"]
    assert got["counters"]["heartbeat_timeouts"] == 1 and got["dead"] == [0]
    assert types.index("heartbeat_lapse") < types.index("worker_dead") < types.index("job_done")
    assert ("heartbeat_lapse", (("shard", 0), ("worker", 0))) in got["per_shard"]
    _drain([0])


def test_cold_key_slow_compile_not_killed():
    """A first-contact stall (2.5 s) past the cold budget (1.3 s) but inside
    the doubled second window (3.9 s in all) keeps the same worker alive:
    one cold_wait_retry, no reassignment."""
    data = gen_uniform(4_000, seed=61)
    j, t = _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=0.3, compile_grace_s=1.0))
    outs = []
    for s in (j, t):
        s.inj.hang_once(0, "sort", seconds=2.5)
        outs.append(s.run(data))
    got = _same(j, t, *outs)
    assert got["counters"]["cold_wait_retries"] == 1
    assert got["counters"]["reassignments"] == 0 and got["dead"] == []
    _drain([0])


def test_cold_key_genuine_hang_still_dies():
    """The cold windows are bounded: a first-contact hang (4.5 s) outlasts
    1x + 2x + 4x the 0.5 s budget (3.5 s) and the worker is declared dead."""
    data = gen_uniform(4_000, seed=62)
    j, t = _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=0.2, compile_grace_s=0.3))
    outs = []
    for s in (j, t):
        s.inj.hang_once(0, "sort", seconds=4.5)
        outs.append(s.run(data))
    got = _same(j, t, *outs)
    assert got["counters"]["cold_wait_retries"] == 2
    assert got["counters"]["heartbeat_timeouts"] == 1 and got["dead"] == [0]
    _drain([0])


def test_attempt_threads_bounded_per_worker():
    """Hung attempts pin at most one thread per worker: repeated hangs on
    worker 7 serialize on its lane; every lane thread is a daemon."""
    data = gen_uniform(4_000, seed=77)
    j, t = _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=0.5, compile_grace_s=0.0))
    for s in (j, t):
        s.inj.hang_once(7, "sort", seconds=1.5)
        s.run(data)
        s.inj.hang_once(7, "sort", seconds=1.5)
        s.sched.table.revive_all()
        s.run(data)
    got = _same(j, t)
    assert got["counters"]["heartbeat_timeouts"] == 2 and got["dead"] == [7]
    ours = [th for th in threading.enumerate() if th.name.startswith("attempt-cpu-w")]
    assert 0 < len(ours) <= 8 and all(th.daemon for th in ours)
    _drain([7])


def test_abandoned_attempts_never_execute():
    """An attempt still queued when its wait lapsed is skipped when the
    lane frees: it never runs against later state."""
    data = gen_uniform(4_000, seed=79)
    j, t = _pair(dict(settle_delay_s=0.01, heartbeat_timeout_s=0.4, compile_grace_s=0.0))
    calls = {}
    for s in (j, t):
        real = s.sched.executor.sort_shard
        seen = calls[s.port] = []

        def spy(worker, shard, real=real, seen=seen):
            seen.append(worker)
            return real(worker, shard)

        s.sched.executor.sort_shard = spy
        s.inj.hang_once(6, "sort", seconds=1.5)
        assert np.array_equal(s.run(data), np.sort(data))
        first = seen.count(6)
        s.sched.table.revive_all()
        assert np.array_equal(s.run(data), np.sort(data))  # queues behind the hang, lapses
        _drain([6])
        assert seen.count(6) == first  # the abandoned entry never ran
    assert calls[False].count(6) == calls[True].count(6) == 1
