"""The port's `SpmdScheduler` against the JAX package's, drill by drill.

Each drill of the reference's fault suite runs through both schedulers on
the same `gen_uniform` / `gen_zipf` input: JAX's ``SpmdScheduler`` on the
8-device CPU mesh and the port's ``SpmdScheduler(8, "cpu")``, with the same
`JobConfig` (``from_dict``) and the same injected faults.  Compared: the
output bits, the surviving workers, the named counters, and the
scheduler's events in order with their fields (``t``, ``mono``, ``seq`` and
``job`` excluded; ``tenant``, the serving plane's label, and the
``counters`` snapshot, which holds each package's own exchange counters,
too).  Where the reference raises a JAX runtime error, the port raises a
CUDA-named one of the same class.

The hang drills pre-warm the size bucket and leave every wait at least
0.5 s of slack on both sides, so the number of lapses does not depend on
the machine's load.
"""

import dataclasses
import threading

import numpy as np
import pytest

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.parallel import sample_sort as jss
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import JobFailedError as JaxJobFailedError
from dsort_tpu.scheduler import SpmdScheduler as JaxSpmdScheduler
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.models import pipelines
from dsort_tpu_torch.parallel import sample_sort as tss
from dsort_tpu_torch.scheduler import FaultInjector, JobFailedError, SpmdScheduler
from dsort_tpu_torch.scheduler import fault
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

SCHED_EVENTS = {"job_start", "attempt_start", "worker_dead", "mesh_reform", "probe",
                "heartbeat_lapse", "transient_retry", "job_failed", "job_done"}
FAULT_EVENTS = SCHED_EVENTS - {"job_start", "attempt_start", "job_failed", "job_done"}
NAMED = ("mesh_reforms", "device_deaths", "device_runtime_errors", "spmd_wait_timeouts",
         "transient_retries", "exchange_ring_steps", "fused_exchange_launches",
         "fused_exchange_steps")
FAST = dict(settle_delay_s=0.01, heartbeat_timeout_s=5.0)
# Hang drills: warm waits lapse at 1.0 s, the first wait of a new mesh at
# 21 s (the JAX side compiles there).
HANG = dict(settle_delay_s=0.01, heartbeat_timeout_s=0.5, compile_grace_s=20.0,
            exec_allowance_floor_s=0.5, exec_allowance_keys_per_s=1e9,
            max_transient_retries=5)


def _xla_error(msg):
    from jax.errors import JaxRuntimeError

    return JaxRuntimeError(msg)


def _timeline(journal):
    out = []
    for e in journal.events():
        if e.type in SCHED_EVENTS:
            fields = {k: v for k, v in e.fields.items() if k not in ("job", "tenant", "counters")}
            out.append((e.type, fields))
    return out


class Side:
    """One package's scheduler, injector, journal and metrics for a drill."""

    def __init__(self, port: bool, job_kw: dict):
        self.port = port
        jjob = JaxJobConfig(**job_kw)
        if port:
            self.inj = FaultInjector()
            self.sched = SpmdScheduler(8, "cpu", JobConfig.from_dict(dataclasses.asdict(jjob)),
                                       self.inj)
            self.journal = EventLog()
            self.metrics = Metrics(journal=self.journal)
        else:
            self.inj = JaxFaultInjector()
            self.sched = JaxSpmdScheduler(job=jjob, injector=self.inj)
            self.journal = JaxEventLog()
            self.metrics = JaxMetrics(journal=self.journal)
        self.sort_cls = tss.SampleSort if port else jss.SampleSort
        self.failed = JobFailedError if port else JaxJobFailedError

    def sort(self, data, **kw):
        return self.sched.sort(data, metrics=self.metrics, **kw)

    def result(self):
        return {
            "live": self.sched.table.live_workers(),
            "counters": {k: self.metrics.counters.get(k, 0) for k in NAMED},
            "timeline": _timeline(self.journal),
        }


def _pair(job_kw):
    return Side(False, job_kw), Side(True, job_kw)


def _same(jax_side, port_side, jax_out=None, port_out=None):
    """Both sides' results equal; returns the port's."""
    if jax_out is not None:
        assert port_out.dtype == jax_out.dtype
        assert np.array_equal(port_out.view(f"u{port_out.dtype.itemsize}"),
                              jax_out.view(f"u{jax_out.dtype.itemsize}"))
    got, want = port_side.result(), jax_side.result()
    assert got["live"] == want["live"]
    assert got["counters"] == want["counters"]
    assert got["timeline"] == want["timeline"]
    return got


def _float_keys():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(20_000) * 1e3).astype(np.float32)
    x[rng.choice(20_000, 64, replace=False)] = np.resize(
        np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32), 64)
    return x


@pytest.mark.parametrize("case", ["uniform_int32", "zipf_int64", "float32_nan", "empty"])
def test_spmd_scheduler_healthy(mesh8, case):
    data = {"uniform_int32": lambda: gen_uniform(40_000, seed=3),
            "zipf_int64": lambda: gen_zipf(30_000, a=1.3, seed=4),
            "float32_nan": _float_keys,
            "empty": lambda: np.zeros(0, np.int32)}[case]()
    j, t = _pair(FAST)
    got = _same(j, t, j.sort(data), t.sort(data))
    assert [e for e, _ in got["timeline"]] == ["job_start", "attempt_start", "job_done"]


def test_spmd_scheduler_mesh_reform(mesh8):
    data = gen_uniform(40_000, seed=7)
    j, t = _pair(FAST)
    for s in (j, t):
        s.inj.fail_once(2, "spmd")
    got = _same(j, t, j.sort(data), t.sort(data))
    assert got["counters"]["mesh_reforms"] == 1 and got["live"] == [0, 1, 3, 4, 5, 6, 7]
    types = [e for e, _ in got["timeline"]]
    assert types[0] == "job_start" and types[-1] == "job_done"
    assert types.count("attempt_start") == 2
    assert types.index("worker_dead") < types.index("mesh_reform") < len(types) - 2
    assert ("mesh_reform", {"survivors": 7}) in got["timeline"]


def test_spmd_cascading_device_loss(mesh8):
    data = gen_uniform(50_000, seed=29)
    j, t = _pair(FAST)
    for s in (j, t):
        s.inj.fail_once(2, "spmd")
        s.inj.fail_once(5, "spmd")
    got = _same(j, t, j.sort(data), t.sort(data))
    assert got["counters"]["mesh_reforms"] == 2 and got["live"] == [0, 1, 3, 4, 6, 7]


def test_spmd_scheduler_all_dead(mesh8):
    data = gen_uniform(100, seed=8)
    j, t = _pair(FAST)
    for s in (j, t):
        for i in range(8):
            s.inj.kill(i)
        with pytest.raises(s.failed, match="no live devices remain"):
            s.sort(data)
    got = _same(j, t)
    assert got["live"] == [] and got["timeline"][-1][0] == "job_failed"


def test_spmd_zipf_skew_with_injected_failure(mesh8):
    data = gen_zipf(60_000, a=1.2, seed=13)
    j, t = _pair(FAST)
    for s in (j, t):
        s.inj.fail_once(5, "spmd")
    got = _same(j, t, j.sort(data), t.sort(data))
    assert got["counters"]["mesh_reforms"] == 1


def _flaky_sort(monkeypatch, side, errors):
    """Make ``SampleSort.sort`` raise ``errors[i]`` on its i-th call (a None
    entry, or a call past the list, sorts)."""
    real = side.sort_cls.sort
    calls = {"n": 0}

    def flaky(self, data, metrics=None):
        i = calls["n"]
        calls["n"] += 1
        if i < len(errors) and errors[i] is not None:
            raise errors[i]
        return real(self, data, metrics)

    monkeypatch.setattr(side.sort_cls, "sort", flaky)


def test_spmd_real_runtime_error_device_death(monkeypatch, mesh8):
    """Runtime error + a failing probe on one worker -> mesh re-form."""
    data = gen_uniform(50_000, seed=9)
    j, t = _pair(dict(settle_delay_s=0.01))
    outs = []
    for s, err in ((j, _xla_error("INTERNAL: Device 2 resets")),
                   (t, RuntimeError("CUDA error: unspecified launch failure"))):
        with monkeypatch.context() as mp:
            _flaky_sort(mp, s, [err])
            real_probe = type(s.sched)._probe_device
            mp.setattr(type(s.sched), "_probe_device",
                       lambda self, idx, real_probe=real_probe:
                       False if idx == 2 else real_probe(self, idx))
            outs.append(s.sort(data))
    got = _same(j, t, *outs)
    assert got["counters"]["device_deaths"] == 1 and got["live"] == [0, 1, 3, 4, 5, 6, 7]
    assert ("worker_dead", {"worker": 2, "stage": "probe"}) in got["timeline"]


def test_spmd_transient_runtime_error_retries(monkeypatch, mesh8):
    """Runtime error with every probe healthy -> bounded retry, no re-form."""
    data = gen_uniform(50_000, seed=10)
    j, t = _pair(dict(settle_delay_s=0.01))
    outs = []
    for s, err in ((j, _xla_error("UNAVAILABLE: relay hiccup")),
                   (t, RuntimeError("CUDA error: the launch timed out and was terminated"))):
        with monkeypatch.context() as mp:
            _flaky_sort(mp, s, [err])
            outs.append(s.sort(data))
    got = _same(j, t, *outs)
    assert got["counters"]["transient_retries"] == 1 and got["counters"]["mesh_reforms"] == 0
    assert len(got["live"]) == 8


def test_spmd_transient_retries_exhausted(monkeypatch, mesh8):
    data = gen_uniform(10_000, seed=11)
    j, t = _pair(dict(settle_delay_s=0.01, max_transient_retries=1))
    for s, err, match in ((j, _xla_error("ABORTED: persistent"), "ABORTED"),
                          (t, RuntimeError("CUDA error: unspecified launch failure"),
                           "unspecified launch failure")):
        with monkeypatch.context() as mp:
            _flaky_sort(mp, s, [err] * 10)
            with pytest.raises(RuntimeError, match=match):
                s.sort(data)
    got = _same(j, t)
    assert got["counters"]["transient_retries"] == 1
    assert got["counters"]["device_runtime_errors"] == 2


def test_spmd_program_error_propagates_without_probes(monkeypatch, mesh8):
    """An unclassified (program) error propagates at once: no probe, no
    retry, no re-form."""
    data = gen_uniform(5_000, seed=12)
    j, t = _pair(FAST)
    for s, err in ((j, _xla_error("INVALID_ARGUMENT: bad shape")),
                   (t, RuntimeError("CUDA error: device-side assert triggered"))):
        with monkeypatch.context() as mp:
            _flaky_sort(mp, s, [err])
            with pytest.raises(RuntimeError, match="INVALID_ARGUMENT|device-side assert"):
                s.sort(data)
    got = _same(j, t)
    assert [e for e, _ in got["timeline"]] == ["job_start", "attempt_start"]


def test_transient_classified_error_probes_then_retries(monkeypatch):
    """The ``"transient"`` branch: a status classified transient probes every
    worker and, all healthy, retries in place."""
    monkeypatch.setitem(fault.CUDA_ERROR_KINDS, "cudaErrorUnknown", ("transient", "test"))
    t = Side(True, FAST)
    data = gen_uniform(20_000, seed=14)
    _flaky_sort(monkeypatch, t, [RuntimeError("CUDA error: unknown error")])
    assert np.array_equal(t.sort(data), np.sort(data))
    got = t.result()
    assert got["counters"]["transient_retries"] == 1 and len(got["live"]) == 8
    assert [e for e, _ in got["timeline"]].count("probe") == 8


def test_spmd_inflight_hang_detected_and_mesh_reforms(monkeypatch, mesh8):
    """A hang while the program is in flight is detected by the bounded wait;
    the probes find the wedged worker; the job completes on the survivors."""
    data = gen_uniform(30_000, seed=91)
    j, t = _pair(HANG)
    release = threading.Event()
    outs = []
    try:
        for s in (j, t):
            s.sched.sort(data)  # warm the 8-worker bucket
            with monkeypatch.context() as mp:
                real = s.sort_cls.sort

                def hang_then_sort(self, data, metrics=None, real=real, state={"n": 0}):
                    state["n"] += 1
                    if state["n"] == 1:
                        release.wait(30.0)  # "forever"; runs on a daemon lane
                    return real(self, data, metrics)

                mp.setattr(s.sort_cls, "sort", hang_then_sort)

                def fake_probe(self, idx):
                    if idx == 3:
                        return False  # the wedged worker fails its probe
                    self.table.heartbeat(idx)
                    return True

                mp.setattr(type(s.sched), "_probe_device", fake_probe)
                outs.append(s.sort(data))
    finally:
        release.set()
    got = _same(j, t, *outs)
    types = [e for e, _ in got["timeline"]]
    assert (types.index("heartbeat_lapse") < types.index("probe") < types.index("worker_dead")
            < types.index("mesh_reform") < types.index("job_done"))
    assert got["counters"]["spmd_wait_timeouts"] == 1 and got["live"] == [0, 1, 2, 4, 5, 6, 7]


def test_spmd_inflight_hang_healthy_devices_retries(mesh8):
    """A host-side stall (every probe passes) takes the bounded retry path;
    the retry queues behind the stalled attempt and completes once it
    clears."""
    data = gen_uniform(30_000, seed=92)
    j, t = _pair(HANG)
    outs = []
    for s in (j, t):
        s.sched.sort(data)  # warm: the wait lapses at 1.0 s
        s.inj.hang_once(0, "spmd", seconds=1.5)
        outs.append(s.sort(data))
    got = _same(j, t, *outs)
    assert got["counters"]["spmd_wait_timeouts"] == 1
    assert got["counters"]["transient_retries"] == 1 and len(got["live"]) == 8


def test_spmd_healthy_timeout_budget_grows(mesh8):
    """Successive healthy-probe lapses double the budget (1, 2, 4 s): a 4 s
    stall outlasts two windows and completes in the third."""
    data = gen_uniform(30_000, seed=93)
    j, t = _pair(dict(HANG, max_transient_retries=2))
    outs = []
    for s in (j, t):
        s.sched.sort(data)
        s.inj.hang_once(0, "spmd", seconds=4.0)
        outs.append(s.sort(data))
    got = _same(j, t, *outs)
    assert got["counters"]["transient_retries"] == 2 and len(got["live"]) == 8


def test_probe_respects_injector(mesh8):
    for s in _pair(HANG):
        s.inj.fail_once(2, "probe")
        assert s.sched._probe_device(2) is False
        assert s.sched._probe_device(2) is True  # one-shot consumed


def test_genuine_timeout_inside_attempt_propagates(monkeypatch, mesh8):
    """A TimeoutError raised INSIDE the attempt is not a lapsed wait: no
    probes, no retries — it surfaces unchanged."""
    data = gen_uniform(5_000, seed=95)
    j, t = _pair(HANG)
    for s in (j, t):
        with monkeypatch.context() as mp:
            _flaky_sort(mp, s, [TimeoutError("nfs io timed out")])
            with pytest.raises(TimeoutError, match="nfs io"):
                s.sort(data)
    got = _same(j, t)
    assert got["counters"]["spmd_wait_timeouts"] == 0 and len(got["live"]) == 8


@pytest.mark.parametrize("exchange", ["ring", "fused"])
def test_mid_ring_device_loss_reforms_and_matches(mesh8, exchange):
    """A worker lost between the ring plan and the exchange: the mesh
    re-forms over 7 and re-runs with a fresh plan — 7 + 6 ring steps, and
    under ``fused`` two exchange launches."""
    z = gen_zipf(1 << 15, a=1.3, seed=5)
    j, t = _pair(dict(settle_delay_s=0.01, exchange=exchange))
    outs = []
    for s in (j, t):
        s.sched.sort(z)  # warm
        s.inj.fail_once(3, "ring")
        outs.append(s.sort(z))
    got = _same(j, t, *outs)
    assert np.array_equal(outs[1], np.sort(z))
    assert got["counters"]["mesh_reforms"] == 1 and got["counters"]["exchange_ring_steps"] == 13
    if exchange == "fused":
        assert got["counters"]["fused_exchange_launches"] == 2
        assert got["counters"]["fused_exchange_steps"] == 13
    types = t.journal.types()
    plan = "fused_exchange_launch" if exchange == "fused" else "exchange_step"
    assert plan in types[types.index("mesh_reform"):] and types[-1] == "job_done"
    assert ("worker_dead", {"worker": 3, "stage": "ring"}) in got["timeline"]


def test_cli_run_through_the_scheduler_matches_jax(tmp_path):
    """``cli run`` sorts through the scheduler — a job this small on its
    fused route, under the scheduler's bounded wait, as ``dsort run --mode
    spmd`` routes it: byte-identical output, and ``--journal`` holds the
    fault-free timeline in the reference's record format."""
    x = gen_uniform(7_000, seed=31)
    src, ref, out, jpath = (tmp_path / n for n in ("in.txt", "ref.txt", "out.txt", "j.jsonl"))
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    assert jax_cli_main(["run", str(src), "-o", str(ref), "--mode", "spmd"]) == 0
    assert cli.main(["run", str(src), "-o", str(out), "--device", "cpu",
                     "--journal", str(jpath)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    recs = EventLog.read_jsonl(str(jpath))
    assert all(list(r)[:4] == ["seq", "t", "mono", "type"] for r in recs)
    types = [r["type"] for r in recs]
    assert types[0] == "job_start" and types[-1] == "result_fetch"
    assert types.count("attempt_start") == 0 and types.index("job_done") == len(types) - 2
    assert not FAULT_EVENTS & set(types)
    assert recs[0]["mode"] == "fused" and recs[0]["n_keys"] == 7_000
    assert recs[-2]["counters"]["fused_small_jobs"] == 1


def test_cli_run_journal_written_when_the_job_fails(monkeypatch, tmp_path):
    src, jpath = tmp_path / "in.txt", tmp_path / "j.jsonl"
    src.write_text("3\n1\n2\n")

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: device-side assert triggered")

    # A program error on the fused route propagates (no fallback); so does
    # one inside the scheduler's attempt.
    monkeypatch.setattr(pipelines, "fused_sort_small", broken)
    monkeypatch.setattr(tss.SampleSort, "sort", broken)
    with pytest.raises(RuntimeError, match="device-side assert"):
        cli.main(["run", str(src), "-o", str(tmp_path / "o.txt"), "--device", "cpu",
                  "--journal", str(jpath)])
    types = [r["type"] for r in EventLog.read_jsonl(str(jpath))]
    assert types == ["job_start", "job_failed"]
