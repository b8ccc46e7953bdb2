"""The port's fault-plane pieces against the JAX package's.

`FaultInjector` and `WorkerTable` of both packages are driven by one call
script and must raise, trip and scan alike; the CUDA error classifier is
held to its table (device errors re-form, program errors propagate, OOM is
a program error, a refused kernel argument too); the `EventLog` writes the
reference's JSONL records; `JobConfig.from_dict` reads the fault plane's
fields and refuses resumable jobs.
"""

import dataclasses
import time

import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.scheduler import fault as jfault
from dsort_tpu.scheduler import liveness as jliveness
from dsort_tpu.utils import events as jevents

from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.ops import errors
from dsort_tpu_torch.ops.errors import KernelLaunchError
from dsort_tpu_torch.scheduler import fault, liveness
from dsort_tpu_torch.utils import events

# -- FaultInjector / WorkerTable: one call script through both packages -----

INJECTOR_SCRIPTS = {
    "kill_and_revive": [
        ("kill", 1), ("check", 1, "spmd"), ("check", 1, "ring"), ("check", 0, "spmd"),
        ("revive", 1), ("check", 1, "spmd"),
    ],
    "one_shots": [
        ("fail_once", 2, "spmd"), ("fail_once", 3, "ring", 2), ("check", 2, "ring"),
        ("check", 2, "spmd"), ("check", 2, "spmd"), ("check", 3, "ring"),
        ("check", 3, "ring"), ("check", 3, "ring"), ("fail_once", 4), ("check", 4, "send"),
    ],
    "sequence": [
        ("fail_sequence", [(4, "ring"), (5, "ring")]), ("check", 5, "ring"),
        ("check", 4, "ring"), ("check", 5, "ring"), ("check", 4, "ring"),
        ("check", 5, "ring"),
    ],
    "hang_slow_probe": [
        ("hang_once", 0, "spmd", 0.01), ("check", 0, "spmd"), ("check", 0, "spmd"),
        ("slow", 6, 0.5), ("slow", 2, 0.25), ("fail_once", 2, "probe"),
        ("check", 2, "probe"), ("check", 2, "probe"), ("slow", 6, 0),
    ],
}


def _drive_injector(inj, script):
    """Run ``script`` on ``inj``; returns what each step did."""
    trace = []
    for op, *args in script:
        if op == "check":
            try:
                inj.check(*args)
                trace.append(("ok", inj.trips))
            except Exception as e:  # the injector's own WorkerFailure
                trace.append((type(e).__name__, e.worker, e.stage, str(e), inj.trips))
        else:
            getattr(inj, op)(*args)
        trace.append(("straggler", inj.straggler(), inj.delay_for(6), inj.delay_for(2)))
    return trace


@pytest.mark.parametrize("script", sorted(INJECTOR_SCRIPTS))
def test_fault_injector_matches_jax(script):
    steps = INJECTOR_SCRIPTS[script]
    got = _drive_injector(fault.FaultInjector(), steps)
    assert got == _drive_injector(jfault.FaultInjector(), steps)
    assert any(s[0] == "WorkerFailure" for s in got)


def _drive_table(mod):
    t = mod.WorkerTable(4, heartbeat_timeout_s=0.05)
    out = [t.first_live(), t.live_workers()]
    t.mark_dead(0)
    t.mark_dead(1)
    t.mark_dead(1)  # a second mark counts once
    out += [t.first_live(), t.first_live(exclude=2), t.is_alive(1), t.death_count]
    time.sleep(0.1)
    t.heartbeat(2)
    out += [t.check_heartbeats(), t.live_workers(), t.death_count]
    t.mark_dead(2)
    out += [t.first_live(), t.check_heartbeats()]
    t.revive_all()
    out += [t.live_workers(), t.check_heartbeats(), t.death_count]
    return out


def test_worker_table_matches_jax():
    got = _drive_table(liveness)
    assert got == _drive_table(jliveness)
    assert got[0] == 0 and got[2] == 2 and got[6] == [3]
    with pytest.raises(ValueError):
        liveness.WorkerTable(0)


# -- the CUDA error classifier -----------------------------------------------

CLASSIFIED = [
    # Device errors: the hardware or its system software.
    (KernelLaunchError("bitonic_tile", 719), "device"),
    (KernelLaunchError("ring_exchange", 214), "device"),
    (RuntimeError("CUDA error: unspecified launch failure\nCUDA kernel errors might be "
                  "asynchronously reported"), "device"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "device"),
    (RuntimeError("CUDA error: uncorrectable NVLink error detected during the execution"),
     "device"),
    (RuntimeError("CUDA error: no CUDA-capable device is detected"), "device"),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or unavailable"), "device"),
    (RuntimeError("CUDA error: system not yet initialized"), "device"),
    (torch.AcceleratorError("CUDA error: the launch timed out and was terminated"), "device"),
    # Program errors: they propagate.
    (KernelLaunchError("tile_sort", 1), None),  # a shape the C entry refused
    (KernelLaunchError("tile_sort", 9), None),
    (KernelLaunchError("tile_sort", 2), None),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 32768.00 GiB"), None),
    (RuntimeError("CUDA error: out of memory"), None),
    (torch.AcceleratorError("CUDA error: device-side assert triggered\nSearch for "
                            "`cudaErrorAssert'"), None),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), None),
    (RuntimeError("CUDA error: misaligned address"), None),
    (RuntimeError("CUDA error: unknown error"), None),  # not on the allowlist
    (ValueError("CUDA error: unspecified launch failure"), None),  # not a runtime error
    (RuntimeError("INTERNAL: device halted"), None),  # XLA's statuses are not CUDA's
    (RuntimeError("unspecified launch failure"), None),  # no CUDA error prefix
    (TimeoutError("nfs io timed out"), None),
    (fault.WorkerFailure(2, "spmd"), None),
]


@pytest.mark.parametrize("exc,kind", CLASSIFIED, ids=lambda v: repr(v)[:60])
def test_classify_runtime_error(exc, kind):
    assert fault.classify_runtime_error(exc) == kind
    assert fault.is_device_runtime_error(exc) == (kind == "device")


def test_classifier_reads_the_code_before_the_text():
    """``torch.AcceleratorError`` carries ``error_code`` on the card; a
    `KernelLaunchError` carries ``.code``: the code decides, not the text."""
    e = torch.AcceleratorError("CUDA error: device-side assert triggered")
    e.error_code = 719
    assert fault.classify_runtime_error(e) == "device"
    e.error_code = 710
    assert fault.classify_runtime_error(e) is None
    k = KernelLaunchError("gather_rows", 1)
    assert (k.code, k.name) == (1, "cudaErrorInvalidValue")
    assert str(k) == "gather_rows kernel launch failed: CUDA error 1"  # the old text
    assert isinstance(k, RuntimeError)
    assert KernelLaunchError("x", 12345).name == "cudaError12345"


def test_error_tables_agree():
    """Every classified status is a named code with its reason; the device
    entries are exactly the hardware and system statuses; no status is
    transient."""
    names = {name for name, _ in errors.CUDA_ERRORS.values()}
    assert set(fault.CUDA_ERROR_KINDS) <= names
    for name, (kind, reason) in fault.CUDA_ERROR_KINDS.items():
        assert kind in (None, "device") and reason
    assert {n for n, (k, _) in fault.CUDA_ERROR_KINDS.items() if k == "device"} == {
        "cudaErrorECCUncorrectable", "cudaErrorNvlinkUncorrectable", "cudaErrorNoDevice",
        "cudaErrorDevicesUnavailable", "cudaErrorSystemNotReady", "cudaErrorLaunchTimeout",
        "cudaErrorLaunchFailure",
    }
    for code, (name, text) in errors.CUDA_ERRORS.items():
        assert errors.cuda_error_name(code) == name
        assert errors.cuda_error_name_of_text(text) == name


def test_transient_entry_classifies_transient(monkeypatch):
    """The ``"transient"`` branch stays reachable: a status marked so
    classifies as transient, neither device nor program error."""
    monkeypatch.setitem(fault.CUDA_ERROR_KINDS, "cudaErrorUnknown", ("transient", "test"))
    e = RuntimeError("CUDA error: unknown error")
    assert fault.classify_runtime_error(e) == "transient"
    assert not fault.is_device_runtime_error(e)


# -- EventLog ------------------------------------------------------------------


def _emit_script(log):
    log.emit("job_start", mode="spmd", n_keys=5, job_id=None, job=1)
    log.emit("attempt_start", live=[0, 1, 2], job=1)
    log.emit("worker_dead", worker=2, stage="spmd", job=1)
    log.emit("mesh_reform", survivors=2, job=1)
    log.emit("job_done", n_keys=5, counters={"mesh_reforms": 1}, job=1)


def _strip_clock(records):
    return [{k: v for k, v in r.items() if k not in ("t", "mono")} for r in records]


def test_event_log_jsonl_matches_jax(tmp_path):
    log, jlog = events.EventLog(), jevents.EventLog()
    _emit_script(log)
    _emit_script(jlog)
    assert log.types() == jlog.types() and len(log) == len(jlog) == 5
    p, jp = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    log.write_jsonl(str(p))
    jlog.write_jsonl(str(jp))
    recs, jrecs = events.EventLog.read_jsonl(str(p)), jevents.EventLog.read_jsonl(str(jp))
    assert [list(r) for r in recs] == [list(r) for r in jrecs]  # key order too
    assert list(recs[0])[:4] == ["seq", "t", "mono", "type"]
    assert _strip_clock(recs) == _strip_clock(jrecs)
    assert [r["seq"] for r in recs] == list(range(5))
    assert all(a["mono"] <= b["mono"] for a, b in zip(recs, recs[1:]))
    assert recs == [e.to_dict() for e in log.events()]


def test_event_log_flush_appends_and_refuses_unknown_types(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_text('{"stale": 1}\n')
    log = events.EventLog()
    log.emit("job_start", n_keys=1)
    log.flush_jsonl(str(p))  # the first flush truncates
    log.emit("job_done", n_keys=1)
    log.flush_jsonl(str(p))
    log.flush_jsonl(str(p))  # nothing new: nothing written
    assert [r["type"] for r in events.EventLog.read_jsonl(str(p))] == ["job_start", "job_done"]
    with pytest.raises(ValueError, match="unregistered"):
        log.emit("no_such_event")
    # Every type the port journals is one the reference's tools read.
    assert set(events.EVENT_TYPES) <= set(jevents.EVENT_TYPES)


# -- JobConfig -------------------------------------------------------------------

FAULT_FIELDS = ("settle_delay_s", "heartbeat_timeout_s", "compile_grace_s",
                "max_transient_retries", "exec_allowance_floor_s", "exec_allowance_keys_per_s")


def test_job_config_reads_the_fault_plane_fields():
    assert {f: getattr(JobConfig(), f) for f in FAULT_FIELDS} == {
        f: getattr(JaxJobConfig(), f) for f in FAULT_FIELDS
    }
    want = dict(settle_delay_s=0.01, heartbeat_timeout_s=0.3, compile_grace_s=2.0,
                max_transient_retries=5, exec_allowance_floor_s=0.3,
                exec_allowance_keys_per_s=1e9)
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(**want)))
    assert {f: getattr(job, f) for f in FAULT_FIELDS} == want


@pytest.mark.parametrize("bad", [
    dict(max_transient_retries=-1), dict(exec_allowance_floor_s=-0.1),
    dict(exec_allowance_keys_per_s=0.0),
])
def test_job_config_checks_the_fault_plane_fields(bad):
    with pytest.raises(ConfigError):
        JobConfig(**bad)
    with pytest.raises(Exception):  # the reference refuses the same values
        JaxJobConfig(**bad)


def test_job_config_refuses_checkpoint_dir(tmp_path):
    """The refusal of ``checkpoint_dir`` went with the port of resumable
    jobs, and the refusal of ``autotune`` with the port of the planner:
    `from_dict` now carries both, as the reference's config holds them."""
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(checkpoint_dir=str(tmp_path))))
    assert job.checkpoint_dir == str(tmp_path)
    assert JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(checkpoint_dir=None))).checkpoint_dir is None
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(autotune=True, explicit=("exchange",))))
    assert job.autotune is True and job.explicit == ("exchange",)
