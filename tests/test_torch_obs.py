"""The observability plane against the JAX package's.

`LatencyHistogram` quantiles, `SloStateMachine` stage durations and
`slo_from_journal`, `Telemetry.render_prometheus()` of one event stream,
the flight recorder's bundle schema and recovery-path names, and the
ledger's labels and journal replay are held against the reference's on
the same seeded inputs; the port's scrape goes over `MetricsServer` on a
localhost port 0.  The reference renders every counter its registry
holds; the port's registry holds the ported planes' counters only, so the
reference's text is compared with its counter lines cut to those names.
The port's schedulers dump flight bundles on each recovery path (one
drill each, on the CPU), and a JAX drill at 2^15 keys holds the bundle's
keys.  The port's ledger records each variant's first call per stream
(`obs.prof.instrument_first_call`).
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from dsort_tpu.obs import flight as jflight
from dsort_tpu.obs import histogram as jhist
from dsort_tpu.obs import prof as jprof
from dsort_tpu.obs import slo as jslo
from dsort_tpu.obs import telemetry as jtel
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.config import JobConfig, ServeConfig
from dsort_tpu_torch.obs import (
    BUNDLE_SCHEMA_KEYS,
    LEDGER,
    LEDGER_EVENT_FIELDS,
    RECOVERY_EVENTS,
    FlightRecorder,
    LatencyHistogram,
    MemWatch,
    MetricsServer,
    Telemetry,
    device_memory_snapshot,
    instrument_first_call,
    ledger_from_journal,
    parse_prometheus_text,
    slo_from_journal,
    variant_label,
)
from dsort_tpu_torch.obs.flight import config_snapshot, recovery_path_name
from dsort_tpu_torch.obs.prof import CompileLedger
from dsort_tpu_torch.obs.slo import SloStateMachine
from dsort_tpu_torch.utils.events import COUNTERS, EventLog
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

FAST = JobConfig(settle_delay_s=0.01)


# -- histograms and SLOs ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    samples = np.concatenate([rng.uniform(1e-4, 2.0, 400), rng.exponential(0.05, 100),
                              [0.0, jhist.BUCKET_BOUNDS[-1] * 10]])
    ours, theirs = LatencyHistogram(), jhist.LatencyHistogram()
    for s in samples:
        ours.observe(float(s))
        theirs.observe(float(s))
    assert ours.count == theirs.count == len(samples)
    assert ours.snapshot() == theirs.snapshot()
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
        if q < 0.99:
            assert float(np.quantile(samples, q)) <= ours.quantile(q)
    assert ours.quantile(1.0) == jhist.BUCKET_BOUNDS[-1] * 10  # the observed max
    assert LatencyHistogram().quantile(0.99) == 0.0


def _stream(seed, jobs=12):
    """A seeded interleaved lifecycle stream: ``(type, fields, mono)``."""
    rng = np.random.default_rng(seed)
    out, mono = [], 100.0
    live = []
    for j in range(1, jobs + 1):
        mono += float(rng.uniform(0, 0.01))
        out.append(("job_start", {"job": j, "tenant": f"t{j % 3}", "mode": "serve"}, mono))
        live.append(j)
        if rng.random() < 0.3:  # the scheduler's duplicate job_start
            out.append(("job_start", {"job": j, "mode": "spmd"}, mono + 1e-4))
    for j in live:
        mono += float(rng.uniform(0, 0.05))
        out.append(("attempt_start", {"job": j}, mono))
        out.append(("attempt_start", {"job": j}, mono + 1e-3))
    for j in live:
        mono += float(rng.uniform(0, 0.2))
        if rng.random() < 0.2:
            out.append(("job_failed", {"job": j, "reason": "x"}, mono))
        else:
            out.append(("job_done", {"job": j, "counters": {"fused_small_jobs": 1}}, mono))
            out.append(("result_fetch", {"job": j}, mono + float(rng.uniform(0, 0.01))))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_slo_state_machine_and_journal_replay_match_jax(seed):
    stream = _stream(seed)
    got, want = [], []
    ours = SloStateMachine(lambda *a: got.append(a))
    theirs = jslo.SloStateMachine(lambda *a: want.append(a))
    for etype, fields, mono in stream:
        ours.step(etype, dict(fields), mono)
        theirs.step(etype, dict(fields), mono)
        assert ours.in_flight == theirs.in_flight
    assert got == want and got
    records = [{"seq": i, "t": m, "mono": m, "type": t, **f}
               for i, (t, f, m) in enumerate(stream)]
    a, b = slo_from_journal(records), jslo.slo_from_journal(records)
    assert set(a) == set(b)
    for k in a:
        assert a[k].snapshot() == b[k].snapshot()


# -- telemetry --------------------------------------------------------------------


class _Fake:
    """A `Metrics` stand-in for feeding a tap directly."""

    counters: dict = {}


def _feed(tel, stream, tap_cls):
    tap = tap_cls(tel)
    for etype, fields, mono in stream:
        tap.observe(etype, dict(fields), mono, _Fake())
    return tap


def test_telemetry_render_matches_jax():
    """The same event stream (lifecycles, phases, counters, planner
    decisions), gauges, series and verdicts through both registries: the
    same Prometheus text, the reference's counter lines cut to the port's
    registry, and the same parse."""
    stream = _stream(5)
    stream += [
        ("phase_end", {"job": 1, "phase": "local_sort", "seconds": 0.25}, 200.0),
        ("phase_end", {"job": 2, "phase": "partition", "seconds": 0.125}, 200.1),
        ("plan_decision", {"policy": "exchange", "chosen": "ring"}, 200.2),
        ("plan_decision", {"policy": "prewarm", "chosen": ["1024:int32"]}, 200.3),
        ("plan_override", {"policy": "exchange", "explicit": "fused"}, 200.4),
    ]
    LEDGER.reset()
    jprof.LEDGER.reset()
    texts = []
    for tel, tap_cls in ((Telemetry(), None), (jtel.Telemetry(), jtel._TelemetryTap)):
        from dsort_tpu_torch.obs.telemetry import _TelemetryTap

        _feed(tel, stream, tap_cls or _TelemetryTap)
        tel.set_gauge("queue_depth", 3)
        tel.set_gauge("slices_free", 5)
        tel.set_series("agent_score", {"agent": "a1", "phase": "sort"}, 0.5, key={"agent": "a1"})
        tel.inc_counter("variant_cache_prewarms", 2)
        tel.admission_verdict("acme", "admitted")
        tel.admission_verdict("acme", "slo_shed")
        texts.append(tel.render_prometheus())
    ours, theirs = texts
    theirs = "\n".join(
        ln for ln in theirs.split("\n")
        if not ln.startswith('dsort_counter_total{name="')
        or ln.split('"')[1] in COUNTERS
    )
    assert ours == theirs
    assert parse_prometheus_text(ours) == jtel.parse_prometheus_text(theirs)


def test_telemetry_counter_deltas_not_double_counted():
    tel, m = Telemetry(), Metrics()
    tel.attach(m)
    tel.attach(m)
    assert len(m.taps) == 1
    for _ in range(2):
        m.bump("mesh_reforms")
        m.event("job_start", mode="spmd", n_keys=1)
        m.event("job_done", n_keys=1, counters=dict(m.counters))
    assert tel.snapshot()["counters"]["mesh_reforms"] == 2


def test_metrics_server_scrape_roundtrip():
    tel = Telemetry()
    tel.observe_stage("default", "admit_to_sorted", 0.05)
    tel.set_gauge("queue_depth", 4)
    with MetricsServer(tel, port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        assert parse_prometheus_text(body)[("dsort_queue_depth", ())] == 4
        js = json.loads(urllib.request.urlopen(srv.url.replace("/metrics", "/json"),
                                               timeout=10).read().decode())
        assert js["gauges"]["queue_depth"] == 4
        ok = urllib.request.urlopen(srv.url.replace("/metrics", "/healthz"), timeout=10)
        assert ok.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url.replace("/metrics", "/nope"), timeout=10)
    for bad in ("dsort_counter_total{name=unquoted} 1\n", "just words\n"):
        with pytest.raises(ValueError):
            parse_prometheus_text(bad)


def test_scheduler_telemetry_slo_matches_journal_ground_truth():
    """`SpmdScheduler(telemetry=...)`: the live tap and a journal replay
    report the same per-tenant quantiles for all four stages."""
    from dsort_tpu_torch.scheduler import SpmdScheduler

    tel, journal = Telemetry(), EventLog()
    sched = SpmdScheduler(8, "cpu", JobConfig(settle_delay_s=0.01, tenant="acme"),
                          telemetry=tel)
    rng = np.random.default_rng(1)
    for _ in range(3):
        m = Metrics(journal=journal)
        out = sched.sort(rng.integers(0, 10**6, 20_000).astype(np.int32), m)
        assert (np.diff(out) >= 0).all()
        m.event("result_fetch", n_keys=len(out))
    parsed = parse_prometheus_text(tel.render_prometheus())
    truth = slo_from_journal([e.to_dict() for e in journal.events()])
    assert {s for _, s in truth} == {"admit_to_dispatch", "dispatch_to_sorted",
                                     "sorted_to_fetched", "admit_to_sorted"}
    for (tenant, stage), hist in truth.items():
        assert tenant == "acme"
        for q in (0.5, 0.95, 0.99):
            key = ("dsort_job_stage_seconds", tuple(sorted(
                {"tenant": tenant, "stage": stage, "quantile": str(q)}.items())))
            assert parsed[key] == pytest.approx(hist.quantile(q), rel=1e-5)
    assert parsed[("dsort_jobs_total", (("outcome", "done"), ("tenant", "acme")))] == 3
    assert parsed[("dsort_jobs_in_flight", ())] == 0
    names = {dict(lb)["name"] for n, lb in parsed if n == "dsort_counter_total"}
    assert set(COUNTERS) <= names


def test_serve_session_scraped_over_http_matches_journal():
    """A serving session with telemetry behind `MetricsServer(port=0)`:
    the scrape's admission, cache and SLO series equal the journal's."""
    from dsort_tpu_torch.serve import SortService

    tel, journal = Telemetry(), EventLog()
    svc = SortService(8, "cpu", job=FAST, serve=ServeConfig(small_job_max=1 << 14),
                      telemetry=tel, journal=journal)
    rng = np.random.default_rng(2)
    with MetricsServer(tel, port=0) as srv:
        tickets = [svc.submit(rng.integers(0, 1000, 3000, dtype=np.int32),
                              tenant=["acme", "blue"][i % 2])[1] for i in range(6)]
        for t in tickets:
            t.result(timeout=60)
        svc.shutdown(drain=True)
        parsed = parse_prometheus_text(
            urllib.request.urlopen(srv.url, timeout=10).read().decode())
    truth = slo_from_journal([e.to_dict() for e in journal.events()])
    for (tenant, stage), hist in truth.items():
        key = ("dsort_job_stage_seconds", tuple(sorted(
            {"tenant": tenant, "stage": stage, "quantile": "0.95"}.items())))
        assert parsed[key] == pytest.approx(hist.quantile(0.95), rel=1e-5)
    assert parsed[("dsort_admissions_total", (("reason", "admitted"), ("tenant", "acme")))] == 3
    assert parsed[("dsort_counter_total", (("name", "fused_small_jobs"),))] == 6
    assert parsed[("dsort_queue_depth", ())] == 0


def test_slo_shed_rejects_over_target_and_recovers_after_drain():
    from dsort_tpu_torch.serve import SortService

    def slow(data, metrics, job_id=None):
        metrics.event("job_start", mode="local", n_keys=len(data))
        time.sleep(0.06)
        out = np.sort(data)
        metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
        return out

    tel, jl = Telemetry(), EventLog()
    svc = SortService(runner=slow, serve=ServeConfig(slo_shed_ms=5.0), telemetry=tel, journal=jl)
    data = np.arange(64, dtype=np.int32)
    tickets = [svc.submit(data, tenant="t")[1] for _ in range(4)]
    shed = None
    for _ in range(300):
        verdict, t = svc.submit(data, tenant="t")
        if not verdict.admitted:
            shed = verdict
            break
        tickets.append(t)
        time.sleep(0.02)
    assert shed is not None and shed.reason == "slo_shed"
    for t in tickets:
        t.result(timeout=60)
    time.sleep(0.05)
    verdict, t = svc.submit(data, tenant="t")
    assert verdict.admitted, verdict
    t.result(timeout=60)
    svc.shutdown()
    assert any(e.type == "job_rejected" and e.fields.get("reason") == "slo_shed"
               for e in jl.events())
    parsed = parse_prometheus_text(tel.render_prometheus())
    assert parsed[("dsort_admissions_total", (("reason", "slo_shed"), ("tenant", "t")))] >= 1


def test_failed_job_closes_on_telemetry():
    """A runner that raises after ``job_start``: the service closes the job
    with ``job_failed``, so jobs in flight return to 0."""
    from dsort_tpu_torch.serve import SortService

    def exploding(data, metrics, job_id=None):
        metrics.event("job_start", mode="spmd", n_keys=len(data))
        raise OSError("disk full mid-checkpoint")

    tel, jl = Telemetry(), EventLog()
    svc = SortService(runner=exploding, telemetry=tel, journal=jl)
    _, t = svc.submit(np.array([3, 1, 2], np.int32))
    with pytest.raises(OSError):
        t.result(timeout=30)
    svc.shutdown()
    snap = tel.snapshot()
    assert snap["jobs_in_flight"] == 0 and snap["jobs"] == {"default/failed": 1}
    assert "job_failed" in jl.types()


# -- the flight recorder -------------------------------------------------------------


def test_flight_recorder_ring_schema_and_names_match_jax(tmp_path):
    assert BUNDLE_SCHEMA_KEYS == jflight.BUNDLE_SCHEMA_KEYS
    assert RECOVERY_EVENTS == jflight.RECOVERY_EVENTS
    for etype, fields in (("mesh_reform", {"kind": "hang"}), ("checkpoint_restore",
                          {"kind": "shuffle_phase"}), ("coded_recover", {}),
                          ("parity_recover", {}), ("reassign", {"stage": "sort"}),
                          ("capacity_retry", {})):
        assert recovery_path_name(etype, fields) == jflight.recovery_path_name(etype, fields)
    assert config_snapshot(FAST)["settle_delay_s"] == 0.01
    rec = FlightRecorder(str(tmp_path), ring_size=4, state_fn=lambda: {"mode": "unit"},
                         config=FAST)
    m = Metrics()
    rec.attach(m)
    rec.attach(m)
    assert m.taps.count(rec) == 1
    for i in range(10):
        m.event("probe", worker=i, ok=True)
    assert len(rec.events()) == 4
    m.event("mesh_reform", survivors=7)
    (b,) = FlightRecorder.read_bundles(str(tmp_path))
    assert set(BUNDLE_SCHEMA_KEYS) <= set(b) and b["recovery_path"] == "mesh_reform"
    assert b["detail"]["survivors"] == 7 and b["state"] == {"mode": "unit"}
    assert b["ring"][-1]["type"] == "mesh_reform" and m.counters["flight_dumps"] == 1


def test_read_bundles_orders_by_dump_time(tmp_path):
    for name, t in (("flight_900_0001_reassign.json", 3.0),
                    ("flight_100_0001_mesh_reform.json", 2.0),
                    ("flight_500_0001_capacity_retry.json", 1.0)):
        (tmp_path / name).write_text(json.dumps({"t": t, "recovery_path": "x"}))
    assert [b["t"] for b in FlightRecorder.read_bundles(str(tmp_path))] == [1.0, 2.0, 3.0]


def _drill(case, tmp_path):
    """One recovery path through a port scheduler with a flight recorder;
    returns the bundles."""
    from dsort_tpu_torch.scheduler import (
        DeviceExecutor, FaultInjector, Scheduler, SpmdScheduler,
    )

    fdir = str(tmp_path / "flight")
    job = JobConfig(settle_delay_s=0.01, flight_recorder_dir=fdir)
    data = np.random.default_rng(2).integers(0, 10**6, 30_000).astype(np.int32)
    inj = FaultInjector()
    if case == "mesh_reform":
        inj.fail_once(2, "spmd")
        out = SpmdScheduler(8, "cpu", job, inj).sort(data, Metrics())
    elif case == "capacity_retry":
        data = np.full(30_000, 7, np.int32)
        job = JobConfig(settle_delay_s=0.01, capacity_factor=1.0, flight_recorder_dir=fdir)
        out = SpmdScheduler(8, "cpu", job).sort(data, Metrics())
    elif case == "reassign":
        inj.fail_once(1, "sort")
        out = Scheduler(DeviceExecutor(8, "cpu", inj), job).run_job(data, Metrics())
    elif case == "mid_ring":
        inj.fail_once(3, "ring")
        job = JobConfig(settle_delay_s=0.01, exchange="ring", flight_recorder_dir=fdir)
        out = SpmdScheduler(8, "cpu", job, inj).sort(data, Metrics())
    elif case == "handle":
        sched = SpmdScheduler(8, "cpu", job, inj)
        handle = sched.sort(data, Metrics(), keep_on_device=True)
        inj.fail_once(2, "spmd")
        sched.sort(data, Metrics())
        out = handle.to_host()
    else:  # checkpoint restore
        job = JobConfig(settle_delay_s=0.01, checkpoint_dir=str(tmp_path / "ck"),
                        flight_recorder_dir=fdir)
        SpmdScheduler(8, "cpu", job).sort(data, Metrics(), job_id="j1")
        out = SpmdScheduler(8, "cpu", job).sort(data, Metrics(), job_id="j1")
    np.testing.assert_array_equal(out, np.sort(data))
    return FlightRecorder.read_bundles(fdir)


@pytest.mark.parametrize("case,path", [
    ("mesh_reform", "mesh_reform"), ("capacity_retry", "capacity_retry"),
    ("reassign", "reassign"), ("mid_ring", "mesh_reform"),
    ("handle", "device_handle_invalidated"), ("restore", "checkpoint_restore:shuffle_phase"),
])
def test_flight_drill_each_recovery_path(case, path, tmp_path):
    bundles = _drill(case, tmp_path)
    b = next(b for b in bundles if b["recovery_path"] == path)
    assert set(BUNDLE_SCHEMA_KEYS) <= set(b)
    if case == "mesh_reform":
        assert b["detail"]["survivors"] == 7 and b["counters"]["mesh_reforms"] >= 1
        assert any(r["type"] == "worker_dead" and r.get("worker") == 2 for r in b["ring"])
        assert b["state"] == {"mode": "spmd", "devices": list(range(8)),
                              "live": [0, 1, 3, 4, 5, 6, 7]}
    elif case == "capacity_retry":
        assert b["detail"]["observed"] > 0 and b["detail"]["cap_pair"] > 0
    elif case == "reassign":
        assert b["detail"]["frm"] == 1 and b["state"]["mode"] == "taskpool"
    elif case == "mid_ring":
        assert any(r["type"] == "worker_dead" and r.get("stage") == "ring" for r in b["ring"])
    elif case == "handle":
        assert b["detail"]["reason"] == "mesh_reform" and b["detail"]["n"] == 1


def test_flight_bundle_keys_match_a_jax_drill(tmp_path):
    """The reference's mesh re-form drill at 2^15 keys and the port's: the
    same bundle keys, recovery path, detail and counter keys."""
    from dsort_tpu.config import JobConfig as JaxJobConfig
    from dsort_tpu.scheduler import FaultInjector as JaxInjector
    from dsort_tpu.scheduler import SpmdScheduler as JaxSpmd

    inj = JaxInjector()
    inj.fail_once(2, "spmd")
    jdir = str(tmp_path / "jax")
    data = np.random.default_rng(2).integers(0, 10**6, 30_000).astype(np.int32)
    JaxSpmd(job=JaxJobConfig(settle_delay_s=0.01, flight_recorder_dir=jdir),
            injector=inj).sort(data, JaxMetrics())
    (want,) = [b for b in jflight.FlightRecorder.read_bundles(jdir)
               if b["recovery_path"] == "mesh_reform"]
    got = next(b for b in _drill("mesh_reform", tmp_path) if b["recovery_path"] == "mesh_reform")
    assert set(got) == set(want)
    assert got["detail"].keys() == want["detail"].keys()
    assert got["state"].keys() == want["state"].keys() and got["state"]["live"] == want["state"]["live"]
    assert {k for k, v in got["counters"].items() if v} == {
        k for k, v in want["counters"].items() if v}
    assert set(config_snapshot(FAST)) <= set(want["config"])


# -- the first-call ledger and memwatch -------------------------------------------------


def test_ledger_labels_aggregates_and_journal_replay_match_jax():
    for key in (("fused", 81920, "int32", "auto"), ("spmd", 8, 100, (3, 4), "x,y"), "plain"):
        assert variant_label(key) == jprof.variant_label(key)
    assert LEDGER_EVENT_FIELDS == jprof.LEDGER_EVENT_FIELDS
    led = CompileLedger()
    led.record(("fused", 64, "int32", "lax"), 0.25, None, 512, argument=256, output=256, peak=640,
               temp=128)
    led.record(("fused", 64, "int32", "lax"), 0.15, None, 512, argument=256, output=256, peak=512)
    e = led.snapshot()["fused|64|int32|lax"]
    assert e["compiles"] == 2 and e["compile_s"] == pytest.approx(0.40)
    assert e["flops"] is None and e["peak_hbm_bytes"] == 640 and e["bytes_accessed"] == 512
    jl = EventLog()
    m = Metrics(journal=jl)
    assert led.drain_to(m) == 2 and led.pending() == 0
    led.record(("x",), 0.1)
    assert led.drain_to(Metrics()) == 0 and led.pending() == 1
    records = [ev.to_dict() for ev in jl.events()]
    assert ledger_from_journal(records) == {k: v for k, v in led.snapshot().items() if k != "x"}
    for ev in jl.events():
        assert set(LEDGER_EVENT_FIELDS) <= set(ev.fields)
    # A journal the reference wrote (XLA's flops included) replays alike.
    jled = jprof.CompileLedger()
    jled.record(("fused", 64, "int32", "lax"), 0.2, cost={"flops": 100.0, "bytes accessed": 640.0})
    jm = JaxMetrics(journal=JaxEventLog())
    jled.drain_to(jm)
    jrecords = [ev.to_dict() for ev in jm.journal.events()]
    assert ledger_from_journal(jrecords) == jprof.ledger_from_journal(jrecords)


def test_first_call_is_recorded_once_per_spec_and_scrape_equals_journal():
    """`instrument_first_call`: one record per (shapes, dtypes, device,
    stream) — a new row length is a new first call, a new count is not —
    and the scrape's ``dsort_variant_*`` gauges equal the journal replay;
    ``dsort_variant_flops`` is absent (not measurable without a compiler)."""
    import torch

    from dsort_tpu_torch.models.pipelines import _fused_small_fn, pad_for_fused, pad_rung
    from dsort_tpu_torch.serve.variants import VariantCache, fused_variant_key

    LEDGER.reset()
    _fused_small_fn.cache_clear()
    cache, jl = VariantCache(), EventLog()
    m = Metrics(journal=jl)
    rng = np.random.default_rng(6)
    for n in (1000, 5000, 1000, 1010):
        fn = cache.get_or_build(fused_variant_key(n, "int32", "lax"),
                                lambda n=n: _fused_small_fn(pad_rung(n), "int32", "lax"),
                                metrics=m)
        x = rng.integers(-100, 100, n).astype(np.int32)
        out = fn(torch.from_numpy(pad_for_fused(x)), n).numpy()[:n]
        np.testing.assert_array_equal(out, np.sort(x))
    LEDGER.drain_to(m)
    truth = ledger_from_journal([ev.to_dict() for ev in jl.events()])
    assert truth == LEDGER.snapshot()
    assert sorted(truth) == ["fused|1024|int32|lax", "fused|5120|int32|lax"]
    for label, e in truth.items():
        rung = int(label.split("|")[1])
        assert e["compiles"] == 1 and e["compile_s"] > 0 and e["flops"] is None
        assert e["argument_hbm_bytes"] == e["output_hbm_bytes"] == rung * 4
    parsed = parse_prometheus_text(Telemetry().render_prometheus())
    for label, e in truth.items():
        lab = (("variant", label),)
        assert parsed[("dsort_variant_compiles", lab)] == e["compiles"]
        assert parsed[("dsort_variant_compile_seconds", lab)] == pytest.approx(e["compile_s"],
                                                                              rel=1e-4)
        assert parsed[("dsort_variant_peak_hbm_bytes", lab)] == e["peak_hbm_bytes"]
        assert ("dsort_variant_flops", lab) not in parsed
    assert instrument_first_call(lambda x: x, lambda *a: ("t",))(3) == 3


def test_memwatch_tap_and_cpu_snapshot():
    import torch

    snaps = iter(range(100))

    def fake():
        return {"bytes_in_use": 1000 + next(snaps), "max_device_bytes": 500, "peak_bytes": 0,
                "devices": 2, "source": "fake"}

    jl = EventLog()
    m = Metrics(journal=jl)
    MemWatch(snapshot_fn=fake).attach(m)
    with PhaseTimer(m).phase("partition"):
        pass
    marks = [e for e in jl.events() if e.type == "hbm_watermark"]
    assert [e.fields["edge"] for e in marks] == ["start", "end"]
    assert m.counters["hbm_watermarks"] == 2 and len(jl.events()) == 4
    held = torch.zeros(1 << 20, dtype=torch.int32)
    snap = device_memory_snapshot("cpu")
    assert snap["source"] == "live_tensors" and snap["bytes_in_use"] >= held.nbytes
    assert set(snap) == {"bytes_in_use", "max_device_bytes", "peak_bytes", "devices", "source"}
