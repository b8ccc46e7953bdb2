"""The serving layer against the JAX package's.

The pure control plane — admission verdicts, the weighted DRR dequeue
order, `ControlPolicy` state, the variant cache's keys, LRU and counters,
`ServeConfig` / `SortConfig.from_mapping` — is driven step for step through
both packages on the same seeded sequences and must agree exactly.  The
port's `SortService(device="cpu")` runs the reference's serving tests (the
mixed workload, journal-derived fairness, SLO parity, the cache on the
metrics endpoint, prewarm, the fault drills, shutdown) and, in four tests,
beside the JAX `SortService` on its 8-device CPU mesh with the same
submissions (at most 2^12 keys): bit-identical outputs, equal per-job
counters and equal multisets of event types.  The JAX side journals
``variant_compiled`` for each XLA compile and the port for each first call
of a variant on a stream; both depend on what the process ran before, so
that event and its counter are left out of the comparison, as are the
timers' phase events.  ``cli serve``
is driven through stdin in both packages.
"""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest

from dsort_tpu import cli as jcli
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.config import ServeConfig as JaxServeConfig
from dsort_tpu.config import SortConfig as JaxSortConfig
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.serve import AdmissionController as JaxAdmissionController
from dsort_tpu.serve import ControlPolicy as JaxControlPolicy
from dsort_tpu.serve import DeficitRoundRobin as JaxDRR
from dsort_tpu.serve import SortService as JaxSortService
from dsort_tpu.serve import VariantCache as JaxVariantCache
from dsort_tpu.serve import parse_weights as jax_parse_weights
from dsort_tpu.serve.variants import fused_variant_key as jax_fused_key
from dsort_tpu.serve.variants import spmd_variant_key as jax_spmd_key
from dsort_tpu.utils import events as jevents
from dsort_tpu.utils.events import EventLog as JaxEventLog

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig, ServeConfig, SortConfig
from dsort_tpu_torch.obs import Telemetry
from dsort_tpu_torch.obs.telemetry import parse_prometheus_text
from dsort_tpu_torch.scheduler import FaultInjector, JobFailedError
from dsort_tpu_torch.serve import (
    ADMISSION_REASONS,
    Admission,
    AdmissionController,
    ControlPolicy,
    DeficitRoundRobin,
    ServiceClosed,
    SortService,
    VariantCache,
    fused_variant_key,
    parse_weights,
)
from dsort_tpu_torch.serve.variants import spmd_variant_key
from dsort_tpu_torch.utils import events
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

JOB = JobConfig(settle_delay_s=0.01)
SERVE = ServeConfig(small_job_max=1 << 14, max_tenant_inflight=32, max_queue_depth=128)
#: Left out of cross-package comparisons: the ledger's records depend on
#: what the process ran before, and the timers' phases follow each
#: package's own program structure (the port's sample sort times fewer
#: phases than the reference's jitted one).
LEDGER_EVENTS = {"variant_compiled", "phase_start", "phase_end"}
LEDGER_COUNTERS = {"variant_compiles"}
#: Which of two concurrent same-rung jobs looks its variant up first is a
#: race in both packages: the per-job comparison leaves the lookup's
#: outcome out and compares the lookups' total instead.
LOOKUP_COUNTERS = {"variant_cache_hits", "variant_cache_misses"}


def _svc(tmp=None, injector=None, telemetry=None, journal=None, start=True, serve=None,
         job=None):
    job = job or JOB
    if tmp is not None:
        job = dataclasses.replace(job, flight_recorder_dir=str(tmp))
    return SortService(8, "cpu", job=job, serve=serve or SERVE, telemetry=telemetry,
                       journal=journal, injector=injector, start=start)


def _events(journal):
    return [(e.type, e.fields) for e in journal.events()]


def _ints(rng, n, dtype=np.int32):
    return rng.integers(0, 1 << 30, n, dtype=dtype)


# -- admission control, DRR, the policy: step for step against the reference --


def test_admission_verdicts_match_jax():
    with pytest.raises(ValueError, match="unknown admission reason"):
        Admission(False, "because", "t", 0, 0)
    from dsort_tpu.serve import ADMISSION_REASONS as JAX_REASONS

    assert ADMISSION_REASONS == JAX_REASONS
    ctl = AdmissionController(max_queue_depth=2, max_tenant_inflight=1)
    v1 = ctl.consider("a", shutting_down=False)
    assert v1.admitted and v1.reason == "admitted" and v1.queue_depth == 1
    assert ctl.consider("a", shutting_down=False).reason == "tenant_limit"
    ctl.consider("b", shutting_down=False)
    assert ctl.consider("c", shutting_down=False).reason == "queue_full"
    assert ctl.consider("a", shutting_down=True).reason == "shutting_down"
    ctl.dequeued()
    ctl.finished("a")
    assert ctl.consider("a", shutting_down=False).admitted
    # A seeded operation sequence through both controllers: every verdict
    # and the state after every step agree.
    rng = np.random.default_rng(0)
    ours, theirs = AdmissionController(5, 2), JaxAdmissionController(5, 2)
    for _ in range(400):
        op, t = rng.integers(0, 5), f"t{rng.integers(0, 4)}"
        if op <= 1:
            kw = dict(shutting_down=bool(rng.random() < 0.05), shed=bool(rng.random() < 0.1),
                      no_capacity=bool(rng.random() < 0.05))
            assert ours.consider(t, **kw) == _as_port(theirs.consider(t, **kw))
        elif op == 2:
            ours.dequeued(), theirs.dequeued()
        elif op == 3:
            ours.finished(t), theirs.finished(t)
        else:
            ours.requeued(), theirs.requeued()
        assert ours.state_dict() == theirs.state_dict()


def _as_port(v):
    return Admission(v.admitted, v.reason, v.tenant, v.queue_depth, v.tenant_depth)


def test_parse_weights_matches_jax():
    for spec in ("acme=2, blue=1.5", None, "", "a=1,b=3"):
        assert parse_weights(spec) == jax_parse_weights(spec)
    for bad, msg in (("acme", "NAME=WEIGHT"), ("acme=0", "> 0")):
        with pytest.raises(ValueError, match=msg):
            parse_weights(bad)
        with pytest.raises(ValueError, match=msg):
            jax_parse_weights(bad)


def _drain(drr):
    out = []
    while (nxt := drr.pop()) is not None:
        out.append(nxt)
    return out


def _drr_case(case, cls):
    if case == "interleave":
        drr = cls(quantum=10)
        for i in range(6):
            drr.push("heavy", 10, f"h{i}")
        for i in range(2):
            drr.push("light", 10, f"l{i}")
        return _drain(drr)
    if case == "weights":
        drr = cls(quantum=10, weights={"gold": 2.0})
        for i in range(8):
            drr.push("gold", 10, i)
            drr.push("base", 10, i)
        return _drain(drr)
    if case == "big_banks_deficit":
        drr = cls(quantum=10)
        drr.push("big", 100, "B")
        for i in range(5):
            drr.push("small", 10, f"s{i}")
        return _drain(drr)
    if case == "idle_tenant":
        drr = cls(quantum=10)
        drr.push("a", 10, "a0")
        first = [drr.pop()]
        for i in range(3):
            drr.push("b", 10, f"b{i}")
        drr.push("a", 10, "a1")
        return first + _drain(drr)
    rng = np.random.default_rng(int(case.split("_")[1]))
    drr = cls(quantum=int(rng.integers(1, 5000)), weights={"t0": 3.0, "t2": 0.5})
    out = []
    for i in range(300):
        if rng.random() < 0.6:
            drr.push(f"t{rng.integers(0, 4)}", int(rng.integers(1, 20000)), i)
        else:
            out.append(drr.pop())
    return out + _drain(drr)


@pytest.mark.parametrize("case", ["interleave", "weights", "big_banks_deficit", "idle_tenant",
                                  "seeded_1", "seeded_2", "seeded_3"])
def test_drr_dequeue_order_matches_jax(case):
    order = _drr_case(case, DeficitRoundRobin)
    assert order == _drr_case(case, JaxDRR)
    tenants = [t for t, _ in (o for o in order if o is not None)]
    if case == "interleave":
        assert tenants[:4] == ["heavy", "light", "heavy", "light"] and len(tenants) == 8
    elif case == "weights":
        assert tenants[:8].count("gold") >= 5
    elif case == "big_banks_deficit":
        assert [i for _, i in order][-1] == "B"
    elif case == "idle_tenant":
        assert tenants[1:5].count("a") == 1


def test_control_policy_state_matches_jax():
    """Admission + DRR + SLO shedding as one state machine: the same
    operation sequence through both gives equal verdicts, dequeue order,
    shed decisions and `state_dict()` at every step; `load_state` of the
    reference's state resumes the same order."""
    rng = np.random.default_rng(3)
    kw = dict(max_queue_depth=6, max_tenant_inflight=3, drr_quantum_keys=4096,
              tenant_weights={"acme": 2.0}, slo_shed_ms=5.0)
    ours, theirs = ControlPolicy(**kw), JaxControlPolicy(**kw)
    for i in range(500):
        t = ["acme", "blue", "coral"][rng.integers(0, 3)]
        op = rng.integers(0, 6)
        if op <= 1:
            a, b = ours.consider(t), theirs.consider(t)
            assert (a.admitted, a.reason, a.queue_depth) == (b.admitted, b.reason, b.queue_depth)
            if a.admitted:
                cost = int(rng.integers(1, 20000))
                ours.push(t, cost, i), theirs.push(t, cost, i)
        elif op == 2:
            assert ours.pop() == theirs.pop()
        elif op == 3:
            w = float(rng.random() * 0.02)
            ours.note_wait(t, w), theirs.note_wait(t, w)
        elif op == 4:
            ours.finished(t), theirs.finished(t)
        else:
            assert ours.should_shed(t) == theirs.should_shed(t)
        assert ours.state_dict() == theirs.state_dict()
    resumed = ControlPolicy(**kw)
    resumed.load_state(theirs.state_dict())
    assert [resumed.pop() for _ in range(8)] == [theirs.pop() for _ in range(8)]


# -- the variant cache ----------------------------------------------------------


def test_variant_cache_lru_and_counters_match_jax():
    from dsort_tpu.utils.metrics import Metrics as JaxMetrics

    runs = []
    for cache_cls, metrics_cls in ((VariantCache, Metrics), (JaxVariantCache, JaxMetrics)):
        m, cache, built = metrics_cls(), cache_cls(max_entries=2), []

        def builder(tag):
            return lambda: built.append(tag) or tag

        got = [cache.get_or_build(("k", 1), builder(1), metrics=m),
               cache.get_or_build(("k", 1), builder("dup"), metrics=m),
               cache.get_or_build(("k", 2), builder(2), metrics=m),
               cache.get_or_build(("k", 3), builder(3), metrics=m),
               cache.get_or_build(("k", 1), builder("again"), metrics=m),
               cache.note(("k", 3), metrics=m), cache.note(("k", 9), metrics=m)]
        runs.append((got, built, cache.stats(), dict(m.counters), cache.keys(), cache.hit_rate()))
    assert runs[0] == runs[1]
    got, built, stats, counters, keys, _ = runs[0]
    assert built == [1, 2, 3, "again"] and stats["evictions"] == 3
    assert counters["variant_cache_hits"] == 2 and counters["variant_cache_misses"] == 5


def test_variant_cache_prewarm_counts_separately():
    for cache in (VariantCache(max_entries=8), JaxVariantCache(max_entries=8)):
        assert cache.prewarm(("k", 1), lambda: "v") == ("v", True)
        assert cache.prewarm(("k", 1), lambda: "v2") == ("v", False)
        st = cache.stats()
        assert st["prewarmed"] == 1 and st["misses"] == 0
        assert cache.get_or_build(("k", 1), lambda: "v3") == "v"
        assert cache.stats()["hits"] == 1


def test_variant_keys_match_jax():
    from dsort_tpu.parallel.exchange import ladder_rungs as jax_ladder

    from dsort_tpu_torch.models.pipelines import pad_rung
    from dsort_tpu_torch.parallel.exchange import ladder_rungs

    assert ladder_rungs(1 << 16, lo=8) == jax_ladder(1 << 16, lo=8)
    rungs = ladder_rungs(1 << 16, lo=8)
    assert all(pad_rung(r) == r for r in rungs)
    for n in (1, 7, 9, 100, 5000, 5100, 12345, 65535, 1 << 19, (1 << 20) - 1):
        for dt in ("int32", "int64", "float32"):
            for kernel in ("auto", "pallas"):
                assert fused_variant_key(n, dt, kernel) == jax_fused_key(n, dt, kernel)
        for p, exch in ((8, "alltoall"), (7, "fused"), (4, "ring")):
            assert spmd_variant_key(n, p, "int32", "auto", 1.3, exch) == jax_spmd_key(
                n, p, "int32", "auto", 1.3, exch)
    assert fused_variant_key(5000, "int32", "auto") == fused_variant_key(5100, "int32", "auto")


# -- config -----------------------------------------------------------------------


CONF_MAPS = [
    {},
    {"SERVE_QUEUE_DEPTH": "9", "SERVE_TENANT_INFLIGHT": "3", "SERVE_SLICE_DEVICES": "2",
     "SERVE_WEIGHTS": "acme=2", "SERVE_PREWARM": "1"},
    {"SERVE_PREWARM": "all", "SERVE_SLO_SHED_MS": "40", "SERVE_SMALL_JOB_MAX": "4096",
     "EXCHANGE": "ring", "REDUNDANCY": "2", "REDUNDANCY_MODE": "parity", "AUTOTUNE": "1",
     "TENANT": "acme", "FLIGHT_DIR": "/tmp/f", "KEY_DTYPE": "int64", "NUM_WORKERS": "4",
     "DP": "2", "EXTERNAL_WAVE_ELEMS": "65536", "EXTERNAL_RUN_ELEMS": "1024",
     "EXTERNAL_MESH": "8", "HIER_HOSTS": "2", "OVERSAMPLE": "16", "CAPACITY_FACTOR": "2.0",
     "HEARTBEAT_TIMEOUT_S": "3", "CHECKPOINT_DIR": "/tmp/c", "LOCAL_KERNEL": "pallas",
     "MERGE_KERNEL": "sort", "SERVER_IP": "10.0.0.1", "SERVER_PORT": "9100",
     "OUTPUT_PATH": "o.txt"},
]
BAD_MAPS = [{"SERVE_QUEUE_DEPTH": "0"}, {"SERVE_SLICE_DEVICES": "0"},
            {"SERVE_WEIGHTS": "acme=-1"}, {"SERVE_SLO_SHED_MS": "-2"},
            {"TENANT": "a b"}, {"EXCHANGE": "bogus"}, {"NUM_WORKERS": "0"}]


@pytest.mark.parametrize("m", CONF_MAPS + BAD_MAPS)
def test_sort_config_from_mapping_matches_jax(m):
    try:
        want = JaxSortConfig.from_mapping(m)
    except ValueError as e:  # the reference refuses: so must the port, on the same field
        with pytest.raises(ValueError) as got:
            SortConfig.from_mapping(m)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value).split(" must")[0] == str(e).split(" must")[0]
        return
    got = SortConfig.from_mapping(m)
    assert dataclasses.asdict(got.serve) == dataclasses.asdict(want.serve)
    assert got.job == JobConfig.from_dict(dataclasses.asdict(want.job))
    assert dataclasses.asdict(got.external) == dataclasses.asdict(want.external)
    assert (got.mesh.num_workers, got.mesh.dp) == (want.mesh.num_workers, want.mesh.dp)
    assert (got.server_ip, got.server_port, got.output_path) == (
        want.server_ip, want.server_port, want.output_path)


def test_serve_config_validation_conf_file_and_fleet_refusal(tmp_path):
    for bad in (dict(max_queue_depth=0), dict(slice_devices=0), dict(tenant_weights={"a": -1}),
                dict(prewarm_policy="some"), dict(prewarm_min_keys=10, prewarm_max_keys=5)):
        with pytest.raises(ConfigError):
            ServeConfig(**bad)
        with pytest.raises(Exception):
            JaxServeConfig(**bad)
    conf = tmp_path / "server.conf"
    conf.write_text("# the reference's keys\nSERVER_IP=127.0.0.1\nSERVER_PORT = 9008\n\n"
                    "SERVE_WEIGHTS=acme=2\n")
    got, want = SortConfig.from_conf_file(conf), JaxSortConfig.from_conf_file(conf)
    assert dataclasses.asdict(got.serve) == dataclasses.asdict(want.serve)
    assert got.serve.tenant_weights == {"acme": 2.0}
    # The FLEET_* keys parse as the reference's (the fleet plane is ported).
    fleet = {"FLEET_AGENTS": "a:1", "FLEET_ROUTING": "random"}
    assert dataclasses.asdict(SortConfig.from_mapping(fleet).fleet) == dataclasses.asdict(
        JaxSortConfig.from_mapping(fleet).fleet)
    with pytest.raises(ConfigError, match="routing"):
        SortConfig.from_mapping({"FLEET_ROUTING": "mystery"})
    with pytest.raises(ConfigError, match="not found"):
        SortConfig.from_conf_file(tmp_path / "missing.conf")
    (tmp_path / "bad.conf").write_text("NOEQUALS\n")
    with pytest.raises(ConfigError, match="expected KEY=value"):
        SortConfig.from_conf_file(tmp_path / "bad.conf")


def test_serve_events_and_counters_registered_as_jax():
    for etype in ("job_admitted", "job_rejected", "job_dequeued", "job_evicted",
                  "job_readmitted", "slice_retired", "variant_prewarm", "serve_drain",
                  "serve_stop", "flight_dump", "variant_compiled", "hbm_watermark",
                  "plan_decision", "plan_override"):
        assert events.EVENT_TYPES[etype] == jevents.EVENT_TYPES[etype]
    for c in ("jobs_admitted", "jobs_rejected", "jobs_readmitted", "slice_dispatches",
              "fullmesh_dispatches", "variant_cache_hits", "variant_cache_misses",
              "variant_cache_evictions", "variant_cache_prewarms", "variant_compiles",
              "hbm_watermarks", "flight_dumps", "plan_decisions", "plan_overrides"):
        assert events.COUNTERS[c] == jevents.COUNTERS[c]


# -- the serving core on the CPU ------------------------------------------------------


def test_service_rejects_beyond_queue_depth():
    journal, tel = EventLog(), Telemetry()
    svc = SortService(8, "cpu", job=JOB, serve=ServeConfig(
        max_queue_depth=3, max_tenant_inflight=2, small_job_max=1 << 14),
        telemetry=tel, journal=journal, start=False)
    data = np.arange(100, dtype=np.int32)
    reasons = [svc.submit(data, tenant=f"t{i}")[0].reason for i in range(5)]
    assert reasons[:3] == ["admitted"] * 3 and set(reasons[3:]) <= {"queue_full", "tenant_limit"}
    assert not svc.submit(data, tenant="t0")[0].admitted
    svc.shutdown(drain=True)
    types = [t for t, _ in _events(journal)]
    assert types.count("job_admitted") == 3 and types.count("job_rejected") == 3
    snap = tel.snapshot()
    assert sum(snap["admissions"].values()) == 6 and snap["admissions"]["t0/admitted"] == 1


def test_mixed_workload_bit_identical_and_cached():
    """Small jobs across three tenants and one big job, concurrently: every
    output equal to np.sort, the repeat-size hit rate at least 0.5, the big
    job on the whole mesh and the small ones on slices."""
    journal, tel = EventLog(), Telemetry()
    svc = _svc(telemetry=tel, journal=journal)
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(9):
        d = _ints(rng, 3000 + (i % 2) * 200)
        jobs.append((d, svc.submit(d, tenant=f"tenant{i % 3}")[1]))
    big = _ints(rng, 1 << 15)
    jobs.append((big, svc.submit(big, tenant="tenant0")[1]))
    for d, t in jobs:
        np.testing.assert_array_equal(t.result(timeout=120), np.sort(d))
    assert svc.variants.hit_rate() >= 0.5
    assert svc.stats()["done"] == 10 and svc.stats()["failed"] == 0
    svc.shutdown(drain=True)
    types = [t for t, _ in _events(journal)]
    assert types.count("job_admitted") == types.count("job_done") == types.count(
        "result_fetch") == 10
    deq = [f for t, f in _events(journal) if t == "job_dequeued"]
    assert sum(f["big"] for f in deq) == 1 and sum(not f["big"] for f in deq) == 9
    assert tel.snapshot()["gauges"]["slices_free"] == 8


@pytest.mark.parametrize("weights,want", [({}, None), ({"gold": 2.0}, "gold")])
def test_fair_order_from_journal(weights, want):
    """One slice (``slice_devices=8``): strictly serial dispatch, so the
    journal's dequeue order is the DRR order — a heavy tenant's backlog
    starves nobody, and a weight-2 tenant gets about twice the share."""
    journal = EventLog()
    svc = SortService(8, "cpu", job=JOB, serve=ServeConfig(
        small_job_max=1 << 14, max_tenant_inflight=64, max_queue_depth=128, slice_devices=8,
        tenant_weights=weights), journal=journal, start=False)
    rng = np.random.default_rng(1)
    if want is None:
        for tenant, k in (("heavy", 8), ("light", 2)):
            for _ in range(k):
                svc.submit(rng.integers(0, 1000, 5000, dtype=np.int32), tenant=tenant)
    else:
        for _ in range(6):
            svc.submit(rng.integers(0, 1000, 8000, dtype=np.int32), tenant="gold")
            svc.submit(rng.integers(0, 1000, 8000, dtype=np.int32), tenant="base")
    svc.start()
    svc.shutdown(drain=True)
    deq = [f for t, f in _events(journal) if t == "job_dequeued"]
    order = [f["tenant"] for f in deq]
    if want is None:
        assert len(order) == 10 and order.index("light") < 4, order
        waits = {}
        for f in deq:
            waits.setdefault(f["tenant"], []).append(f["wait_s"])
        p95 = {t: float(np.percentile(w, 95)) for t, w in waits.items()}
        assert max(p95.values()) <= 3 * max(min(p95.values()), 1e-9) + 0.5
    else:
        assert order[:6].count("gold") >= 4


def test_queue_wait_is_the_admit_to_dispatch_slo():
    from dsort_tpu_torch.obs.slo import slo_from_journal

    journal, tel = EventLog(), Telemetry()
    svc = _svc(telemetry=tel, journal=journal)
    rng = np.random.default_rng(3)
    tickets = [svc.submit(rng.integers(0, 1000, 4000, dtype=np.int32), tenant="acme")[1]
               for _ in range(3)]
    for t in tickets:
        t.result(timeout=60)
    svc.shutdown(drain=True)
    truth = slo_from_journal([e.to_dict() for e in journal.events()])
    scrape = parse_prometheus_text(tel.render_prometheus())
    for q in (0.5, 0.95, 0.99):
        key = ("dsort_job_stage_seconds", tuple(sorted({
            "tenant": "acme", "stage": "admit_to_dispatch", "quantile": str(q)}.items())))
        assert scrape[key] == pytest.approx(
            truth[("acme", "admit_to_dispatch")].quantile(q), rel=1e-5)


def test_cache_stats_reach_metrics_endpoint():
    tel = Telemetry()
    svc = _svc(telemetry=tel)
    svc.prewarm(sizes=[4000])
    rng = np.random.default_rng(4)
    for _ in range(2):
        svc.submit(rng.integers(0, 1000, 4000, dtype=np.int32))[1].result(60)
    svc.shutdown(drain=True)
    scrape = parse_prometheus_text(tel.render_prometheus())
    assert scrape[("dsort_variant_cache_entries", ())] >= 1
    assert scrape[("dsort_variant_cache_prewarmed", ())] == 1
    assert scrape[("dsort_variant_cache_hits", ())] == 2
    for name, want in (("variant_cache_prewarms", 1), ("variant_cache_hits", 2),
                       ("jobs_admitted", 2), ("slice_dispatches", 2)):
        assert scrape[("dsort_counter_total", (("name", name),))] == want


def test_prewarm_runs_each_rung_once_per_slice_stream():
    from dsort_tpu_torch.models.pipelines import _fused_small_fn
    from dsort_tpu_torch.obs.prof import LEDGER

    LEDGER.reset()
    _fused_small_fn.cache_clear()  # a fresh variant has seen no call yet
    journal = EventLog()
    svc = _svc(journal=journal)
    assert svc.prewarm(sizes=[3000, 3050, 9000]) == 2
    assert svc.prewarm(sizes=[3000]) == 0
    rng = np.random.default_rng(5)
    d = rng.integers(0, 1000, 3050, dtype=np.int32)
    np.testing.assert_array_equal(svc.submit(d)[1].result(60), np.sort(d))
    st = svc.variants.stats()
    assert st["prewarmed"] == 2 and st["hits"] >= 1 and st["misses"] == 0
    svc.shutdown(drain=True)
    # On the CPU there is no stream: one first call per rung is recorded.
    compiled = [f["variant"] for t, f in _events(journal) if t == "variant_compiled"]
    assert sorted(compiled) == ["fused|10240|int32|auto", "fused|3072|int32|auto"]
    assert [f for t, f in _events(journal) if t == "variant_prewarm"][0]["rungs"] == [3072, 10240]


# -- fault drills ----------------------------------------------------------------------


def test_fault_drill_concurrent_jobs_two_tenants(tmp_path):
    """A slice loss and a full-mesh loss with jobs of two tenants queued:
    every job completes exactly; the evicted job goes around the loop once
    (one flight bundle per eviction), the big job re-forms (its own)."""
    from dsort_tpu_torch.obs.flight import FlightRecorder

    inj, journal = FaultInjector(), EventLog()
    svc = _svc(tmp=tmp_path, injector=inj, journal=journal, start=False)
    rng = np.random.default_rng(6)
    inj.fail_once(0, "slice")
    inj.fail_once(2, "spmd")
    jobs = [(d := _ints(rng, 3000), svc.submit(d, tenant=["acme", "blue"][i % 2])[1])
            for i in range(4)]
    big = _ints(rng, 1 << 15)
    jobs.append((big, svc.submit(big, tenant="acme")[1]))
    svc.start()
    for d, t in jobs:
        np.testing.assert_array_equal(t.result(timeout=120), np.sort(d))
    svc.shutdown(drain=True)
    evs = _events(journal)
    evicted = {f["job"] for t, f in evs if t == "job_evicted"}
    assert len(evicted) == 1
    seq = [t for t, f in evs if f.get("job") == next(iter(evicted))]
    assert seq.index("job_evicted") < seq.index("job_readmitted") < seq.index("job_done")
    assert seq.count("job_dequeued") == 2 and seq.count("attempt_start") == 2
    bundles = FlightRecorder.read_bundles(str(tmp_path))
    ev_b = [b for b in bundles if b["recovery_path"] == "job_evicted"]
    assert len(ev_b) == 1 and ev_b[0]["state"]["mode"] == "serve"
    assert ev_b[0]["detail"]["tenant"] in ("acme", "blue")
    assert len([b for b in bundles if b["recovery_path"].startswith("mesh_reform")]) == 1


def test_slice_retired_after_dead_probe():
    inj, journal = FaultInjector(), EventLog()
    svc = _svc(injector=inj, journal=journal, start=False)
    inj.fail_once(0, "slice")
    inj.fail_once(0, "probe")
    d = _ints(np.random.default_rng(7), 3000)
    _, t = svc.submit(d, tenant="acme")
    svc.start()
    np.testing.assert_array_equal(t.result(timeout=60), np.sort(d))
    svc.shutdown(drain=True)
    assert "slice_retired" in journal.types() and svc.stats()["slices"] == 7


def test_fullmesh_reform_retires_dead_slice():
    inj, journal = FaultInjector(), EventLog()
    svc = _svc(injector=inj, journal=journal)
    rng = np.random.default_rng(11)
    inj.kill(5)
    big = _ints(rng, 1 << 15)
    np.testing.assert_array_equal(svc.submit(big, tenant="acme")[1].result(60), np.sort(big))
    assert svc.stats()["slices"] == 7
    retired = [f for t, f in _events(journal) if t == "slice_retired"]
    assert retired and retired[0]["reason"] == "mesh_reform"
    d = _ints(rng, 3000)
    np.testing.assert_array_equal(svc.submit(d, tenant="blue")[1].result(60), np.sort(d))
    svc.shutdown(drain=True)


def test_slice_hang_is_evicted_within_its_bound():
    """A stalled slice is caught by the bounded wait (`ProgramWaitTimeout`)
    and the job re-admitted; it completes once the stall ends."""
    import time

    inj, journal = FaultInjector(), EventLog()
    job = dataclasses.replace(JOB, heartbeat_timeout_s=0.3, exec_allowance_floor_s=0.3,
                              compile_grace_s=0.4, exec_allowance_keys_per_s=1e9)
    svc = _svc(injector=inj, journal=journal, job=job, start=False)
    inj.hang_once(0, "slice", seconds=2.5)
    d = _ints(np.random.default_rng(8), 3000)
    t0 = time.monotonic()
    _, t = svc.submit(d, tenant="acme")
    svc.start()
    np.testing.assert_array_equal(t.result(timeout=60), np.sort(d))
    svc.shutdown(drain=True)
    ev = [f for tp, f in _events(journal) if tp == "job_evicted"]
    assert ev and "wait exceeded" in ev[0]["reason"]
    first = next(e.mono for e in journal.events() if e.type == "job_evicted")
    assert first - t0 < 2.0  # evicted at the bound, before the stall ended


def test_lost_card_retires_every_slice_and_fails_queued_jobs(monkeypatch):
    """One card, one context: a slice probe that fails while the card's
    own probe fails too retires every free slice; the jobs that ran fail,
    the queued one fails with 'no live mesh slices remain', nothing hangs,
    and nothing re-sorts on the host."""
    from dsort_tpu_torch.models import pipelines

    journal = EventLog()
    svc = _svc(journal=journal, start=False,
               serve=dataclasses.replace(SERVE, slice_devices=4))
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(pipelines, "_fused_small_fn", lambda *a: broken)
    monkeypatch.setattr(svc._sched, "_probe_device", lambda idx: False)
    monkeypatch.setattr(svc._sched, "probe_card", lambda: False)
    rng = np.random.default_rng(12)
    tickets = [svc.submit(_ints(rng, 2000), tenant="acme")[1] for _ in range(3)]
    svc.start()
    with pytest.raises(RuntimeError, match="device-side assert"):
        tickets[0].result(timeout=60)
    # The second job ran on the other slice before the card was declared
    # lost, or found no slice left; the third finds none.
    with pytest.raises((RuntimeError, JobFailedError)):
        tickets[1].result(timeout=60)
    with pytest.raises(JobFailedError, match="no live mesh slices"):
        tickets[2].result(timeout=60)
    assert svc.shutdown(drain=True, timeout=60)
    assert 1 <= len(calls) <= 2 and svc.stats()["slices"] == 0
    assert len([f for tp, f in _events(journal) if tp == "slice_retired"]) == 2


def test_evicted_coded_job_completes_from_replicas(tmp_path):
    """Runner mode: a coded job's mid-ring loss evicts it, and the
    re-dispatch completes from the replica snapshot — the runner runs once."""
    from dsort_tpu_torch.obs.flight import FlightRecorder
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.scheduler import WorkerFailure

    journal = EventLog()
    job = JobConfig(exchange="ring", redundancy=2, settle_delay_s=0.01,
                    flight_recorder_dir=str(tmp_path))
    ss = SampleSort(VirtualMesh(8, "cpu"), job)
    armed, calls = [True], []

    def hook():
        if armed[0]:
            armed[0] = False
            e = WorkerFailure(3, "ring")
            e.workers = [3]
            raise e

    ss.fault_hook = hook

    def runner(data, metrics, job_id=None):
        calls.append(1)
        return ss.sort(data, metrics)

    svc = SortService(job=job, journal=journal, runner=runner, start=False)
    data = _ints(np.random.default_rng(13), 20_000)
    _, t = svc.submit(data, tenant="acme")
    svc.start()
    np.testing.assert_array_equal(t.result(timeout=60), np.sort(data))
    svc.shutdown(drain=True)
    types = journal.types()
    assert len(calls) == 1 and types.count("job_dequeued") == 2
    assert types.index("job_readmitted") < types.index("coded_recover") < types.index("job_done")
    paths = [b["recovery_path"] for b in FlightRecorder.read_bundles(str(tmp_path))]
    assert paths.count("job_evicted") == 1 and paths.count("coded_reconstruct") == 1


# -- shutdown ----------------------------------------------------------------------


def test_shutdown_drains_queued_jobs():
    journal = EventLog()
    svc = _svc(journal=journal, start=False)
    rng = np.random.default_rng(8)
    jobs = [(d := rng.integers(0, 1000, 3000, dtype=np.int32), svc.submit(d, tenant="acme")[1])
            for _ in range(4)]
    assert svc.shutdown(drain=True, timeout=60)
    for d, t in jobs:
        assert t.done()
        np.testing.assert_array_equal(t.result(), np.sort(d))
    types = journal.types()
    assert "serve_drain" in types and types[-1] == "serve_stop" and types.count("job_done") == 4
    v, none = svc.submit(np.arange(3, dtype=np.int32))
    assert none is None and v.reason == "shutting_down"


def test_shutdown_no_drain_fails_queued_with_verdict():
    journal = EventLog()
    svc = _svc(journal=journal, start=False)
    _, t = svc.submit(np.arange(1000, dtype=np.int32), tenant="acme")
    svc.shutdown(drain=False, timeout=60)
    with pytest.raises(ServiceClosed):
        t.result(timeout=10)
    types = journal.types()
    assert "job_failed" in types and types[-1] == "serve_stop"


def test_shutdown_racing_submit_strands_no_ticket():
    svc = _svc(journal=EventLog())
    results, gate = [], threading.Barrier(5)

    def submitter(i):
        d = np.arange(2000 + i, dtype=np.int32)
        gate.wait()
        v, t = svc.submit(d, tenant="racer")
        if v.admitted:
            results.append((d, t))

    ths = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
    for th in ths:
        th.start()
    gate.wait()
    assert svc.shutdown(drain=True, timeout=60)
    for th in ths:
        th.join()
    for d, t in results:
        np.testing.assert_array_equal(t.result(timeout=30), np.sort(d))


# -- against the JAX SortService -------------------------------------------------------


def _per_job(journal_events):
    """``{job ordinal: [event types]}`` without the ledger's events."""
    out = {}
    for etype, fields in journal_events:
        if etype not in LEDGER_EVENTS and "job" in fields:
            out.setdefault(fields["job"], []).append(etype)
    return out


def _run_both(submissions, serve_kw, arm=None, tmp_path=None):
    """The same submissions through both services (start=False, then
    start): ``[(outputs, per-job counters, event-type multiset, per-job
    sequences in submission order), ...]`` for (port, jax)."""
    res = []
    for port in (True, False):
        journal = EventLog() if port else JaxEventLog()
        inj = FaultInjector() if port else JaxFaultInjector()
        if arm is not None:
            arm(inj)
        if port:
            svc = SortService(8, "cpu", job=JOB, serve=ServeConfig(**serve_kw), journal=journal,
                              injector=inj, start=False)
        else:
            svc = JaxSortService(job=JaxJobConfig(settle_delay_s=0.01),
                                 serve=JaxServeConfig(**serve_kw), journal=journal,
                                 injector=inj, start=False)
        tickets = [svc.submit(d, tenant=tn)[1] for tn, d in submissions]
        svc.start()
        outs = [t.result(timeout=300) for t in tickets]
        counters = [{k: v for k, v in t.metrics.counters.items()
                     if v and k not in LEDGER_COUNTERS | LOOKUP_COUNTERS} for t in tickets]
        counters.append(sum(t.metrics.counters.get(k, 0)
                            for t in tickets for k in LOOKUP_COUNTERS))
        assert svc.shutdown(drain=True, timeout=120)
        evs = [(e.type, e.fields) for e in journal.events()]
        multiset = Counter(t for t, _ in evs if t not in LEDGER_EVENTS)
        ords = [t.metrics._job_ordinal() for t in tickets]
        per_job = _per_job(evs)
        res.append((outs, counters, multiset, [per_job[o] for o in ords]))
    return res


def _mixed(seed):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(1500) * 100).astype(np.float32)
    f[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    return [("acme", rng.integers(-1 << 31, 1 << 31, 1000, dtype=np.int64).astype(np.int32)),
            ("blue", rng.integers(-1 << 62, 1 << 62, 1200, dtype=np.int64)),
            ("coral", f),
            ("acme", rng.integers(0, 1 << 30, 1004, dtype=np.int32)),
            ("blue", rng.integers(0, 1 << 30, 1 << 12, dtype=np.int32)),
            ("coral", np.zeros(0, np.int32))]


def test_service_matches_jax_on_mixed_submissions():
    """Small int32 / int64 / float32 (NaN, ±0.0) jobs, an empty one and a
    big one (``small_job_max`` 2^11, so 2^12 keys take the whole mesh):
    outputs bit-identical, per-job counters and event-type multisets equal."""
    (p_out, p_cnt, p_ms, p_seq), (j_out, j_cnt, j_ms, j_seq) = _run_both(
        _mixed(20), dict(small_job_max=1 << 11, max_tenant_inflight=32, max_queue_depth=64))
    for a, b in zip(p_out, j_out):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    assert p_cnt == j_cnt
    assert p_ms == j_ms
    assert p_seq == j_seq


def test_eviction_drill_matches_jax():
    """``fail_once(0, "slice")`` and ``fail_once(2, "spmd")`` on both: the
    same job is evicted and re-admitted, the big job re-forms, and every
    job's event sequence and counters agree."""
    def arm(inj):
        inj.fail_once(0, "slice")
        inj.fail_once(2, "spmd")

    rng = np.random.default_rng(21)
    subs = [(t, rng.integers(0, 1 << 30, 1500, dtype=np.int32)) for t in ("acme", "blue") * 2]
    subs.append(("acme", rng.integers(0, 1 << 30, 1 << 12, dtype=np.int32)))
    (p_out, p_cnt, p_ms, p_seq), (j_out, j_cnt, j_ms, j_seq) = _run_both(
        subs, dict(small_job_max=1 << 11, max_tenant_inflight=32, max_queue_depth=64), arm)
    for a, b in zip(p_out, j_out):
        np.testing.assert_array_equal(a, b)
    assert p_cnt == j_cnt and p_ms == j_ms and p_seq == j_seq
    assert p_ms["job_evicted"] == 1 and p_ms["mesh_reform"] == 1


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_matches_jax(drain):
    rng = np.random.default_rng(22)
    subs = [("acme", rng.integers(0, 1000, 1000, dtype=np.int32)) for _ in range(3)]
    got = []
    for port in (True, False):
        journal = EventLog() if port else JaxEventLog()
        if port:
            svc = _svc(journal=journal, start=False)
        else:
            svc = JaxSortService(job=JaxJobConfig(settle_delay_s=0.01),
                                 serve=JaxServeConfig(small_job_max=1 << 14), journal=journal,
                                 start=False)
        tickets = [svc.submit(d, tenant=t)[1] for t, d in subs]
        assert svc.shutdown(drain=drain, timeout=120)
        late = svc.submit(subs[0][1])[0]
        outcomes = []
        for t in tickets:
            try:
                outcomes.append(("ok", t.result(timeout=30).tolist()))
            except Exception as e:
                outcomes.append((type(e).__name__, None))
        types = [e.type for e in journal.events() if e.type not in LEDGER_EVENTS]
        drain_ev = next(e.fields for e in journal.events() if e.type == "serve_drain")
        got.append((outcomes, Counter(types), types[-1], late.reason,
                    {k: drain_ev[k] for k in ("drain", "queued", "in_flight")}))
    assert got[0] == got[1]
    # The late submission is journaled after the close: rejected.
    assert got[0][2] == "job_rejected" and got[0][3] == "shutting_down"


# -- cli serve ----------------------------------------------------------------------------


def _write_keys(path, data):
    path.write_text("".join(f"{int(x)}\n" for x in data))


def test_parse_serve_line_and_sigterm_match_jax():
    for line in ("a.txt", "tenant=acme  b.txt ", "  exit ", "tenant=x", ""):
        assert cli._parse_serve_line(line, "d") == jcli._parse_serve_line(line, "d")
    with pytest.raises(KeyboardInterrupt):
        cli._sigterm_to_interrupt(15, None)


def test_cli_serve_matches_jax(tmp_path, monkeypatch):
    """Both CLIs fed the same ``tenant=NAME path`` lines through stdin, the
    last read raising KeyboardInterrupt (the SIGINT path): exit 0, the same
    output file, the journal closed with ``serve_drain`` then
    ``serve_stop``; an unreadable input and an unwritable output path do
    not stop either server."""
    rng = np.random.default_rng(10)
    files = []
    for i in range(3):
        p = tmp_path / f"in{i}.txt"
        _write_keys(p, rng.integers(-10**6, 10**6, 1500 + 100 * i))
        files.append(p)
    lines_src = [f"tenant=acme {files[0]}", f"tenant=blue {files[1]}",
                 str(tmp_path / "missing.txt"), f"tenant=acme {files[2]}"]
    outs = {}
    for port, main in ((True, cli.main), (False, jcli.main)):
        lines = iter(lines_src)

        def fake_input(prompt=""):
            try:
                return next(lines)
            except StopIteration:
                raise KeyboardInterrupt

        monkeypatch.setattr("builtins.input", fake_input)
        out, jpath = tmp_path / f"out_{port}.txt", tmp_path / f"j_{port}.jsonl"
        argv = ["serve", "-o", str(out), "--journal", str(jpath), "--max-in-flight", "4",
                "--metrics-port", "0", "--dtype", "int64"]
        assert main(argv + (["--device", "cpu"] if port else [])) == 0
        outs[port] = out.read_bytes()
        recs = (EventLog if port else JaxEventLog).read_jsonl(str(jpath))
        types = [r["type"] for r in recs]
        assert types.count("job_done") == 3 and types[-1] == "serve_stop"
        assert types.index("serve_drain") < types.index("serve_stop")
        assert {r["tenant"] for r in recs if r["type"] == "job_admitted"} == {"acme", "blue"}
        # An unwritable output path (a directory): logged, the server serves on.
        lines = iter([str(files[0]), "exit"])
        assert main(["serve", "-o", str(tmp_path), "--mode", "local"]
                    + (["--device", "cpu"] if port else [])) == 0
    assert outs[True] == outs[False]
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "out_True.txt", dtype=np.int64),
                                  np.sort(np.loadtxt(files[2], dtype=np.int64)))


def test_cli_serve_modes_and_config_flags(tmp_path, monkeypatch):
    """``--mode taskpool`` / ``local`` wrap their sorter as the runner;
    ``--weights``, ``--queue-limit``, ``--slice-devices`` and ``--prewarm
    all`` reach the service; ``--no-autotune`` journals no planner
    decision, autotune (the default) journals the slice-width decision."""
    d = np.random.default_rng(14).integers(0, 10**6, 3000)
    inp = tmp_path / "in.txt"
    _write_keys(inp, d)
    for mode, extra, want_plan in (("taskpool", ["--no-autotune"], False),
                                   ("local", [], False),
                                   ("spmd", ["--weights", "acme=2", "--queue-limit", "5",
                                             "--prewarm", "all", "--slice-devices", "2"], True),
                                   ("spmd", [], True)):
        lines = iter([f"tenant=acme {inp}", "exit"])
        monkeypatch.setattr("builtins.input", lambda *_: next(lines))
        out, jp = tmp_path / f"o_{mode}.txt", tmp_path / f"j_{mode}.jsonl"
        assert cli.main(["serve", "-o", str(out), "--mode", mode, "--device", "cpu",
                         "--journal", str(jp), *extra]) == 0
        np.testing.assert_array_equal(np.loadtxt(out, dtype=np.int64), np.sort(d))
        recs = EventLog.read_jsonl(str(jp))
        plans = [r for r in recs if r["type"] in ("plan_decision", "plan_override")]
        assert bool(plans) == want_plan, (mode, extra)
        if "--slice-devices" in extra:
            assert plans[0]["type"] == "plan_override" and plans[0]["policy"] == "slice_devices"
            assert any(r["type"] == "variant_prewarm" for r in recs)
