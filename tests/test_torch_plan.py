"""The planner against the JAX package's.

Every policy's `replay_decision` on seeded inputs gives the reference's
``(chosen, rejected)``; `probe_skew`, the rung math and the ladder agree;
`Planner.replay` of a journal the JAX package wrote gives the state the
JAX planner holds, and the reverse.  Then the seams in the port: the
exchange planned per `SampleSort` dispatch (``fused_ok`` false on the
CPU, as the reference's off its accelerator), the wave size in
`ExternalWaveSort`, the slice width and the prewarm set in `SortService`,
and the CLI's precedence (``--no-autotune`` > conf ``AUTOTUNE=`` > on; a
flag given joins ``JobConfig.explicit``), each against the reference's
`_load_config` on the same arguments.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest

from dsort_tpu import cli as jcli
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.obs import plan as jplan
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig, ServeConfig, SortConfig
from dsort_tpu_torch.obs.plan import (
    PLAN_DECISION_FIELDS,
    PLAN_OVERRIDE_FIELDS,
    PLAN_POLICIES,
    PREWARM_HISTORY,
    SKEW_RING_THRESHOLD,
    Planner,
    plan_ladder,
    plan_rung,
    plan_table,
    planned_exchange,
    planned_slice_devices,
    planned_wave_elems,
    probe_skew,
    replay_decision,
    variant_key_label,
)
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.utils.events import COUNTERS, EVENT_TYPES, EventLog
from dsort_tpu_torch.utils.metrics import Metrics


def _metered():
    return Metrics(journal=EventLog())


def _records(journal):
    return [e.to_dict() for e in journal.events()]


def test_plan_schema_and_registries_match_jax():
    assert PLAN_POLICIES == jplan.PLAN_POLICIES
    assert PLAN_DECISION_FIELDS == jplan.PLAN_DECISION_FIELDS
    assert PLAN_OVERRIDE_FIELDS == jplan.PLAN_OVERRIDE_FIELDS
    for name in ("SKEW_RING_THRESHOLD", "SKEW_PROBE_SAMPLE", "WAVE_HBM_BUDGET_FRAC",
                 "WAVE_WORKING_SET_FACTOR", "WAVE_MIN_ELEMS", "WAVE_MAX_ELEMS",
                 "REDUNDANCY_DEGRADED_FRAC", "SLICE_KEYS_PER_DEVICE", "PREWARM_HISTORY",
                 "DISPATCH_TIMEOUT_HEADROOM", "DISPATCH_TIMEOUT_MIN_S",
                 "DISPATCH_LATENCY_HISTORY"):
        assert getattr(jplan, name) == getattr(__import__(
            "dsort_tpu_torch.obs.plan", fromlist=[name]), name), name
    assert {"plan_decision", "plan_override"} <= set(EVENT_TYPES)
    assert {"plan_decisions", "plan_overrides"} <= set(COUNTERS)


def test_plan_rung_and_ladder_pinned():
    from dsort_tpu_torch.models.pipelines import pad_rung
    from dsort_tpu_torch.parallel.exchange import ladder_rungs

    for n in (1, 7, 8, 9, 100, 3000, 3050, 9000, 16384, 16385, (1 << 20) - 1, 1 << 20,
              (1 << 22) + 17):
        assert plan_rung(n) == pad_rung(n) == jplan.plan_rung(n), n
    for hi, lo in ((1 << 16, 8), (1 << 16, 1 << 14), (20000, 12000), (64, 8)):
        assert plan_ladder(hi, lo) == ladder_rungs(hi, lo=lo) == jplan.plan_ladder(hi, lo)


@pytest.mark.parametrize("dist,dtype,n,p", [
    ("uniform", np.int32, 1 << 17, 8), ("zipf", np.int64, 1 << 17, 8),
    ("zipf", np.int32, 50_000, 7), ("uniform", np.uint32, 3000, 4),
    ("uniform", np.int32, 0, 8), ("uniform", np.int32, 5000, 1),
])
def test_probe_skew_matches_jax(dist, dtype, n, p):
    data = (gen_zipf(n, a=1.3, seed=4, dtype=dtype) if dist == "zipf"
            else gen_uniform(n, dtype=dtype, seed=0))
    got = probe_skew(data, p)
    assert got == jplan.probe_skew(data, p) == probe_skew(data, p)
    if dist == "zipf" and p == 8:
        assert got["max_mean_ratio"] >= SKEW_RING_THRESHOLD
    if dist == "uniform" and n > 1000 and p > 1:
        assert got["max_mean_ratio"] < SKEW_RING_THRESHOLD


def _random_inputs(policy, rng):
    """Seeded inputs that reach every branch of ``policy``."""
    if policy == "exchange":
        return {"max_mean_ratio": float(rng.choice([1.0, 1.5, 1.99, 2.0, 3.7])),
                "num_workers": int(rng.choice([1, 2, 4, 8])),
                "fused_ok": bool(rng.random() < 0.5), "redundancy": int(rng.choice([1, 2, 3])),
                "hosts": int(rng.choice([0, 0, 2, 4]))}
    if policy == "wave_elems":
        return {"current": int(rng.choice([1 << 18, 1 << 20, 1 << 22])),
                "itemsize": int(rng.choice([4, 8])),
                "max_device_bytes": int(rng.choice([0, 1 << 30, 80 << 30])),
                "peak_bytes": int(rng.choice([0, 32 << 20, 4 << 30]))}
    if policy in ("redundancy", "redundancy_mode"):
        d = {"agents": int(rng.integers(0, 6)), "degraded": int(rng.integers(0, 3)),
             "loss_events": int(rng.choice([0, 0, 1, 3]))}
        if policy == "redundancy":
            d["current"] = int(rng.choice([1, 2]))
        return d
    if policy == "prewarm":
        ladder = [int(r) for r in plan_ladder(1 << 16, 1 << 14)]
        hist = [variant_key_label(int(rng.choice(ladder)), str(rng.choice(["int32", "int64"])))
                for _ in range(int(rng.integers(0, 12)))]
        return {"history": hist, "ladder": ladder, "dtype": "int32",
                "limit": int(rng.integers(0, 4))}
    if policy == "dispatch_timeout_s":
        return {"current": float(rng.choice([0.0, 30.0])),
                "p99_s": float(rng.choice([0.0, 0.01, 0.5])), "samples": int(rng.integers(0, 9))}
    return {"num_devices": int(rng.choice([1, 4, 8, 6])), "current": int(rng.choice([1, 2])),
            "rungs": [int(x) for x in rng.choice([1024, 1 << 20, 1 << 23], rng.integers(0, 6))]}


@pytest.mark.parametrize("policy", list(PLAN_POLICIES))
def test_replay_decision_matches_jax(policy):
    rng = np.random.default_rng(sum(map(ord, policy)))
    chosen = set()
    for _ in range(60):
        inputs = _random_inputs(policy, rng)
        got = replay_decision(policy, inputs)
        assert got == jplan.replay_decision(policy, inputs), inputs
        chosen.add(json.dumps(got[0]))
    assert len(chosen) >= 2  # the seeded inputs reach more than one branch
    with pytest.raises(ValueError, match="unknown plan policy"):
        replay_decision("nope", {})


def test_decide_override_and_precedence():
    m = _metered()
    p = Planner(job=JobConfig(autotune=True))
    assert p.decide("exchange", {"max_mean_ratio": 3.0, "num_workers": 8}, m) == "ring"
    (ev,) = [e for e in m.journal.events() if e.type == "plan_decision"]
    assert set(ev.fields) - {"job"} == set(PLAN_DECISION_FIELDS)
    assert replay_decision("exchange", ev.fields["inputs"])[0] == "ring"
    m = _metered()
    p = Planner(job=JobConfig(autotune=True, exchange="alltoall", explicit=("exchange",)))
    inputs = {"max_mean_ratio": 3.0, "num_workers": 8}
    assert p.resolve("exchange", inputs, m) == "alltoall"
    (ov,) = [e for e in m.journal.events() if e.type == "plan_override"]
    assert set(ov.fields) - {"job"} == set(PLAN_OVERRIDE_FIELDS)
    assert ov.fields["planned"] == "ring" and m.counters["plan_overrides"] == 1
    assert p.resolve("exchange", inputs, m, call_value="fused") == "fused"
    off = Planner(job=JobConfig())
    assert off.resolve("exchange", inputs, m) is None
    assert off.resolve("exchange", inputs, m, call_value="ring") == "ring"
    assert [e.type for e in m.journal.events()].count("plan_override") == 2
    snap = p.snapshot()
    assert snap["exchange"]["overrides"] == 2 and set(snap) == set(PLAN_POLICIES)
    rows = [(k, v["decisions"], v["overrides"], v["last"]) for k, v in snap.items()]
    assert plan_table(rows) == jplan.plan_table(rows)
    assert plan_table([]) == jplan.plan_table([])


def _signals(m):
    m.event("job_admitted", tenant="a", queue_depth=1, n_keys=3050, dtype="int32")
    m.event("job_admitted", tenant="a", queue_depth=1, n_keys=14000, dtype="int64")
    m.event("hbm_watermark", phase="exchange", bytes_in_use=123456, max_device_bytes=1 << 30,
            device=0)
    m.event("worker_dead", worker=3)
    m.event("plan_decision", policy="exchange", chosen="ring", inputs={}, rejected=[])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_planner_replay_across_packages(writer, tmp_path):
    """A journal one package wrote (JSONL on disk) replays into both
    packages' planners with the writer's live state."""
    if writer == "jax":
        m, live = JaxMetrics(journal=JaxEventLog()), jplan.Planner(job=JaxJobConfig(autotune=True))
    else:
        m, live = _metered(), Planner(job=JobConfig(autotune=True))
    live.attach(m)
    _signals(m)
    # The fleet's signals, registered in both packages.
    m.event("job_rerouted", job_id="j1", frm="a0", to="a1", reason="agent_lost")
    m.event("health_verdict", agent="a0", score=2.5, degraded=True)
    m.event("job_dispatched", job_id="j1", agent="a1", accept_latency_s=0.02)
    path = tmp_path / "j.jsonl"
    m.journal.write_jsonl(str(path))
    records = [json.loads(ln) for ln in open(path)]
    want = live.state_dict()
    assert Planner.replay(records).state_dict() == want
    assert jplan.Planner.replay(records).state_dict() == want
    assert want["admissions"] == [variant_key_label(plan_rung(3050), "int32"),
                                  variant_key_label(plan_rung(14000), "int64")]


def test_planner_replay_of_a_port_serve_journal():
    """The planner riding `SortService`'s job taps folds the admission mix;
    replaying the service's journal in either package gives its state."""
    from dsort_tpu_torch.serve import SortService

    journal = EventLog()
    svc = SortService(8, "cpu", job=JobConfig(settle_delay_s=0.01),
                      serve=ServeConfig(small_job_max=1 << 14), journal=journal)
    rng = np.random.default_rng(3)
    for n, dt in ((3000, np.int32), (14000, np.int64), (3000, np.int32)):
        svc.submit(rng.integers(0, 1000, n).astype(dt))[1].result(60)
    svc.shutdown(drain=True)
    records = _records(journal)
    st = svc.planner.state_dict()
    assert len(st["admissions"]) == 3
    assert Planner.replay(records).state_dict() == st == jplan.Planner.replay(records).state_dict()


def test_prewarm_history_is_bounded():
    p = Planner()
    for i in range(PREWARM_HISTORY + 40):
        p.observe("job_admitted", {"n_keys": 3050 + i, "dtype": "int32"})
    assert len(p.state_dict()["admissions"]) == PREWARM_HISTORY


# -- the sample sort seam -------------------------------------------------------------


def test_autotune_picks_ring_on_zipf_alltoall_on_uniform():
    zipf = gen_zipf(1 << 17, a=1.3, seed=4)
    uni = gen_uniform(1 << 17, seed=0)
    m = _metered()
    ss = SampleSort(VirtualMesh(8, "cpu"), JobConfig(autotune=True))
    out_z, out_u = ss.sort(zipf, metrics=m), ss.sort(uni, metrics=m)
    plans = [e for e in m.journal.events() if e.type == "plan_decision"]
    assert [p.fields["chosen"] for p in plans] == ["ring", "alltoall"]
    for p, data in zip(plans, (zipf, uni)):
        want = jplan.probe_skew(data, 8)
        want.update(fused_ok=False, hosts=0, redundancy=1)  # a CPU mesh: no fused kernel
        assert p.fields["inputs"] == want
        assert jplan.replay_decision("exchange", p.fields["inputs"]) == (
            p.fields["chosen"], p.fields["rejected"])
    np.testing.assert_array_equal(out_z, np.sort(zipf))
    np.testing.assert_array_equal(out_u, np.sort(uni))
    np.testing.assert_array_equal(out_z, SampleSort(VirtualMesh(8, "cpu")).sort(zipf))


def test_fused_ok_is_a_cuda_mesh():
    """On a CUDA mesh the fused ring kernel exists: a skewed job plans
    ``fused``; the CPU mesh plans ``ring`` (the decision itself, not the
    sort)."""
    zipf = gen_zipf(1 << 15, a=1.3, seed=4)
    job = JobConfig(autotune=True)
    assert planned_exchange(job, zipf, 8, None, fused_ok=True) == "fused"
    assert planned_exchange(job, zipf, 8, None, fused_ok=False) == "ring"
    assert planned_exchange(JobConfig(), zipf, 8, None, call_value="ring") == "ring"


@pytest.mark.parametrize("case", ["override", "off", "redundancy", "hier_hosts"])
def test_sample_sort_seam_cases(case):
    data = gen_zipf(1 << 15, a=1.3, seed=4) if case == "override" else gen_uniform(1 << 14, seed=2)
    m = _metered()
    if case == "override":
        out = SampleSort(VirtualMesh(8, "cpu"), JobConfig(autotune=True)).sort(
            data, metrics=m, exchange="alltoall")
        (ov,) = [e for e in m.journal.events() if e.type == "plan_override"]
        assert (ov.fields["explicit"], ov.fields["planned"]) == ("alltoall", "ring")
    elif case == "off":
        out = SampleSort(VirtualMesh(8, "cpu"), JobConfig()).sort(data, metrics=m)
        assert not {"plan_decision", "plan_override"} & set(m.journal.types())
    elif case == "redundancy":
        out = SampleSort(VirtualMesh(8, "cpu"), JobConfig(autotune=True, redundancy=2)).sort(
            data, metrics=m)
        (p,) = [e for e in m.journal.events() if e.type == "plan_decision"]
        assert p.fields["chosen"] == "ring" and p.fields["inputs"]["redundancy"] == 2
    else:  # a requested grouping is a topology signal: hier
        out = SampleSort(VirtualMesh(8, "cpu"), JobConfig(autotune=True, hier_hosts=2)).sort(
            data, metrics=m)
        (p,) = [e for e in m.journal.events() if e.type == "plan_decision"]
        assert p.fields["chosen"] == "hier" and p.fields["inputs"]["hosts"] == 2
        assert "hier_exchange_plan" in m.journal.types()
    np.testing.assert_array_equal(out, np.sort(data))


# -- the wave and slice seams ------------------------------------------------------------


def test_planned_wave_elems_reads_hbm_ledger_and_drives_the_wave_sort(tmp_path):
    from dsort_tpu_torch.models.wave_sort import ExternalWaveSort

    records = [{"type": "hbm_watermark", "seq": 0, "t": 0.0, "mono": 0.0, "phase": "exchange",
                "bytes_in_use": 32 << 20, "max_device_bytes": 1 << 30, "device": 0}]
    for job, want_type in ((JobConfig(autotune=True), "plan_decision"),
                           (JobConfig(autotune=True, explicit=("wave_elems",)), "plan_override"),
                           (JobConfig(), None)):
        m = _metered()
        got = planned_wave_elems(job, 1 << 20, 4, records, m)
        jm = JaxMetrics(journal=JaxEventLog())
        jjob = JaxJobConfig(autotune=job.autotune, explicit=job.explicit)
        assert got == jplan.planned_wave_elems(jjob, 1 << 20, 4, records, jm)
        evs = [e for e in m.journal.events()]
        if want_type is None:
            assert not evs and got == 1 << 20
        else:
            (ev,) = evs
            assert ev.type == want_type and ev.fields["inputs"]["peak_bytes"] == 32 << 20
    # In the wave sort: a journal with a watermark resizes the waves; with
    # no watermark on the CPU the policy keeps the hand-set size.
    data = gen_uniform(40_000, seed=3)
    m = _metered()
    s = ExternalWaveSort(VirtualMesh(8, "cpu"), wave_elems=10_000, spill_dir=str(tmp_path),
                         job=JobConfig(autotune=True))
    np.testing.assert_array_equal(s.sort(data, metrics=m), np.sort(data))
    (p,) = [e for e in m.journal.events() if e.type == "plan_decision"]
    assert p.fields["policy"] == "wave_elems" and p.fields["chosen"] == 10_000
    assert m.journal.types().count("wave_start") == 4


def test_planned_slice_devices_and_the_service():
    records = [{"type": "job_admitted", "n_keys": n, "dtype": "int32"}
               for n in (1 << 20, 3 << 20, 1 << 22)]
    for job, serve in ((JobConfig(autotune=True), ServeConfig()),
                       (JobConfig(autotune=True), ServeConfig(slice_devices=2)),
                       (JobConfig(autotune=True, explicit=("slice_devices",)), ServeConfig())):
        m = _metered()
        got = planned_slice_devices(job, serve, serve.slice_devices, 8, records, m)
        jm = JaxMetrics(journal=JaxEventLog())
        from dsort_tpu.config import ServeConfig as JaxServeConfig

        want = jplan.planned_slice_devices(
            JaxJobConfig(autotune=True, explicit=job.explicit),
            JaxServeConfig(slice_devices=serve.slice_devices), serve.slice_devices, 8, records, jm)
        assert got == want
        assert [e.type for e in m.journal.events()] == [e.type for e in jm.journal.events()]
    # The service journals its slice decision before any dispatch; a
    # journal carrying a heavy admission mix widens the slices.
    from dsort_tpu_torch.serve import SortService

    journal = EventLog()
    jm = Metrics(journal=journal)
    for r in records:
        jm.event("job_admitted", tenant="x", queue_depth=0, n_keys=r["n_keys"], dtype="int32")
    svc = SortService(8, "cpu", job=JobConfig(autotune=True), journal=journal, start=False)
    (p,) = [e for e in journal.events() if e.type == "plan_decision"]
    assert p.fields["policy"] == "slice_devices" and p.fields["chosen"] == 4
    assert svc.stats()["slices"] == 2
    svc.shutdown()


def _prewarm_svc(journal, policy="auto"):
    from dsort_tpu_torch.serve import SortService

    return SortService(8, "cpu", job=JobConfig(settle_delay_s=0.01), serve=ServeConfig(
        max_queue_depth=32, max_tenant_inflight=32, prewarm_policy=policy,
        prewarm_min_keys=12000, prewarm_max_keys=20000), journal=journal)


@pytest.mark.parametrize("case", ["predict", "cold", "all"])
def test_prewarm_policy_in_the_service(case):
    from dsort_tpu_torch.parallel.exchange import ladder_rungs

    journal = EventLog()
    svc = _prewarm_svc(journal, "all" if case == "all" else "auto")
    ladder = ladder_rungs(20000, lo=12000)
    rng = np.random.default_rng(6)
    for _ in range(3 if case == "predict" else 1 if case == "all" else 0):
        svc.submit(rng.integers(0, 1000, 14000, dtype=np.int32))[1].result(60)
    plans = [e for e in journal.events() if e.type == "plan_decision"
             and e.fields["policy"] == "prewarm"]
    if case == "predict":
        assert svc.prewarm() == 0  # the traffic already built its one rung
        (plan,) = [e for e in journal.events() if e.type == "plan_decision"
                   and e.fields["policy"] == "prewarm"]
        assert plan.fields["chosen"] == [variant_key_label(plan_rung(14000), "int32")]
        admitted = [variant_key_label(plan_rung(e.fields["n_keys"]), e.fields["dtype"])
                    for e in journal.events() if e.type == "job_admitted"]
        assert plan.fields["inputs"]["history"] == admitted
        assert jplan.replay_decision("prewarm", plan.fields["inputs"])[0] == plan.fields["chosen"]
    elif case == "cold":
        assert svc.prewarm() == len(ladder)
        (plan,) = [e for e in journal.events() if e.type == "plan_decision"]
        assert plan.fields["chosen"] == [variant_key_label(r, "int32") for r in ladder]
    else:
        assert svc.prewarm() == len(ladder) - 1 and not plans
        assert not [e for e in journal.events() if e.type == "plan_decision"
                    and e.fields["policy"] == "prewarm"]
    svc.shutdown(drain=True)


# -- config and the CLI's precedence ---------------------------------------------------


def test_jobconfig_explicit_tristate_and_conf_keys():
    assert JobConfig().explicit == () and not JobConfig().autotune
    job = JobConfig(explicit=("exchange", "redundancy"))
    assert job.is_explicit("exchange") and not job.is_explicit("prewarm")
    assert JobConfig(explicit=["exchange"]).explicit == ("exchange",)
    with pytest.raises(ConfigError, match="explicit"):
        JobConfig(explicit=(42,))
    cfg = SortConfig.from_mapping({"EXCHANGE": "ring", "AUTOTUNE": "1"})
    assert cfg.job.autotune and cfg.job.is_explicit("exchange")
    assert not cfg.job.is_explicit("redundancy")
    cfg2 = SortConfig.from_mapping({"SERVE_PREWARM": "all"})
    assert cfg2.serve.prewarm and cfg2.serve.prewarm_policy == "all"
    assert cfg2.job.is_explicit("prewarm")
    assert not SortConfig.from_mapping({"AUTOTUNE": "0"}).job.autotune


@pytest.mark.parametrize("kw,conf", [
    ({}, None), ({"no_autotune": True}, None), ({}, "AUTOTUNE=0\n"),
    ({"exchange": "ring", "redundancy": 2}, None), ({"prewarm": "all"}, None),
    ({"slice_devices": 2, "tenant": "acme", "flight_dir": "/tmp/f"}, "EXCHANGE=fused\n"),
    ({"workers": 4, "dtype": "int64", "kernel": "pallas"}, "AUTOTUNE=1\nTENANT=blue\n"),
])
def test_cli_load_config_matches_jax(kw, conf, tmp_path):
    base = dict(conf=None, workers=None, dtype=None, kernel=None, merge_kernel=None,
                exchange=None, hier_hosts=None, redundancy=None, redundancy_mode=None,
                checkpoint_dir=None, tenant=None, flight_dir=None, no_autotune=False,
                prewarm=None, slice_devices=None)
    base.update(kw)
    if conf is not None:
        path = tmp_path / "dsort.conf"
        path.write_text(conf)
        base["conf"] = str(path)
    got = cli._load_config(argparse.Namespace(**base))
    want = jcli._load_config(argparse.Namespace(**base))
    assert got.job == JobConfig.from_dict(dataclasses.asdict(want.job))
    assert got.mesh.num_workers == want.mesh.num_workers
    assert got.job.autotune == (not kw.get("no_autotune") and conf != "AUTOTUNE=0\n")


def test_cli_run_no_autotune_ab_bit_identical(tmp_path):
    zipf = gen_zipf(20_000, a=1.3, seed=9, dtype=np.int32)
    inp = tmp_path / "in.txt"
    np.savetxt(inp, zipf, fmt="%d")
    outs, journals = {}, {}
    for arm, extra in (("on", []), ("off", ["--no-autotune"])):
        out, jp = tmp_path / f"{arm}.txt", tmp_path / f"{arm}.jsonl"
        # --redundancy 2 skips the fused route, so the planned run plans.
        assert cli.main(["run", str(inp), "-o", str(out), "--device", "cpu",
                         "--redundancy", "2", "--journal", str(jp), *extra]) == 0
        outs[arm], journals[arm] = out.read_bytes(), EventLog.read_jsonl(str(jp))
    assert outs["on"] == outs["off"]
    (exc,) = [r for r in journals["on"] if r["type"] == "plan_decision"]
    assert exc["chosen"] == "ring" and exc["inputs"]["redundancy"] == 2
    assert not [r for r in journals["off"] if r["type"].startswith("plan_")]
