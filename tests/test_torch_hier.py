"""The port's two-level ``hier`` exchange against the JAX package's, on the
same seeded inputs: the host resolver, the plan and its wire-byte counts,
the sorted bits, the journal, the downgrades, the scheduler's
``hier_reform`` drills and ``cli run --exchange hier``.

On one card every ``ppermute`` of the three phases is a row move of one
tensor, so ``dcn_bytes_on_wire`` is the plan's count, as in the reference's
simulated hosts.
"""

import dataclasses
import logging

import numpy as np
import pytest

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_terasort, gen_uniform, gen_zipf
from dsort_tpu.parallel import exchange as jex
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import SpmdScheduler as JaxSpmdScheduler
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.parallel import exchange as ex
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

HIER_COUNTERS = ("hier_exchanges", "dcn_bytes_on_wire", "intra_host_bytes_on_wire",
                 "exchange_bytes_on_wire", "dcn_bytes_saved", "mesh_reforms")
SKIP = ("phase_start", "phase_end", "variant_compiled")


def _journal(journal):
    """Events in order with their fields, clocks and the JAX package's
    compile and serving labels left out."""
    return [
        (e.type, {k: v for k, v in e.fields.items()
                  if k not in ("job", "tenant", "counters", "seconds", "wall_s")})
        for e in journal.events() if e.type not in SKIP
    ]


def _port(jjob: JaxJobConfig, workers: int = 8) -> SampleSort:
    return SampleSort(VirtualMesh(workers, "cpu"), JobConfig.from_dict(dataclasses.asdict(jjob)))


@pytest.fixture
def warnings_seen(caplog):
    """caplog that sees both packages' warnings (their loggers do not
    propagate)."""
    roots = [logging.getLogger(n) for n in ("dsort_tpu", "dsort_tpu_torch")]
    old = [r.propagate for r in roots]
    for r in roots:
        r.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            yield caplog
    finally:
        for r, o in zip(roots, old):
            r.propagate = o


# -- knobs and host-side plan math ------------------------------------------


def test_resolve_hier_hosts_matches_jax():
    for p in range(1, 17):
        for want in range(0, 10):
            assert ex.resolve_hier_hosts(want, p) == jex.resolve_hier_hosts(want, p), (want, p)
    assert ex.resolve_hier_hosts(0, 8) == 2  # one process: 2 simulated hosts
    assert ex.resolve_hier_hosts(3, 8) == 2 and ex.resolve_hier_hosts(4, 6) == 3
    assert ex.resolve_hier_hosts(2, 7) == 0


def test_resolve_hier_hosts_auto_reads_the_process_group(monkeypatch):
    """Auto takes the world size of an initialised torch.distributed group
    of more than one process (the reference's ``jax.process_count()``)."""
    monkeypatch.setattr(ex, "_process_count", lambda: 4)
    assert ex.resolve_hier_hosts(0, 8) == 4
    assert ex.resolve_hier_hosts(2, 8) == 2  # an explicit count wins
    monkeypatch.setattr(ex, "_process_count", lambda: 1)
    assert ex.resolve_hier_hosts(0, 8) == 2


def test_resolve_exchange_and_config_accept_hier():
    assert ex.resolve_exchange("hier", "alltoall", 8) == "hier"
    assert ex.resolve_exchange("hier", "alltoall", 1) == "alltoall"
    with pytest.raises(ValueError, match="hier"):
        ex.resolve_exchange("hierarchical", "alltoall", 8)
    assert JobConfig(exchange="hier", hier_hosts=2).hier_hosts == 2
    with pytest.raises(ConfigError, match="hier_hosts"):
        JobConfig(hier_hosts=-1)
    with pytest.raises(ConfigError, match="exchange"):
        JobConfig(exchange="two-level")


def _hist(p: int, n_local: int, seed: int) -> np.ndarray:
    """A skewed (P, P) bucket histogram whose rows sum to n_local."""
    rng = np.random.default_rng(seed)
    w = rng.zipf(1.4, size=(p, p)).astype(np.float64)
    hist = np.floor(w / w.sum(axis=1, keepdims=True) * n_local).astype(np.int64)
    hist[:, 0] += n_local - hist.sum(axis=1)
    return hist


@pytest.mark.parametrize("p,hosts", [(8, 2), (8, 4), (8, 8), (16, 4), (6, 3), (12, 2)])
def test_hier_plan_and_wire_bytes_match_jax(p, hosts):
    n_local, bps = 4096, 8
    for seed in range(3):
        hist = _hist(p, n_local, seed)
        np.testing.assert_array_equal(ex.host_matrix(hist, hosts), jex.host_matrix(hist, hosts))
        np.testing.assert_array_equal(ex.host_matrix(np.stack([hist, 2 * hist]), hosts),
                                      jex.host_matrix(np.stack([hist, 2 * hist]), hosts))
        plan = ex.hier_plan(hist, n_local, p, hosts)
        jplan = jex.hier_plan(hist, n_local, p, hosts)
        assert tuple(plan) == tuple(jplan)
        assert ex.hier_wire_bytes(plan, bps) == jex.hier_wire_bytes(jplan, bps)
        caps = ex.ring_caps(hist, n_local, p)
        assert ex.ring_dcn_bytes(caps, bps, p, hosts) == jex.ring_dcn_bytes(caps, bps, p, hosts)
        m, jm = Metrics(journal=EventLog()), JaxMetrics(journal=JaxEventLog())
        ex.note_hier_plan(m, plan, caps, hist, n_local, p, bps, 1.3)
        jex.note_hier_plan(jm, jplan, caps, hist, n_local, p, bps, 1.3)
        assert dict(m.counters) == dict(jm.counters)
        assert _journal(m.journal) == _journal(jm.journal)


def test_hier_perms_match_jax():
    for p, hosts in ((8, 2), (8, 4), (12, 3), (16, 4)):
        d = p // hosts
        for k in range(1, d):
            assert ex._hier_perm_intra(p, d, k) == jex._hier_perm_intra(p, d, k)
        for shift in range(1, hosts):
            assert ex._hier_perm_leg(p, hosts, shift) == jex._hier_perm_leg(p, hosts, shift)


# -- whole sorts against the reference --------------------------------------

INPUTS = {
    "zipf": gen_zipf(1 << 14, a=1.3, seed=11),
    "uniform": gen_uniform(1 << 14, seed=12),
}


@pytest.mark.parametrize("hosts", [2, 4, 8])
@pytest.mark.parametrize("dist", sorted(INPUTS))
def test_hier_bits_counters_and_journal_match_jax(mesh8, dist, hosts):
    data = INPUTS[dist]
    jjob = JaxJobConfig(exchange="hier", hier_hosts=hosts)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    want = JaxSampleSort(mesh8, jjob).sort(data, metrics=jm)
    got = _port(jjob).sort(data, metrics=m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(data))
    np.testing.assert_array_equal(_port(JaxJobConfig(exchange="ring")).sort(data), got)
    assert {k: m.counters.get(k, 0) for k in HIER_COUNTERS} == {
        k: jm.counters.get(k, 0) for k in HIER_COUNTERS}
    assert m.counters["hier_exchanges"] == 1
    assert _journal(m.journal) == _journal(jm.journal)


@pytest.mark.parametrize("dtype", [np.int64, np.uint32, np.uint64, np.float32, np.int16])
def test_hier_key_dtypes_match_jax(mesh8, dtype):
    rng = np.random.default_rng(7)
    if np.dtype(dtype).kind == "f":
        data = (rng.standard_normal(6000) * 1e3).astype(dtype)
        data[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 6000, dtype=dtype, endpoint=True)
    jjob = JaxJobConfig(exchange="hier", hier_hosts=2)
    want = JaxSampleSort(mesh8, jjob).sort(data)
    got = _port(jjob).sort(data)
    assert got.dtype == want.dtype
    if np.dtype(dtype).kind == "f":
        np.testing.assert_array_equal(got, want)  # by value: NaN payloads differ
        assert np.isnan(got[-2:]).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("merge_kernel", ["sort", "bitonic", "block_merge"])
def test_hier_every_merge_kernel(merge_kernel):
    """The eager aggregation and scatter towers (``block_merge``, the plain
    network's run merge on the CPU) and the one-shot combine agree."""
    data = INPUTS["zipf"]
    ss = _port(JaxJobConfig(exchange="hier", hier_hosts=2, merge_kernel=merge_kernel,
                            local_kernel="block" if merge_kernel == "block_merge" else "lax"))
    np.testing.assert_array_equal(ss.sort(data), np.sort(data))


def test_hier_ranges_and_keep_on_device_match_ring():
    data = INPUTS["uniform"]
    hier = _port(JaxJobConfig(exchange="hier", hier_hosts=4))
    ring = _port(JaxJobConfig(exchange="ring"))
    assert [len(r) for r in hier.sort_ranges(data)] == [len(r) for r in ring.sort_ranges(data)]
    np.testing.assert_array_equal(hier.sort(data, keep_on_device=True).to_host(), np.sort(data))


def test_hier_kv_downgrades_to_ring_with_warning(warnings_seen):
    tk, tv = gen_terasort(4096, seed=5)
    m = Metrics(journal=EventLog())
    out_k, out_v = _port(JaxJobConfig(exchange="hier", hier_hosts=2)).sort_kv(tk, tv, metrics=m)
    order = np.argsort(tk, kind="stable")
    np.testing.assert_array_equal(out_k, tk[order])
    np.testing.assert_array_equal(out_v, tv[order])
    assert any("keys-only" in r.getMessage() for r in warnings_seen.records)
    assert m.counters.get("hier_exchanges", 0) == 0


def test_hier_small_mesh_downgrades_with_warning(warnings_seen):
    data = gen_uniform(10_000, seed=6)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    jjob = JaxJobConfig(exchange="hier")
    want = JaxSampleSort(local_device_mesh(2), jjob).sort(data, metrics=jm)
    got = _port(jjob, workers=2).sort(data, metrics=m)
    np.testing.assert_array_equal(got, want)
    msgs = [r.getMessage() for r in warnings_seen.records if r.name.startswith("dsort_tpu_torch")]
    assert any(">= 4 workers" in s for s in msgs)
    assert m.counters.get("hier_exchanges", 0) == 0
    assert _journal(m.journal) == _journal(jm.journal)


# -- the fault contract: both packages, one injector script ------------------


def _drill(port: bool, data, hosts: int, victims):
    jjob = JaxJobConfig(settle_delay_s=0.01, exchange="hier", hier_hosts=hosts)
    if port:
        inj, journal = FaultInjector(), EventLog()
        sched = SpmdScheduler(8, "cpu", JobConfig.from_dict(dataclasses.asdict(jjob)), inj)
        metrics = Metrics(journal=journal)
    else:
        inj, journal = JaxFaultInjector(), JaxEventLog()
        sched = JaxSpmdScheduler(job=jjob, injector=inj)
        metrics = JaxMetrics(journal=journal)
    np.testing.assert_array_equal(sched.sort(data), np.sort(data))  # warm
    for w in victims:
        inj.fail_once(w, "ring")
    out = sched.sort(data, metrics=metrics)
    return out, metrics, sched.table.live_workers()


@pytest.mark.parametrize("hosts,victims,after", [(2, [1, 2], 2), (4, [2, 3], 3)])
def test_scheduler_hier_reform_matches_jax(hosts, victims, after):
    """Losing workers of one host keeps the grouping (2 hosts of 3); losing
    host 1 of 4 re-plans on the 6 survivors as 3 hosts.  ``hier_reform``
    follows ``mesh_reform``, before the re-run, in both packages."""
    data = gen_zipf(1 << 14, a=1.3, seed=21 + hosts)
    jout, jm, jlive = _drill(False, data, hosts, victims)
    out, m, live = _drill(True, data, hosts, victims)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, np.sort(data))
    assert live == jlive
    assert {k: m.counters.get(k, 0) for k in HIER_COUNTERS} == {
        k: jm.counters.get(k, 0) for k in HIER_COUNTERS}
    assert _journal(m.journal) == _journal(jm.journal)
    types = m.journal.types()
    assert types.index("worker_dead") < types.index("mesh_reform") < types.index("hier_reform")
    rf = next(e.fields for e in m.journal.events() if e.type == "hier_reform")
    assert (rf["hosts_before"], rf["hosts_after"], rf["survivors"], rf["downgraded"]) == (
        hosts, after, 6, False)


def test_cli_run_exchange_hier_matches_jax(tmp_path):
    x = gen_uniform(1 << 21, seed=31)[: 1 << 20]  # at the fused threshold: the scheduler
    src, ref, out, jpath = (tmp_path / n for n in ("in.txt", "ref.txt", "out.txt", "j.jsonl"))
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    flags = ["--exchange", "hier", "--hier-hosts", "4"]
    assert jax_cli_main(["run", str(src), "-o", str(ref), *flags]) == 0
    assert cli.main(["run", str(src), "-o", str(out), "--device", "cpu", "--journal", str(jpath),
                     *flags]) == 0
    assert out.read_bytes() == ref.read_bytes()
    recs = EventLog.read_jsonl(str(jpath))
    plan = next(r for r in recs if r["type"] == "hier_exchange_plan")
    assert plan["hosts"] == 4 and recs[-2]["counters"]["hier_exchanges"] == 1
