"""The port's coded redundancy plane against the JAX package's, on the same
seeded inputs: replicate and parity, keys and records, the snapshot and its
reconstruction for every loss shape, the zero-re-run recovery and the
over-budget re-run through both schedulers with one injector script, the
straggler race, ``cli run --redundancy`` and the event and counter
registries.

Keys are bit-identical; records are compared as a multiset per key; plans,
wire-byte counters and the ``coded_*`` journal equal the reference's (its
clocks, ``wall_s`` and the port's ``fetch_s``, left out).
"""

import dataclasses
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_terasort, gen_uniform, gen_zipf
from dsort_tpu.parallel import coded as jcoded
from dsort_tpu.parallel import exchange as jex
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import SpmdScheduler as JaxSpmdScheduler
from dsort_tpu.scheduler.fault import WorkerFailure as JaxWorkerFailure
from dsort_tpu.utils import events as jevents
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.parallel import coded
from dsort_tpu_torch.parallel import exchange as ex
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
from dsort_tpu_torch.scheduler.fault import WorkerFailure
from dsort_tpu_torch.utils import events
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

CODED_COUNTERS = ("coded_recoveries", "coded_recovered_keys", "coded_replica_bytes",
                  "coded_straggler_serves", "exchange_bytes_on_wire", "mesh_reforms",
                  "exchange_ring_steps", "fused_exchange_launches")
SKIP = ("phase_start", "phase_end", "variant_compiled")
TIMING = ("job", "tenant", "counters", "seconds", "wall_s", "fetch_s")
MODES = [(2, "replicate"), (3, "replicate"), (2, "parity"), (3, "parity")]
STATE_PLANES = ("replicas", "replica_lens", "sent", "sent_lens", "parity",
                "val_replicas", "sent_vals", "parity_vals")


def _journal(journal):
    return [(e.type, {k: v for k, v in e.fields.items() if k not in TIMING})
            for e in journal.events() if e.type not in SKIP]


def _port(jjob: JaxJobConfig) -> SampleSort:
    return SampleSort(VirtualMesh(8, "cpu"), JobConfig.from_dict(dataclasses.asdict(jjob)))


def _counters(m):
    return {k: m.counters.get(k, 0) for k in CODED_COUNTERS}


def _multiset_per_key(keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Records ordered by (key, payload bytes): equal as a multiset per key
    exactly when the sorted keys agree and each key's payloads agree."""
    rows = np.ascontiguousarray(vals).view(np.uint8).reshape(len(vals), -1)
    order = np.lexsort(tuple(rows.T[::-1]) + (keys,))
    return np.concatenate([keys[order].view(np.uint8).reshape(len(keys), -1), rows[order]], 1)


# -- knobs, wire-byte models, GF(256) -----------------------------------------


def test_resolvers_match_jax():
    for value in (None, 1, 2, 3, 16):
        for default in (1, 3):
            for p in (1, 2, 8):
                assert ex.resolve_redundancy(value, default, p) == jex.resolve_redundancy(
                    value, default, p)
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError):
            ex.resolve_redundancy(bad, 1, 8)
    for mode in (None, "replicate", "parity"):
        assert ex.resolve_redundancy_mode(mode, "parity") == jex.resolve_redundancy_mode(
            mode, "parity")
    with pytest.raises(ValueError):
        ex.resolve_redundancy_mode("raid", "replicate")
    assert [ex.parity_slots(r) for r in range(1, 9)] == [jex.parity_slots(r) for r in range(1, 9)]


def test_job_config_redundancy_validated():
    assert JobConfig(redundancy=2, redundancy_mode="parity").redundancy == 2
    for bad in (dict(redundancy=0), dict(redundancy=1.5), dict(redundancy_mode="raid")):
        with pytest.raises(ConfigError):
            JobConfig(**bad)


def test_wire_byte_models_and_plan_match_jax():
    rng = np.random.default_rng(0)
    for p in (4, 8):
        hist = rng.integers(0, 900, (p, p))
        n_local = int(hist.sum(1).max())
        caps = ex.ring_caps(hist, n_local, p)
        for red in range(1, p + 1):
            assert ex.replica_wire_bytes(caps, 8, p, red) == jex.replica_wire_bytes(caps, 8, p, red)
            assert ex.parity_wire_bytes(caps, 8, p, red) == jex.parity_wire_bytes(caps, 8, p, red)
        for red, mode in MODES:
            m, jm = Metrics(journal=EventLog()), JaxMetrics(journal=JaxEventLog())
            ex.note_coded_plan(m, caps, hist, n_local, p, 4, 1.3, red, mode=mode)
            jex.note_coded_plan(jm, caps, hist, n_local, p, 4, 1.3, red, mode=mode)
            assert dict(m.counters) == dict(jm.counters)
            assert _journal(m.journal) == _journal(jm.journal)


def test_dead_positions_match_jax():
    e, je = WorkerFailure(5, "ring"), JaxWorkerFailure(5, "ring")
    for live in (None, [0, 2, 5, 7]):
        assert coded.dead_positions(e, live) == jcoded.dead_positions(je, live)
    e.workers = je.workers = [5, 7]
    assert coded.dead_positions(e, [0, 2, 5, 7]) == jcoded.dead_positions(je, [0, 2, 5, 7]) == [2, 3]


def test_gf2mul_stays_uint8_and_matches_jax():
    """Torch's promotion with Python ints keeps uint8 (no widening), and the
    fold equals the reference's on every byte."""
    import jax.numpy as jnp

    x = torch.arange(256, dtype=torch.uint8)
    got = ex._gf2mul_u8(x)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jex._gf2mul_u8(jnp.arange(256, dtype=jnp.uint8))))
    np.testing.assert_array_equal(coded._GF_EXP, jcoded._GF_EXP)
    np.testing.assert_array_equal(coded._GF_LOG, jcoded._GF_LOG)
    # g * v through the log tables is the same multiply.
    v = np.arange(1, 256)
    np.testing.assert_array_equal(got.numpy()[1:], coded._GF_EXP[coded._GF_LOG[v] + 1])


def test_byte_plane_is_the_host_twin():
    rng = np.random.default_rng(1)
    rows = rng.integers(-(2**62), 2**62, (3, 5)).astype(np.int64)
    plane = ex._byte_plane(torch.from_numpy(rows)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(plane[i], coded._byte_row(rows[i], 5, 0))
    np.testing.assert_array_equal(coded._byte_row(rows[0][:2], 4, coded._host_sentinel(np.int64))
                                  .view(np.int64)[2:], [np.iinfo(np.int64).max] * 2)


def test_parity_solve_round_trip_matches_jax():
    rng = np.random.default_rng(7)
    rows = {k: rng.integers(0, 256, 64, dtype=np.uint8) for k in range(8)}
    xor, q = np.zeros(64, np.uint8), np.zeros(64, np.uint8)
    for k, r in rows.items():
        xor ^= r
        q ^= coded._gf_scale(r, int(coded._GF_EXP[k % 255]))
    for unknowns in ([3], [0, 1], [2, 5], [6, 7]):
        known = {k: r for k, r in rows.items() if k not in unknowns}
        planes = [xor, q][: len(unknowns)]
        out = coded._parity_solve(known, planes, unknowns)
        jout = jcoded._parity_solve(known, planes, unknowns)
        for k in unknowns:
            np.testing.assert_array_equal(out[k], rows[k])
            np.testing.assert_array_equal(out[k], jout[k])


def test_straggler_claim_is_exactly_once():
    """Many legs race one claim: exactly one wins, whatever the interleaving."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            claim, wins = coded.StragglerClaim(), []
            threads = [threading.Thread(target=lambda i=i: wins.append(claim.claim(f"leg{i}")))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            assert wins.count(True) == 1 and claim.winner is not None
    finally:
        sys.setswitchinterval(old)


# -- healthy coded sorts --------------------------------------------------------


@pytest.mark.parametrize("red,mode", MODES)
def test_coded_healthy_matches_jax(mesh8, red, mode):
    data = gen_uniform(20_003, seed=1)
    jjob = JaxJobConfig(exchange="ring", redundancy=red, redundancy_mode=mode)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    want = JaxSampleSort(mesh8, jjob).sort(data, metrics=jm)
    got = _port(jjob).sort(data, metrics=m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(data))
    assert dict(m.counters) == {k: v for k, v in jm.counters.items() if k != "variant_compiles"}
    assert _journal(m.journal) == _journal(jm.journal)
    ship = next(e.fields for e in m.journal.events() if e.type == "coded_replica_ship")
    assert ship["bytes"] == m.counters["coded_replica_bytes"] > 0


@pytest.mark.parametrize("exchange", ["alltoall", "fused", "hier"])
def test_coded_forces_ring(mesh8, exchange):
    data = gen_uniform(10_000, seed=2)
    jjob = JaxJobConfig(exchange=exchange, redundancy=2)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    np.testing.assert_array_equal(_port(jjob).sort(data, metrics=m),
                                  JaxSampleSort(mesh8, jjob).sort(data, metrics=jm))
    assert m.counters["coded_replica_bytes"] > 0
    assert m.counters.get("fused_exchange_launches", 0) == 0
    assert m.counters.get("hier_exchanges", 0) == 0
    assert _journal(m.journal) == _journal(jm.journal)


@pytest.mark.parametrize("mode", ["replicate", "parity"])
@pytest.mark.parametrize("dtype", [np.int64, np.uint32, np.float32, np.uint8])
def test_coded_key_dtypes(mesh8, dtype, mode):
    rng = np.random.default_rng(3)
    if np.dtype(dtype).kind == "f":
        data = rng.standard_normal(8000).astype(dtype)
        data[:7] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5]
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 8000, dtype=dtype, endpoint=True)
    jjob = JaxJobConfig(exchange="ring", redundancy=2, redundancy_mode=mode)
    got = _port(jjob).sort(data)
    want = JaxSampleSort(mesh8, jjob).sort(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_coded_per_call_override_and_keep_on_device():
    data = gen_zipf(1 << 13, a=1.3, seed=4)
    ss = _port(JaxJobConfig(exchange="ring"))
    m = Metrics()
    np.testing.assert_array_equal(ss.sort(data, m, redundancy=2, redundancy_mode="parity"),
                                  np.sort(data))
    assert m.counters["coded_replica_bytes"] > 0
    ss.straggler_fn = lambda: 3  # no race on a device-resident result
    m = Metrics(journal=EventLog())
    h = ss.sort(data, m, keep_on_device=True, redundancy=2)
    np.testing.assert_array_equal(h.to_host(), np.sort(data))
    assert "coded_straggler_serve" not in m.journal.types()


# -- snapshots and reconstruction ----------------------------------------------

DATA = gen_uniform(20_000, seed=5)
LOSSES = ([0], [3], [7], [2, 5], [3, 4], [0, 7], [1, 2, 5], [3, 4, 5])


def _raise_on(err_cls, dead):
    def hook():
        e = err_cls(dead[0], "ring")
        e.workers = list(dead)
        raise e

    return hook


@pytest.fixture(scope="module")
def jax_states(mesh8):
    """The JAX package's snapshots, built once: (red, mode) -> state."""
    out = {}
    for red, mode in MODES:
        ss = JaxSampleSort(mesh8, JaxJobConfig(exchange="ring", redundancy=red, redundancy_mode=mode))
        ss.fault_hook = _raise_on(JaxWorkerFailure, [3])
        with pytest.raises(JaxWorkerFailure) as ei:
            ss.sort(DATA)
        out[(red, mode)] = ei.value.coded_state
    return out


def _outcome(state, dead):
    try:
        out, info = state.assemble(dead)
    except Exception as e:  # noqa: BLE001 - compared by type across packages
        return type(e).__name__, None
    return out, info


@pytest.mark.parametrize("red,mode", MODES)
def test_snapshot_and_every_loss_shape_match_jax(jax_states, red, mode):
    """The port's snapshot holds the reference's planes bit for bit, and
    `assemble` gives the same output or the same refusal for every loss
    shape of the reference's drills: single losses, non-adjacent and
    adjacent pairs, three losses."""
    ss = _port(JaxJobConfig(exchange="ring", redundancy=red, redundancy_mode=mode))
    ss.fault_hook = _raise_on(WorkerFailure, [3])
    with pytest.raises(WorkerFailure) as ei:
        ss.sort(DATA)
    st, jst = ei.value.coded_state, jax_states[(red, mode)]
    assert (st.num_workers, st.redundancy, st.caps, st.n, st.mode) == (
        jst.num_workers, jst.redundancy, jst.caps, jst.n, jst.mode)
    for a, b in zip(st.ranges, jst.ranges):
        np.testing.assert_array_equal(a, b)
    for f in STATE_PLANES:
        a, b = getattr(st, f), getattr(jst, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert st.fetch_s >= 0
    expect = np.sort(DATA)
    covered = 0
    for dead in LOSSES:
        got, jgot = _outcome(st, dead), _outcome(jst, dead)
        if isinstance(jgot[0], str):
            assert got == jgot, dead
            continue
        np.testing.assert_array_equal(got[0], jgot[0])
        np.testing.assert_array_equal(got[0], expect)
        assert got[1] == jgot[1], dead
        covered += 1
    assert covered >= 3


@pytest.mark.parametrize("mode", ["replicate", "parity"])
def test_kv_snapshot_matches_jax(mesh8, mode):
    tk, tv = gen_terasort(3000, seed=9)
    states = []
    for cls, err in ((JaxSampleSort, JaxWorkerFailure), (SampleSort, WorkerFailure)):
        jjob = JaxJobConfig(exchange="ring", redundancy=2, redundancy_mode=mode)
        ss = cls(mesh8, jjob) if cls is JaxSampleSort else _port(jjob)
        ss.fault_hook = _raise_on(err, [4])
        with pytest.raises(err) as ei:
            ss.sort_kv(tk, tv)
        states.append(ei.value.coded_state)
    jst, st = states
    assert st.kv and st.mode == mode
    (jk, jv), jinfo = jst.assemble([4])
    (ok, ov), info = st.assemble([4])
    assert ok.dtype == np.uint64 and info == jinfo
    np.testing.assert_array_equal(_multiset_per_key(ok, ov), _multiset_per_key(jk, jv))
    order = np.argsort(tk, kind="stable")
    np.testing.assert_array_equal(_multiset_per_key(ok, ov), _multiset_per_key(tk[order], tv[order]))


@pytest.mark.parametrize("mode", ["replicate", "parity"])
def test_kv_coded_end_to_end_matches_jax(mesh8, mode):
    """Repeated keys: the payload plane rides the replicas or the parity
    fold; records match the reference's as a multiset per key, and the
    premium (keys and payload) is priced alike."""
    rng = np.random.default_rng(21)
    keys = rng.zipf(1.3, 6000).astype(np.uint64)
    vals = rng.integers(0, 256, (6000, 12), dtype=np.uint8)
    jjob = JaxJobConfig(exchange="ring", redundancy=2, redundancy_mode=mode)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    jk, jv = JaxSampleSort(mesh8, jjob).sort_kv(keys, vals, metrics=jm)
    ok, ov = _port(jjob).sort_kv(keys, vals, metrics=m)
    np.testing.assert_array_equal(ok, np.sort(keys))
    np.testing.assert_array_equal(_multiset_per_key(ok, ov), _multiset_per_key(jk, jv))
    assert _counters(m) == _counters(jm)
    assert _journal(m.journal) == _journal(jm.journal)


def test_kv_secondary_runs_uncoded():
    tk, tv = gen_terasort(2048, seed=3)
    sec = tv[:, 0].astype(np.uint16)
    m = Metrics()
    ok, _ = _port(JaxJobConfig(exchange="ring", redundancy=2)).sort_kv(tk, tv, m, secondary=sec)
    np.testing.assert_array_equal(ok, np.sort(tk))
    assert m.counters.get("coded_replica_bytes", 0) == 0


# -- the straggler race ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["replicate", "parity"])
def test_straggler_serve_exactly_once(mesh8, mode):
    """The holder wins against a 0.75 s owner: exactly one
    ``coded_straggler_serve``, the owner's late ``coded_owner_fetch``
    (``won=False``) once drained, no failure — as in the reference."""
    data = gen_uniform(12_000, seed=11)
    runs = []
    for cls in (JaxSampleSort, SampleSort):
        jjob = JaxJobConfig(exchange="ring", redundancy=2, redundancy_mode=mode)
        ss = cls(mesh8, jjob) if cls is JaxSampleSort else _port(jjob)
        ss.straggler_fn = lambda: 3
        ss.fetch_delay_fn = lambda s: 0.75
        m = (JaxMetrics(journal=JaxEventLog()) if cls is JaxSampleSort
             else Metrics(journal=EventLog()))
        t0 = time.perf_counter()
        out = ss.sort(data, metrics=m)
        wall = time.perf_counter() - t0
        ss.join_stragglers()
        runs.append((out, m, wall))
    (jout, jm, _), (out, m, wall) = runs
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, np.sort(data))
    assert m.counters["coded_straggler_serves"] == 1 and wall < 0.75
    assert _journal(m.journal) == _journal(jm.journal)
    types = m.journal.types()
    assert types.count("coded_straggler_serve") == 1 and types[-1] == "coded_owner_fetch"
    fetch = next(e.fields for e in m.journal.events() if e.type == "coded_owner_fetch")
    assert fetch["won"] is False and fetch["range"] == 3


def test_straggler_owner_wins_without_delay():
    """With no delay either leg may claim first; exactly one serves, and
    the bits are the same either way."""
    data = gen_uniform(12_000, seed=12)
    ss = _port(JaxJobConfig(exchange="ring", redundancy=2))
    ss.straggler_fn = lambda: 5
    m = Metrics(journal=EventLog())
    np.testing.assert_array_equal(ss.sort(data, metrics=m), np.sort(data))
    ss.join_stragglers()
    fetch = [e.fields for e in m.journal.events() if e.type == "coded_owner_fetch"]
    serves = m.counters.get("coded_straggler_serves", 0)
    assert len(fetch) == 1 and serves + int(fetch[0]["won"]) == 1


def test_straggler_uncoded_is_ignored():
    ss = _port(JaxJobConfig(exchange="ring"))
    ss.straggler_fn = lambda: 3
    ss.fetch_delay_fn = lambda s: 0.0
    m = Metrics(journal=EventLog())
    data = gen_uniform(8000, seed=13)
    np.testing.assert_array_equal(ss.sort(data, metrics=m), np.sort(data))
    assert not {"coded_straggler_serve", "coded_owner_fetch"} & set(m.journal.types())


# -- the scheduler drills: both packages, one injector script --------------------


def _drill(port: bool, job_kw: dict, script, data):
    jjob = JaxJobConfig(settle_delay_s=0.01, **job_kw)
    if port:
        inj, journal = FaultInjector(), EventLog()
        sched = SpmdScheduler(8, "cpu", JobConfig.from_dict(dataclasses.asdict(jjob)), inj)
        metrics = Metrics(journal=journal)
    else:
        inj, journal = JaxFaultInjector(), JaxEventLog()
        sched = JaxSpmdScheduler(job=jjob, injector=inj)
        metrics = JaxMetrics(journal=journal)
    np.testing.assert_array_equal(sched.sort(data), np.sort(data))  # warm
    script(inj)
    out = sched.sort(data, metrics=metrics)
    for ss in sched._sorters.values():
        ss.join_stragglers()
    return out, metrics, sched.table.live_workers()


DRILLS = {
    "replicate-loss": (dict(exchange="ring", redundancy=2), lambda i: i.fail_once(3, "ring")),
    "replicate-over-budget": (dict(exchange="ring", redundancy=2),
                              lambda i: i.fail_sequence([(3, "ring"), (4, "ring")])),
    "parity-loss": (dict(exchange="ring", redundancy=2, redundancy_mode="parity"),
                    lambda i: i.fail_once(3, "ring")),
    "parity-over-budget": (dict(exchange="ring", redundancy=2, redundancy_mode="parity"),
                           lambda i: i.fail_sequence([(2, "ring"), (5, "ring")])),
    "r3-adjacent-pair": (dict(exchange="ring", redundancy=3),
                         lambda i: i.fail_sequence([(3, "ring"), (4, "ring")])),
    "uncoded-loss": (dict(exchange="ring"), lambda i: i.fail_once(3, "ring")),
    "straggler": (dict(exchange="ring", redundancy=2), lambda i: i.slow(5, 0.75)),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_scheduler_drill_matches_jax(name):
    job_kw, script = DRILLS[name]
    data = gen_zipf(1 << 14, a=1.3, seed=5)
    jout, jm, jlive = _drill(False, job_kw, script, data)
    out, m, live = _drill(True, job_kw, script, data)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, np.sort(data))
    assert live == jlive
    assert _counters(m) == _counters(jm)
    assert _journal(m.journal) == _journal(jm.journal)
    types = m.journal.types()
    if name.endswith("-loss") and not name.startswith("uncoded"):
        rec = "parity_recover" if name.startswith("parity") else "coded_recover"
        assert types.count("attempt_start") == 1 and m.counters["coded_recoveries"] == 1
        assert types.index("worker_dead") < types.index("mesh_reform") < types.index(rec)
        ev = next(e.fields for e in m.journal.events() if e.type == rec)
        assert ev["dead"] == [3] and ev["fetch_s"] >= 0 and ev["wall_s"] >= 0
    elif "over-budget" in name:
        assert "coded_budget_exceeded" in types and types.count("attempt_start") == 2
    elif name == "straggler":
        assert m.counters["coded_straggler_serves"] == 1 and "worker_dead" not in types
        assert live == list(range(8))


def test_scheduler_keep_on_device_recovers_by_rerun():
    """A device-resident coded job is no host snapshot: a loss re-runs."""
    data = gen_zipf(1 << 13, a=1.3, seed=6)
    inj = FaultInjector()
    sched = SpmdScheduler(8, "cpu", JobConfig(settle_delay_s=0.01, exchange="ring",
                                              redundancy=2), inj)
    inj.fail_once(3, "ring")
    m = Metrics(journal=EventLog())
    h = sched.sort(data, metrics=m, keep_on_device=True)
    np.testing.assert_array_equal(h.to_host(), np.sort(data))
    types = m.journal.types()
    assert types.count("attempt_start") == 2 and "coded_recover" not in types


def test_scheduler_coded_narrow_keys_recover_in_their_dtype():
    data = np.random.default_rng(7).integers(-128, 128, 9000).astype(np.int8)
    inj = FaultInjector()
    sched = SpmdScheduler(8, "cpu", JobConfig(settle_delay_s=0.01, exchange="ring",
                                              redundancy=2), inj)
    inj.fail_once(2, "ring")
    m = Metrics()
    out = sched.sort(data, metrics=m)
    assert out.dtype == np.int8 and m.counters["coded_recoveries"] == 1
    np.testing.assert_array_equal(out, np.sort(data))


# -- the CLI and the registries ---------------------------------------------------


def test_cli_run_redundancy_skips_the_fused_route_like_jax(tmp_path):
    x = gen_uniform(7_000, seed=31)
    src, ref, out, jp, jjp = (tmp_path / n for n in ("i.txt", "r.txt", "o.txt", "j.jsonl", "jj.jsonl"))
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    flags = ["--redundancy", "2", "--redundancy-mode", "parity"]
    assert jax_cli_main(["run", str(src), "-o", str(ref), "--journal", str(jjp), *flags]) == 0
    assert cli.main(["run", str(src), "-o", str(out), "--device", "cpu", "--journal", str(jp),
                     *flags]) == 0
    assert out.read_bytes() == ref.read_bytes()
    recs = EventLog.read_jsonl(str(jp))
    types = [r["type"] for r in recs]
    assert recs[0]["mode"] == "spmd" and "coded_replica_ship" in types
    assert "fused_small_jobs" not in recs[-2]["counters"]
    jtypes = [r["type"] for r in JaxEventLog.read_jsonl(str(jjp))]
    assert [t for t in types if t.startswith("coded")] == [t for t in jtypes if t.startswith("coded")]


def test_event_and_counter_registries_match_jax():
    """Every coded_* / hier_* event and counter of the reference is
    registered under the same name, and every counter this package bumps
    is in its registry (and the reference's)."""
    want = {k for k in jevents.EVENT_TYPES if k.startswith(("coded_", "hier_")) or k == "parity_recover"}
    assert want <= set(events.EVENT_TYPES)
    assert set(events.EVENT_TYPES) <= set(jevents.EVENT_TYPES)
    want_c = {k for k in jevents.COUNTERS if k.startswith(("coded_", "hier_", "dcn_", "intra_host"))}
    assert want_c <= set(events.COUNTERS) <= set(jevents.COUNTERS)
    pkg = Path(coded.__file__).resolve().parents[1]
    bumped = set()
    for path in pkg.rglob("*.py"):
        bumped |= set(re.findall(r'\.bump\(\s*"([a-z_]+)"', path.read_text()))
    assert bumped and bumped <= set(events.COUNTERS), bumped - set(events.COUNTERS)
