"""The health plane over the port's fleet: the agents' bounded telemetry
deltas, the controller's rolling verdicts held to a replay of the same
journals (in both packages' analyzers, under either package's
controller), health routing around a measured straggler with its flight
bundle, the heartbeats-only controller, the gauges and ``top``'s pane,
and the peer clock blessings ``report --merge`` aligns on.  Every wait is
a condition with a deadline."""

import time

import numpy as np
import pytest

from dsort_tpu.fleet.controller import FleetController as JaxController
from dsort_tpu.obs.analyze import analyze_records as jax_analyze_records
from dsort_tpu.utils.events import EventLog as JaxEventLog

from dsort_tpu_torch.fleet import proto
from dsort_tpu_torch.fleet.agent import FleetAgent
from dsort_tpu_torch.fleet.controller import FleetController
from dsort_tpu_torch.obs.analyze import analyze_records
from dsort_tpu_torch.obs.merge import merge_records
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import PhaseTimer

from test_torch_fleet import close_all, empty_ledgers, wait_for  # noqa: F401

# The agents here are runner agents: what they advertise must come from
# these tests' jobs alone.  Labels that earlier tests in this process left
# in the first-call ledger would make locality routing keep both of a
# test's jobs on one agent.
pytestmark = pytest.mark.usefixtures("empty_ledgers")


def _runner(seconds: float):
    """A runner whose ``local_sort`` phase lasts ``seconds``: an agent
    made slow on purpose."""
    def run(data, metrics, job_id=None):
        with PhaseTimer(metrics).phase("local_sort"):
            time.sleep(seconds)
        metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
        return np.sort(data)

    return run


SLOW, FAST = _runner(0.25), _runner(0.01)


@pytest.mark.parametrize("controller,log", [(FleetController, EventLog),
                                            (JaxController, JaxEventLog)],
                         ids=["port-controller", "jax-controller"])
def test_live_verdicts_match_replay_of_the_agents_journals(controller, log):
    """On a fleet of port agents with one slowed agent, the controller's
    last ``health_verdict`` for each agent equals the replay of that
    agent's own journal (dominant phase, splits) in both packages'
    analyzers, and the merged replay names the same straggler."""
    ja, jb, jc = EventLog(), EventLog(), log()
    a = FleetAgent(runner=SLOW, agent_id="A", journal=ja)
    b = FleetAgent(runner=FAST, agent_id="B", journal=jb)
    # Heartbeats wake the wait below (the reference's controller does not
    # notify on a delta).
    ctl = controller([a.addr, b.addr], heartbeat_s=0.2, journal=jc)
    try:
        rng = np.random.default_rng(0)
        for _ in range(2):
            d1, d2 = (rng.integers(0, 10**6, 900, dtype=np.int32) for _ in range(2))
            # Both before awaiting: capacity 1 each, one job per agent.
            t1, t2 = ctl.submit(d1, tenant="t")[1], ctl.submit(d2, tenant="t")[1]
            np.testing.assert_array_equal(t1.result(timeout=60), np.sort(d1))
            np.testing.assert_array_equal(t2.result(timeout=60), np.sort(d2))
        records = {aid: [e.to_dict() for e in lg.events()] for aid, lg in (("A", ja), ("B", jb))}
        replay = {aid: analyze_records(r) for aid, r in records.items()}
        for aid, r in records.items():
            assert jax_analyze_records(r)["splits"] == replay[aid]["splits"]
            assert replay[aid]["splits"]["phase_wall_s"] > 0

        def converged():
            live = ctl.health.verdicts()
            return len(live) == 2 and all(
                live[aid]["splits"]["phase_wall_s"] == pytest.approx(
                    replay[aid]["splits"]["phase_wall_s"], abs=1e-5) for aid in ("A", "B"))

        # The agents' last deltas ride their results: wait for them.
        wait_for(ctl, converged, what="live verdicts equal to the replay")
        journaled = {e.fields["agent"]: e.fields for e in jc.events()
                     if e.type == "health_verdict"}
        assert set(journaled) == {"A", "B"}
        for aid in ("A", "B"):
            got, want = journaled[aid], replay[aid]
            assert got["dominant_phase"] == want["dominant_phase"] == "local_sort"
            for key in ("phase_wall_s", "queue_wait_s", "compile_s", "execute_s"):
                assert got["splits"][key] == pytest.approx(want["splits"][key], abs=1e-5)
        assert journaled["A"]["straggler"] and journaled["A"]["degraded"]
        assert not journaled["B"]["straggler"]
        merged = merge_records([records["A"], records["B"]])
        straggler = analyze_records(merged)["straggler"]
        assert straggler is not None and straggler["src"] == 0
        assert journaled["A"]["score"] == pytest.approx(straggler["score"], abs=1e-2)
        assert [e.fields["agent"] for e in jc.events() if e.type == "agent_degraded"] == ["A"]
    finally:
        close_all(ctl, [a, b])


def _prime_and_submit_big(routing: str, journal, flight_dir=None, telemetry=None):
    """Slow agent A, fast agent B: one small job (the load tie gives it to
    A), the verdicts until A is degraded, then one big job; its route."""
    a = FleetAgent(runner=SLOW, agent_id="A")
    b = FleetAgent(runner=FAST, agent_id="B")
    # B reports its first delta on a heartbeat: ping often.
    ctl = FleetController([a.addr, b.addr], heartbeat_s=0.2, journal=journal, routing=routing,
                          flight_dir=flight_dir, telemetry=telemetry)
    try:
        d = np.arange(1000, dtype=np.int32)[::-1].copy()
        np.testing.assert_array_equal(ctl.submit(d, tenant="t")[1].result(timeout=60),
                                      np.sort(d))
        wait_for(ctl, lambda: (ctl.health.verdicts().get("A", {}).get("degraded")
                               and "B" in ctl.health.verdicts()), what="A degraded")
        big = np.arange(proto.FLEET_SMALL_JOB_MAX, dtype=np.int32)[::-1].copy()
        np.testing.assert_array_equal(ctl.submit(big, tenant="t")[1].result(timeout=120),
                                      np.sort(big))
        big_routes = [e.fields for e in journal.events() if e.type == "job_routed"
                      and e.fields["n_keys"] >= proto.FLEET_SMALL_JOB_MAX]
        assert len(big_routes) == 1
        return big_routes[0], ctl.stats()
    finally:
        close_all(ctl, [a, b])


def test_health_routing_places_the_big_job_off_the_straggler(tmp_path):
    """``routing="health"`` sends the big job to the clean agent B and the
    degraded flip dumps one flight bundle of the fleet's state; locality
    (size) routing leaves it on A, which wins the load tie."""
    from dsort_tpu_torch.obs.flight import FlightRecorder

    flight_dir = str(tmp_path / "flight")
    route, stats = _prime_and_submit_big("health", EventLog(), flight_dir=flight_dir)
    assert (route["agent"], route["reason"]) == ("B", "health")
    assert stats["agents_degraded"] == 1
    bundles = FlightRecorder.read_bundles(flight_dir)
    assert bundles and bundles[0]["recovery_path"] == "agent_degraded"
    assert bundles[0]["detail"]["agent"] == "A"
    assert {s["agent"] for s in bundles[0]["state"]} == {"A", "B"}
    route, _ = _prime_and_submit_big("locality", EventLog())
    assert (route["agent"], route["reason"]) == ("A", "size")


def test_health_gauges_scrape_and_top_pane():
    """The controller's per-agent gauges scrape as the reference's and
    render in ``top``'s health pane and the fleet view."""
    from dsort_tpu_torch.obs import Telemetry
    from dsort_tpu_torch.obs.telemetry import parse_prometheus_text
    from dsort_tpu_torch.obs.top import render_fleet, render_top

    tel = Telemetry()
    route, _ = _prime_and_submit_big("health", EventLog(), telemetry=tel)
    assert route["agent"] == "B"
    parsed = parse_prometheus_text(tel.render_prometheus())
    assert parsed[("dsort_agent_health_score", (("agent", "A"),))] >= 1.5
    assert parsed[("dsort_agent_health_degraded", (("agent", "A"),))] == 1.0
    assert parsed[("dsort_agent_health_degraded", (("agent", "B"),))] == 0.0
    assert parsed[("dsort_fleet_agents_degraded", ())] == 1.0
    info = [dict(labels) for (name, labels), _ in parsed.items()
            if name == "dsort_agent_health_info" and dict(labels)["agent"] == "A"]
    assert len(info) == 1 and info[0]["dominant_phase"] == "local_sort"
    assert info[0]["straggler"] == "1"
    top = render_top(parsed)
    assert "health:" in top and "A*" in top and "local_sort" in top
    assert "health:" in render_fleet([("http://ctl/metrics", parsed)])


def test_heartbeats_only_controller_streams_no_telemetry():
    """``health_telemetry=False`` opts no agent in: no frame flows, no
    verdict forms; the opt-in follows the controller that attached last."""
    a = FleetAgent(runner=FAST, agent_id="A")
    d = np.arange(500, dtype=np.int32)[::-1].copy()

    def run_job(ctl):
        np.testing.assert_array_equal(ctl.submit(d, tenant="t")[1].result(timeout=60),
                                      np.sort(d))
        # Three heartbeat rounds after the job: a frame would have come.
        seen = ctl._svc_metrics.counters["fleet_heartbeats"]
        wait_for(ctl, lambda: ctl._svc_metrics.counters["fleet_heartbeats"] >= seen + 3,
                 what="three heartbeats")

    try:
        off = FleetController([a.addr], heartbeat_s=0.1, health_telemetry=False)
        try:
            run_job(off)
            assert off.health_verdicts() == {} and off.health.frames == 0
            assert a._collector is None
        finally:
            off.shutdown(drain=True, timeout=30)
        on = FleetController([a.addr], heartbeat_s=0.1)
        try:
            run_job(on)
            assert on.health.frames > 0 and a._collector is not None
        finally:
            on.shutdown(drain=True, timeout=30)
        off = FleetController([a.addr], heartbeat_s=0.1, health_telemetry=False)
        try:
            run_job(off)
            assert off.health.frames == 0 and not a._telemetry_on
        finally:
            off.shutdown(drain=True, timeout=30)
    finally:
        a.close()


def test_agent_advertises_bounded_recent_variants():
    """The advertisement keeps the newest rungs, at most
    `proto.MAX_ADVERTISED_VARIANTS`, oldest evicted first."""
    agent = FleetAgent(runner=FAST, agent_id="bnd")
    try:
        vc = agent.service.variants
        for i in range(60):
            vc._insert(("fused", 8 * (i + 1), "int32", "auto"), vc.TOKEN, None)
        labels = agent.variant_labels()
        assert len(labels) <= proto.MAX_ADVERTISED_VARIANTS
        assert "fused|480|int32|auto" in labels and "fused|8|int32|auto" not in labels
    finally:
        agent.close(drain=False)


def test_fleet_journals_carry_peer_blessings_and_merge():
    """The controller journals the agent's (wall, mono) pair and the agent
    the controller's; the port's merge orders the pair's journals."""
    ja, jc = EventLog(), EventLog()
    a = FleetAgent(runner=FAST, agent_id="A", journal=ja)
    ctl = FleetController([a.addr], heartbeat_s=60, journal=jc)
    try:
        d = np.arange(100, dtype=np.int32)[::-1].copy()
        np.testing.assert_array_equal(ctl.submit(d, tenant="t")[1].result(timeout=60),
                                      np.sort(d))
        ctl_bless = [e.fields for e in jc.events() if e.type == "clock_sync" and e.fields.get("peer")]
        assert ctl_bless and ctl_bless[0]["peer"] == "A"
        assert isinstance(ctl_bless[0]["peer_mono"], float)
        agent_bless = [e.fields for e in ja.events()
                       if e.type == "clock_sync" and e.fields.get("peer")]
        assert agent_bless and agent_bless[0]["peer"] == ctl.controller_id
        merged = merge_records([[e.to_dict() for e in jc.events()],
                                [e.to_dict() for e in ja.events()]])
        types = [r["type"] for r in merged]
        assert types.index("job_routed") < types.index("job_done")
    finally:
        close_all(ctl, [a])
