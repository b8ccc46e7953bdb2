"""The port's fleet plane against the JAX package's: the wire protocol
frame for frame, the torch-free ladder twins, each package's controller
over the other's agents, the same job sequence through both, the drills
(draining, ``no_capacity``, agent loss, controller restart) and a
``state_dir`` restored across the packages in both directions, the
``FLEET_*`` keys and ``cli fleet`` / ``cli fleet-agent``.

The agents here run a runner (``np.sort`` behind the service's admission,
fairness and shutdown) or a ``SortService`` of 4 virtual workers on the
CPU; every wait is a condition with a deadline (`wait_for`), never a
sleep.  The helpers here serve ``test_torch_fleet_health.py`` too.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from collections import Counter

import numpy as np
import pytest

from dsort_tpu.analysis.spec import assert_conformant as jax_assert_conformant
from dsort_tpu.config import SortConfig as JaxSortConfig
from dsort_tpu.fleet import proto as jproto
from dsort_tpu.fleet.agent import FleetAgent as JaxAgent
from dsort_tpu.fleet.controller import FleetController as JaxController
from dsort_tpu.obs import prof as jprof
from dsort_tpu.serve.policy import ControlPolicy as JaxPolicy
from dsort_tpu.utils.events import EventLog as JaxEventLog

from dsort_tpu_torch.analysis.spec.contracts import assert_conformant
from dsort_tpu_torch.config import ConfigError, FleetConfig, SortConfig
from dsort_tpu_torch.fleet import proto
from dsort_tpu_torch.fleet.agent import FleetAgent
from dsort_tpu_torch.fleet.controller import FleetController
from dsort_tpu_torch.obs import prof
from dsort_tpu_torch.obs.merge import merge_records
from dsort_tpu_torch.serve.policy import ControlPolicy
from dsort_tpu_torch.utils.events import EventLog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The two packages' fleet classes, by package.
PKG = {
    "port": (FleetController, FleetAgent, EventLog),
    "jax": (JaxController, JaxAgent, JaxEventLog),
}


def sort_runner(data, metrics, job_id=None):
    metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
    return np.sort(data)


def gated_runner(gate: threading.Event):
    """A runner that holds each job until ``gate`` is set (60 s at most)."""
    def run(data, metrics, job_id=None):
        gate.wait(60)
        metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
        return np.sort(data)

    return run


def agents_of(pkg: str, *ids, runner=sort_runner, journals=None):
    agent = PKG[pkg][1]
    return [agent(runner=runner, agent_id=aid, journal=journals[i] if journals else None)
            for i, aid in enumerate(ids)]


def close_all(ctl, agents):
    try:
        ctl.shutdown(drain=True, timeout=30)
    finally:
        for a in agents:
            a.close()


def wait_for(ctl, pred, timeout: float = 30.0, what: str = "condition"):
    """Wait on the controller's condition (notified at every transition)
    until ``pred()`` holds; fail after ``timeout`` seconds."""
    with ctl._cv:
        ok = ctl._cv.wait_for(pred, timeout=timeout)
    assert ok, f"{what} not reached within {timeout} s: {ctl.stats()}"


def persisted(ctl) -> bool:
    """The newest snapshot is on disk (caller holds _cv): a killed
    controller writes nothing more, so a drill kills it only after this."""
    return ctl._persist_written == ctl._persist_seq


def idle(ctl) -> bool:
    """No job routed, sending or in flight on any link (caller holds _cv)."""
    return not any(l.pending or l.dispatching or l.inflight for l in ctl._links.values())


@pytest.fixture
def empty_ledgers(monkeypatch):
    """Both packages' first-call ledgers are process-wide; the agents
    advertise them.  Runner agents run no variant, so an advertisement
    here is only what earlier tests in this process left: hide it, so
    the routing below depends on this test's jobs alone."""
    monkeypatch.setattr(prof.LEDGER, "snapshot", lambda: {})
    monkeypatch.setattr(jprof.LEDGER, "snapshot", lambda: {})


# -- the wire protocol ---------------------------------------------------------


class _Wire:
    """A socket stand-in that keeps what was sent and replays it."""

    def __init__(self, data: bytes = b""):
        self.sent, self._data = bytearray(), data

    def sendall(self, b):
        self.sent.extend(b)

    def recv(self, n):
        out, self._data = self._data[:n], self._data[n:]
        return out


def _frames():
    rng = np.random.default_rng(0)
    keys = rng.integers(-(1 << 31), 1 << 31, 1000).astype(np.int32)
    meta, payload = proto.encode_array(keys)
    meta64, payload64 = proto.encode_array(rng.integers(0, 1 << 62, (4, 5)).astype(np.int64))
    return {
        "hello": ({"type": "hello", "controller_id": "ctl-1", "known_jobs": ["a", "b"],
                   "telemetry": True, "wall": 1.5, "mono": 2.25}, b""),
        "submit": ({"type": "submit", "job_id": "ctl-1-000001", "tenant": "acme",
                    "label": None, **meta}, payload),
        "result": ({"type": "result", "job_id": "j", "ok": True, **meta64,
                    "variants": ["fused|1024|int32|auto"]}, payload64),
        "telemetry": ({"type": "telemetry", "agent_id": "A", "wall": 1.0, "mono": 2.0,
                       "delta": {"phases": {"local_sort": 0.5}, "waits": [0.1] * 3}}, b""),
        "unicode": ({"type": "rejected", "job_id": "j", "reason": "bad_payload: é"}, b""),
    }


@pytest.mark.parametrize("name", list(_frames()))
def test_frames_byte_identical_to_reference(name):
    header, payload = _frames()[name]
    ours, theirs = _Wire(), _Wire()
    proto.send_frame(ours, header, payload)
    jproto.send_frame(theirs, header, payload)
    assert bytes(ours.sent) == bytes(theirs.sent)
    # Each package reads the other's frame back.
    for recv, wire in ((proto.recv_frame, theirs), (jproto.recv_frame, ours)):
        got_header, got_payload = recv(_Wire(bytes(wire.sent)))
        assert got_payload == payload
        assert got_header == {**header, "payload_len": len(payload)}


@pytest.mark.parametrize("bad", [
    b"\x00\x00\x00\x00",                                    # zero-length header
    b"\xff\xff\xff\xff",                                    # implausible header
    b"\x00\x00\x00\x05hello",                               # not JSON
    b"\x00\x00\x00\x10" + b'{"type": "nope"}',              # unregistered type
    b"\x00\x00\x00\x25" + b'{"type": "ping", "payload_len": [1]} ',  # malformed length
    b"\x00\x00\x00\x22" + b'{"type": "ping", "payload_len": 9}' + b"abc",  # torn payload
], ids=["zero", "huge", "json", "type", "len", "torn"])
def test_malformed_frames_raise_in_both_packages(bad):
    for mod in (proto, jproto):
        with pytest.raises(mod.ProtocolError):
            mod.recv_frame(_Wire(bad))
    with pytest.raises(proto.ProtocolError, match="unregistered"):
        proto.send_frame(_Wire(), {"type": "bogus"})


def test_arrays_and_bounded_frames_match_reference():
    rng = np.random.default_rng(1)
    for dtype in (np.int32, np.int64, np.uint32, np.float32):
        x = rng.integers(0, 1000, 77).astype(dtype)
        meta, payload = proto.encode_array(x)
        assert (meta, payload) == jproto.encode_array(x)
        np.testing.assert_array_equal(proto.decode_array(meta, payload), x)
        with pytest.raises(proto.ProtocolError, match="bytes"):
            proto.decode_array(meta, payload[:-1])
    with pytest.raises(proto.ProtocolError, match="negative"):
        proto.decode_array({"dtype": "int32", "shape": [-1]}, b"")
    big = {"type": "telemetry", "variants": [f"fused|{8 * i}|int32|auto" for i in range(400)],
           "delta": {"waits": list(range(2000)), "compiles": [{"v": i} for i in range(300)],
                     "phases": {f"phase_{i:03d}": float(i) for i in range(60)}}}
    assert proto.bounded_frame(big) == jproto.bounded_frame(big)
    assert proto.frame_bytes(proto.bounded_frame(big)) <= proto.TELEMETRY_BYTE_BUDGET
    small = {"type": "heartbeat", "variants": ["a"]}
    assert proto.bounded_frame(small) is small


def test_ladder_twins_pinned_to_the_ports_sort_path():
    """The controller's torch-free twins equal the port's sort path and the
    reference's twins: the rung (`pad_rung`), the ledger label
    (`obs.prof.variant_label`) and the size split."""
    from dsort_tpu_torch.models.pipelines import FUSED_SMALL_JOB_MAX, pad_rung
    from dsort_tpu_torch.serve.variants import fused_variant_key, spmd_variant_key

    assert proto.FLEET_SMALL_JOB_MAX == FUSED_SMALL_JOB_MAX == jproto.FLEET_SMALL_JOB_MAX
    assert proto.ROUTING_POLICIES == jproto.ROUTING_POLICIES
    rng = np.random.default_rng(0)
    for n in [1, 7, 8, 9, 100, 1 << 10, (1 << 16) + 3] + [int(v) for v in
                                                          rng.integers(1, 1 << 22, 200)]:
        assert proto.fused_rung(n) == pad_rung(n) == jproto.fused_rung(n), n
        for dtype in ("int32", "int64", "uint32", "float32"):
            key = fused_variant_key(n, dtype, "auto")
            label = proto.variant_label_of_key(key)
            assert label == prof.variant_label(key) == jproto.variant_label_of_key(key)
            assert label.startswith(proto.fused_rung_prefix(n, dtype))
            assert proto.fused_rung_prefix(n, dtype) == jproto.fused_rung_prefix(n, dtype)
        key = spmd_variant_key(n, 8, "int32", "auto", 2.0, "ring")
        assert proto.variant_label_of_key(key) == prof.variant_label(key)


def test_parse_agent_addrs_as_reference():
    for spec in ("a:1, b:2", [("h", 9)], ["h:9", "g:8"]):
        assert proto.parse_agent_addrs(spec) == jproto.parse_agent_addrs(spec)
    for bad, match in (("nocolon", "HOST:PORT"), ("", "no agent")):
        with pytest.raises(ValueError, match=match):
            proto.parse_agent_addrs(bad)


# -- the controller and the agents across packages -------------------------------


def _sequential(ctl, sizes, seed=0, tenants=("t0", "t1")):
    """Submit one job at a time and wait for the fleet to go idle after
    each, so every dispatch sees every agent free."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate(sizes):
        d = rng.integers(0, 10**6, n, dtype=np.int32)
        verdict, ticket = ctl.submit(d, tenant=tenants[i % len(tenants)])
        assert verdict.admitted
        np.testing.assert_array_equal(ticket.result(timeout=60), np.sort(d))
        wait_for(ctl, lambda: idle(ctl), what="idle fleet")


SIZES = [2000, 1000, 2000, 1000, 3000, 2000, 1000, 3000]


@pytest.mark.parametrize("routing", ["locality", "random"])
@pytest.mark.parametrize("ctl_pkg,agent_pkg", [("port", "jax"), ("jax", "port")])
def test_controllers_sort_over_the_other_packages_agents(ctl_pkg, agent_pkg, routing,
                                                         empty_ledgers):
    controller, _, log = PKG[ctl_pkg]
    agents = agents_of(agent_pkg, "A", "B")
    journal = log()
    ctl = controller([a.addr for a in agents], heartbeat_s=60, journal=journal,
                     routing=routing, routing_seed=3)
    try:
        _sequential(ctl, SIZES)
        routed = [e.fields for e in journal.events() if e.type == "job_routed"]
        assert len(routed) == len(SIZES) and {r["reason"] for r in routed} <= {
            "locality", "spill", "random"}
        assert ctl.stats()["done"] == len(SIZES)
    finally:
        close_all(ctl, agents)


def _one_package_run(pkg: str, routing: str):
    controller, _, log = PKG[pkg]
    agents = agents_of(pkg, "A", "B")
    journal = log()
    ctl = controller([a.addr for a in agents], heartbeat_s=60, journal=journal,
                     routing=routing, routing_seed=7, health_telemetry=False)
    try:
        _sequential(ctl, SIZES)
        stats = ctl.stats()
    finally:
        close_all(ctl, agents)
    routed = [(e.fields["agent"], e.fields["reason"]) for e in journal.events()
              if e.type == "job_routed"]
    return routed, Counter(e.type for e in journal.events()), stats


@pytest.mark.parametrize("routing", ["locality", "random"])
def test_same_jobs_route_alike_in_both_packages(routing, empty_ledgers):
    """The same job sequence through each package's controller and agents:
    the same (agent, reason) routing sequence, the same multiset of event
    types in the controller's journal, the same stats."""
    got, want = _one_package_run("port", routing), _one_package_run("jax", routing)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    if routing == "locality":
        # Every job of one size on one agent: its rung's home.
        homes = {}
        for n, (agent, _) in zip(SIZES, got[0]):
            homes.setdefault(n, set()).add(agent)
        assert all(len(v) == 1 for v in homes.values()), homes


def test_port_agent_over_a_cpu_service(empty_ledgers):
    """A port agent over a real `SortService` (4 virtual workers on the
    CPU) behind the reference's controller: the fused small jobs run the
    variant cache, the agent advertises the rung labels the controller's
    locality prefix matches, and a big job takes the whole mesh."""
    from dsort_tpu_torch.config import JobConfig

    agents = [FleetAgent(num_workers=4, device="cpu", job=JobConfig(settle_delay_s=0.01),
                         agent_id=aid) for aid in ("A", "B")]
    journal = JaxEventLog()
    ctl = JaxController([a.addr for a in agents], heartbeat_s=60, journal=journal)
    try:
        rng = np.random.default_rng(2)
        for n in (3000, 3000, 5000, proto.FLEET_SMALL_JOB_MAX):
            d = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
            np.testing.assert_array_equal(ctl.submit(d, tenant="t")[1].result(timeout=120),
                                          np.sort(d))
            wait_for(ctl, lambda: idle(ctl))
        labels = agents[0].variant_labels()
        assert any(v.startswith(proto.fused_rung_prefix(3000, "int32")) for v in labels)
        routed = [(e.fields["agent"], e.fields["reason"]) for e in journal.events()
                  if e.type == "job_routed"]
        assert routed[:2] == [("A", "spill"), ("A", "locality")]
        assert routed[-1][1] == "size"
        assert all(a.big_jobs for a in agents)
    finally:
        close_all(ctl, agents)


# -- drills ------------------------------------------------------------------------


def test_draining_agent_is_routed_around():
    journal = EventLog()
    agents = agents_of("port", "A", "B")
    agents[0].drain()  # before the controller connects: the welcome says so
    ctl = FleetController([a.addr for a in agents], heartbeat_s=60, journal=journal)
    try:
        d = np.arange(500, dtype=np.int32)[::-1].copy()
        tickets = [ctl.submit(d, tenant="t")[1] for _ in range(3)]
        for t in tickets:
            np.testing.assert_array_equal(t.result(timeout=60), np.sort(d))
        assert {e.fields["agent"] for e in journal.events() if e.type == "job_routed"} == {"B"}
    finally:
        close_all(ctl, agents)


def test_every_agent_draining_rejects_no_capacity():
    from dsort_tpu_torch.obs import Telemetry

    journal, tel = EventLog(), Telemetry()
    agents = agents_of("port", "A", "B")
    for a in agents:
        a.drain()
    ctl = FleetController([a.addr for a in agents], heartbeat_s=60, journal=journal,
                          telemetry=tel)
    try:
        for _ in range(2):
            verdict, ticket = ctl.submit(np.arange(100, dtype=np.int32), tenant="acme")
            assert ticket is None and not verdict.admitted and verdict.reason == "no_capacity"
        rej = [e.fields for e in journal.events() if e.type == "job_rejected"]
        assert [r["reason"] for r in rej] == ["no_capacity"] * 2
        # Each rejection is a job of its own, so the lifecycle contract holds.
        assert len({r["job"] for r in rej}) == 2
        assert_conformant([e.to_dict() for e in journal.events()])
        assert tel.snapshot()["admissions"]["acme/no_capacity"] == 2
    finally:
        close_all(ctl, agents)


@pytest.mark.parametrize("agent_pkg", ["port", "jax"])
def test_agent_loss_reroutes_the_inflight_job(agent_pkg):
    """A dead agent's in-flight job is re-routed (``agent_lost``) and
    completes on the survivor."""
    gate = threading.Event()
    _, agent, _ = PKG[agent_pkg]
    a = agent(runner=gated_runner(gate), agent_id="A")
    b = agent(runner=sort_runner, agent_id="B")
    journal = EventLog()
    # The reference's kill() closes its sockets without ending the streams:
    # the controller learns of that death at its next ping.
    ctl = FleetController([a.addr, b.addr], heartbeat_s=0.3, journal=journal)
    try:
        d = np.arange(777, dtype=np.int32)[::-1].copy()
        verdict, ticket = ctl.submit(d, tenant="t")
        assert verdict.admitted
        # Both idle: the load tie breaks on the label, A takes it.
        wait_for(ctl, lambda: ctl.stats()["in_flight"] == 1)
        # kill() drops the sockets at once, then waits out its service.
        threading.Thread(target=a.kill, daemon=True).start()
        np.testing.assert_array_equal(ticket.result(timeout=60), np.sort(d))
        rr = [e.fields for e in journal.events() if e.type == "job_rerouted"]
        assert len(rr) == 1 and rr[0]["reason"] == "agent_lost" and rr[0]["frm"] == "A"
        routed = [e.fields["agent"] for e in journal.events() if e.type == "job_routed"]
        assert routed == ["A", "B"]
        assert_conformant([e.to_dict() for e in journal.events()])
    finally:
        gate.set()
        close_all(ctl, [b])
        a.close(drain=False)


def _kill_with_backlog(controller, log, agents, state_dir, n_jobs=6):
    """Submit ``n_jobs`` to gated agents of capacity 1, wait for 2 in
    flight and the rest queued, kill the controller; returns the journal,
    the inputs by job id and the persisted DRR order."""
    journal = log()
    ctl = controller([a.addr for a in agents], state_dir=state_dir, heartbeat_s=60,
                     journal=journal)
    rng = np.random.default_rng(1)
    datas = []
    try:
        for i in range(n_jobs):
            d = rng.integers(0, 10**6, 400, dtype=np.int32)
            assert ctl.submit(d, tenant=("acme", "blue", "coral")[i % 3])[0].admitted
            datas.append(d)
        wait_for(ctl, lambda: (ctl.stats()["in_flight"] == 2
                               and ctl.stats()["queued"] == n_jobs - 2 and persisted(ctl)))
    finally:
        ctl.kill()
    state = json.load(open(os.path.join(state_dir, "controller_state.json")))
    assert {j["status"] for j in state["jobs"].values()} == {"inflight", "queued"}
    assert len(os.listdir(os.path.join(state_dir, "spool"))) == n_jobs
    replay = ControlPolicy()
    replay.load_state(state["policy"])
    order = []
    while (nxt := replay.pop()) is not None:
        order.append(nxt[1])
    jreplay = JaxPolicy()
    jreplay.load_state(state["policy"])
    jorder = []
    while (nxt := jreplay.pop()) is not None:
        jorder.append(nxt[1])
    assert order == jorder and len(order) == n_jobs - 2
    return journal, datas, order, sorted(state["jobs"])


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_controller_restart_loses_no_job(tmp_path, writer, reader):
    """Kill a controller with 2 jobs in flight and 4 queued; a controller
    of ``reader``'s package restores ``writer``'s ``state_dir``: it
    announces ``controller_restore`` before any dispatch, re-binds the
    in-flight jobs (one ``job_start`` per job on the agents, nothing
    re-routed) and drains the queue in the persisted DRR order."""
    gate = threading.Event()
    ja, jb = EventLog(), EventLog()
    agents = agents_of("port", "A", "B", runner=gated_runner(gate), journals=[ja, jb])
    state_dir = str(tmp_path / "state")
    try:
        j1, _, order, jids = _kill_with_backlog(*PKG[writer][::2], agents, state_dir)
        controller, _, log = PKG[reader]
        j2 = log()
        ctl2 = controller([a.addr for a in agents], state_dir=state_dir, heartbeat_s=60,
                          journal=j2)
        try:
            gate.set()
            wait_for(ctl2, lambda: ctl2.stats()["done"] + ctl2.stats()["failed"] >= 6,
                     timeout=60)
            assert ctl2.stats()["done"] == 6 and ctl2.stats()["failed"] == 0
        finally:
            ctl2.shutdown(drain=True, timeout=30)
    finally:
        gate.set()
        for a in agents:
            a.close()
    merged = merge_records([[e.to_dict() for e in lg.events()] for lg in (j1, j2, ja, jb)])
    starts = Counter(r.get("job_id") for r in merged
                     if r["type"] == "job_start" and r["src"] in (2, 3))
    assert sorted(starts) == jids and set(starts.values()) == {1}, starts
    report = assert_conformant(merged)
    assert report["contracts"]["controller_restore"]["checked"] == 1
    jax_assert_conformant(merged)
    restore = next(r for r in merged if r["type"] == "controller_restore")
    assert (restore["queued"], restore["inflight"], restore["src"]) == (4, 2, 1)
    assert not [r for r in merged if r["type"] == "job_rerouted"]
    assert [r["job_id"] for r in merged if r["type"] == "job_routed" and r["src"] == 1] == order
    assert not os.listdir(os.path.join(state_dir, "spool"))


def test_restart_requeues_the_job_lost_with_its_agent(tmp_path):
    gate = threading.Event()
    a = FleetAgent(runner=gated_runner(gate), agent_id="A")
    b = FleetAgent(runner=sort_runner, agent_id="B")
    state_dir = str(tmp_path / "state")
    ctl = FleetController([a.addr, b.addr], state_dir=state_dir, heartbeat_s=60)
    d = np.arange(300, dtype=np.int32)[::-1].copy()
    try:
        assert ctl.submit(d, tenant="t")[0].admitted
        wait_for(ctl, lambda: ctl.stats()["in_flight"] == 1 and persisted(ctl))
    finally:
        ctl.kill()
    gate.set()  # the job ends and its result waits on A, which dies now
    a.kill()
    j2 = EventLog()
    ctl2 = FleetController([a.addr, b.addr], state_dir=state_dir, heartbeat_s=60, journal=j2)
    try:
        wait_for(ctl2, lambda: ctl2.stats()["done"] == 1, timeout=60)
        rr = [e.fields for e in j2.events() if e.type == "job_rerouted"]
        assert [r["reason"] for r in rr] == ["agent_lost"]
        assert_conformant([e.to_dict() for e in j2.events()])
    finally:
        ctl2.shutdown(drain=True, timeout=30)
        b.close()


# -- config and CLI --------------------------------------------------------------


def test_fleet_conf_keys_parse_as_reference():
    m = {"FLEET_AGENTS": "h1:9200, h2:9200", "FLEET_STATE_DIR": "/tmp/fleet",
         "FLEET_ROUTING": "random", "FLEET_HEARTBEAT_S": "0.5",
         "FLEET_DISPATCH_TIMEOUT_S": "4.5", "FLEET_TELEMETRY": "0"}
    for mapping in (m, {}, {"FLEET_ROUTING": "health"}, {"FLEET_TELEMETRY": "yes"}):
        got, want = SortConfig.from_mapping(mapping), JaxSortConfig.from_mapping(mapping)
        assert dataclasses.asdict(got.fleet) == dataclasses.asdict(want.fleet)
        assert got.job.explicit == want.job.explicit
    assert SortConfig.from_mapping(m).fleet.agents == ("h1:9200", "h2:9200")
    for bad, match in ((dict(routing="mystery"), "routing"), (dict(heartbeat_s=0), "heartbeat"),
                       (dict(dispatch_timeout_s=0), "dispatch_timeout"),
                       (dict(agents=("nocolon",)), "HOST:PORT")):
        with pytest.raises(ConfigError, match=match):
            FleetConfig(**bad)


_TORCH_BLOCKED = r"""
import sys
sys.modules["torch"] = None
sys.modules["jax"] = None
from dsort_tpu_torch.fleet.controller import FleetController
from dsort_tpu_torch.obs.health import HealthAnalyzer
from dsort_tpu_torch.obs import plan, flight
from dsort_tpu_torch.serve.policy import ControlPolicy
from dsort_tpu_torch import cli
assert ControlPolicy().consider("t").admitted
c = FleetController(["127.0.0.1:1"], heartbeat_s=60, start=False, flight_dir=sys.argv[1])
assert c.stats()["agents"] == 0
c.kill()
print("torch-free")
"""


def test_controller_imports_and_builds_with_torch_blocked(tmp_path):
    """The controller, the health analyzer, the planner and the CLI module
    import, and a `FleetController` builds, where importing torch raises."""
    proc = subprocess.run([sys.executable, "-c", _TORCH_BLOCKED, str(tmp_path / "fl")],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "torch-free"


def test_cli_fleet_repl_over_two_agents(tmp_path, monkeypatch):
    from dsort_tpu_torch import cli

    agents = agents_of("port", "A", "B")
    rng = np.random.default_rng(3)
    files, datas = [], []
    for i in range(3):
        d = rng.integers(0, 10**6, 700 + i * 100, dtype=np.int64)
        p = tmp_path / f"in{i}.txt"
        np.savetxt(p, d, fmt="%d")
        files.append(p)
        datas.append(d)
    lines = iter([f"tenant=acme {files[0]}", f"tenant=blue {files[1]}",
                  f"tenant=acme {files[2]}", "exit"])
    monkeypatch.setattr("builtins.input", lambda *_: next(lines))
    journal = tmp_path / "fleet.jsonl"
    try:
        rc = cli.main(["fleet", "--agents", ",".join(a.addr for a in agents), "--dtype",
                       "int64", "--state-dir", str(tmp_path / "state"), "-o",
                       str(tmp_path / "out.txt"), "--journal", str(journal)])
    finally:
        for a in agents:
            a.close()
    assert rc == 0
    records = EventLog.read_jsonl(str(journal))
    types = [r["type"] for r in records]
    assert types.count("job_routed") == 3 and types.count("job_done") == 3
    assert "agent_register" in types and types[-1] == "serve_stop"
    assert {r["tenant"] for r in records if r["type"] == "job_admitted"} == {"acme", "blue"}
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "out.txt", dtype=np.int64),
                                  np.sort(datas[-1]))
    with pytest.raises(SystemExit, match="--agents"):
        cli.main(["fleet"])


def test_cli_fleet_agent_process_serves_the_reference_controller(tmp_path):
    """``cli fleet-agent --workers 4 --device cpu`` as a process: it prints
    its address, sorts jobs the reference's controller routes to it (a
    fused small job and a big job on its whole mesh), and drains to exit
    0 on SIGTERM with its journal written."""
    journal = tmp_path / "agent.jsonl"
    p = subprocess.Popen(
        [sys.executable, "-m", "dsort_tpu_torch.cli", "fleet-agent", "--workers", "4",
         "--device", "cpu", "--port", "0", "--agent-id", "cliA", "--journal", str(journal)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    try:
        line = p.stdout.readline()
        assert "fleet agent cliA listening on" in line, line
        addr = line.strip().rsplit(" ", 1)[-1]
        ctl = JaxController([addr], heartbeat_s=60)
        try:
            rng = np.random.default_rng(5)
            for n in (1200, proto.FLEET_SMALL_JOB_MAX):
                d = rng.integers(0, 1 << 30, n).astype(np.int32)
                verdict, ticket = ctl.submit(d, tenant="acme", job_id=f"cli-{n}")
                assert verdict.admitted
                np.testing.assert_array_equal(ticket.result(timeout=120), np.sort(d))
        finally:
            ctl.shutdown(drain=True, timeout=30)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
    records = EventLog.read_jsonl(str(journal))
    types = [r["type"] for r in records]
    assert "clock_sync" in types and types.count("job_done") >= 2
    assert {r.get("tenant") for r in records if r["type"] == "job_admitted"} == {"acme"}
    assert "fullmesh_dispatches" in json.dumps(records)


def test_a_flush_during_a_clean_shutdown_stays_durable(tmp_path):
    """A result that finishes while `shutdown` quiets the readers (which
    sets the threads' stop flag) still flushes, drops its spool and acks;
    only `kill` makes the controller write nothing more.  Under load the
    restart drill above caught a spool left behind by exactly that race."""
    from dsort_tpu_torch.fleet.controller import FleetController

    ctl = FleetController(["127.0.0.1:1"], state_dir=str(tmp_path), heartbeat_s=60,
                          start=False)
    with ctl._cv:
        ctl._persist_locked()
    ctl._dead = True  # shutdown's last step
    assert ctl._flush_persist()
    assert os.path.exists(tmp_path / "controller_state.json")
    with ctl._cv:
        ctl._persist_locked()
    ctl.kill()
    assert not ctl._flush_persist()
