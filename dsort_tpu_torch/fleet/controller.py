"""Fleet controller: the cross-process pure control plane.

Counterpart of ``dsort_tpu/fleet/controller.py``.  `FleetController` is
the control half of `serve.SortService`: admission, weighted-DRR fairness
and SLO shedding run here as one serializable state machine
(`serve.policy.ControlPolicy`) over a fleet of execution agents
(`fleet.agent`, each a `SortService` on the card) spoken to in framed
JSON (`fleet.proto`).  This module never imports torch, not even through
the modules it imports (test-enforced by a torch-blocked subprocess
import): the front door admits, queues and routes without owning a card,
and sorts nothing itself.

**Routing** (`job_routed`, with a reason): big jobs (at least
`proto.FLEET_SMALL_JOB_MAX` keys) go to a ``big_jobs`` agent (the whole
mesh); small jobs route by **variant-cache locality**: agents advertise
their cached variants and first-call ledger labels in heartbeats, the
controller computes the job's capacity-ladder rung with the pure twin
`proto.fused_rung`, and a job whose rung has already run on agent B
prefers B (a sticky affinity map makes the preference deterministic
before the first heartbeat refresh).  ``routing="random"`` is the A/B
baseline (``cli bench --fleet-mixed``); ``routing="health"`` keeps
locality for small jobs but places big jobs on the agent whose measured
straggler profile is cleanest: agents stream bounded ``telemetry``
deltas on the heartbeat cadence, `obs.health.HealthAnalyzer` folds them
into rolling per-agent why-slow verdicts (journaled ``health_verdict``,
per-agent ``/metrics`` gauges, ``cli top``), and a degraded flip dumps a
flight bundle.  A draining agent takes no new work; a dead agent's
in-flight jobs re-enter the queue (`job_rerouted`).

**A restart loses no job**: every admission, dispatch and completion
persists the control-plane state (policy snapshot and job table)
atomically under ``state_dir`` (``controller_state.json``, the
reference's schema, so either package's controller restores the other's
state), and queued payloads spool to ``state_dir/spool/<job>.npy``.  A
restarted controller journals `controller_restore`, re-attaches to its
agents with the journaled job ids (``hello.known_jobs``), re-binds the
jobs the agents report ``running``, takes the held results of ``done``
ones, re-queues only the lost, and drains the queued backlog in the DRR
order the dead controller would have used.
"""

from __future__ import annotations

import os
import json
import random
import socket
import threading
import time
import uuid

import numpy as np

from dsort_tpu_torch.fleet.proto import (
    FLEET_SMALL_JOB_MAX,
    ROUTING_POLICIES,
    ProtocolError,
    clock_pair,
    decode_array,
    encode_array,
    fused_rung_prefix,
    parse_agent_addrs,
    recv_frame,
    send_frame,
)
from dsort_tpu_torch.obs.health import HealthAnalyzer
from dsort_tpu_torch.serve.admission import Admission
from dsort_tpu_torch.serve.policy import ControlPolicy
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, new_job_ordinal

log = get_logger("fleet.controller")

_STATE_FILE = "controller_state.json"


class ControllerClosed(RuntimeError):
    """The controller is shut down; the job was not (or will not be) run."""


class LaneBusy(RuntimeError):
    """A per-link request slot was busy within the caller's lock bound —
    the caller should skip this round, not fail the agent."""


class FleetTicket:
    """Future-style handle for one admitted fleet job (`JobTicket` twin)."""

    def __init__(self, jid: str, tenant: str, n_keys: int, metrics: Metrics):
        self.jid = jid
        self.tenant = tenant
        self.n_keys = n_keys
        self.metrics = metrics
        self._done = threading.Event()
        self._result: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"fleet job {self.jid} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class _Job:
    """Controller-side record of one fleet job."""

    def __init__(self, jid: str, tenant: str, n_keys: int, dtype: str,
                 label: str | None, ticket: FleetTicket):
        self.jid = jid
        self.tenant = tenant
        self.n_keys = n_keys
        self.dtype = dtype
        self.label = label
        self.ticket = ticket
        # queued | dispatching (handed to an agent lane) | inflight
        # (agent accepted) | done | failed
        self.status = "queued"
        self.agent: str | None = None  # agent_id while dispatching/inflight
        self.readmits = 0
        self.data: np.ndarray | None = None  # in-memory payload (pre-spool)
        self.queued_mono = time.monotonic()

    def state(self) -> dict:
        return {
            "tenant": self.tenant, "n_keys": self.n_keys,
            "dtype": self.dtype, "label": self.label,
            # "dispatching" persists as "inflight": across a restart the
            # agent may or may not have received the submit, and the
            # reconcile pass already resolves exactly that ambiguity (the
            # agent reports running/done/failed/unknown; unknown re-queues
            # — at-least-once, never lost).
            "status": (
                "inflight" if self.status == "dispatching" else self.status
            ),
            "agent": self.agent,
            "readmits": self.readmits,
        }


class _AgentLink:
    """One controller<->agent connection with its advertised state."""

    def __init__(self, addr: tuple[str, int]):
        self.addr = addr
        self.aid: str | None = None      # agent_id once welcomed
        self.sock = None
        self.alive = False
        self.draining = False
        self.big_jobs = False
        self.capacity = 1
        self.variants: set[str] = set()
        self.inflight: set[str] = set()  # fleet jids dispatched here
        self.pending: list[str] = []     # jids routed here, lane not yet sent
        self.dispatching = 0             # jobs the lane is actively sending
        self.job_statuses: dict[str, str] = {}  # last welcome's re-attach map
        self.send_lock = threading.Lock()
        self.req_lock = threading.Lock()   # one outstanding request
        self._replies: list = []
        self._reply_cv = threading.Condition()

    def label(self) -> str:
        return self.aid or f"{self.addr[0]}:{self.addr[1]}"


class FleetController:
    """Route sort jobs over many mesh-owning agents; survive restarts."""

    def __init__(
        self,
        agents,
        state_dir: str | None = None,
        *,
        max_queue_depth: int = 64,
        max_tenant_inflight: int = 16,
        drr_quantum_keys: int = 1 << 14,
        tenant_weights: dict | None = None,
        slo_shed_ms: float | None = None,
        routing: str = "locality",
        routing_seed: int = 0,
        heartbeat_s: float = 2.0,
        request_timeout_s: float = 30.0,
        dispatch_timeout_s: float | None = None,
        default_tenant: str = "default",
        journal=None,
        journal_path: str | None = None,
        telemetry=None,
        controller_id: str | None = None,
        health_telemetry: bool = True,
        degraded_score: float = 1.5,
        flight_dir: str | None = None,
        autotune: bool = False,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
        start: bool = True,
    ):
        if routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing must be one of {ROUTING_POLICIES}, got {routing!r}"
            )
        self.controller_id = controller_id or f"ctl-{uuid.uuid4().hex[:8]}"
        self.state_dir = str(state_dir) if state_dir else None
        self.routing = routing
        self._rng = random.Random(routing_seed)
        self.heartbeat_s = float(heartbeat_s)
        self.request_timeout_s = float(request_timeout_s)
        # The per-agent SEND deadline: how long one agent may sit on a
        # submit before it is failed over.  Bounded separately from the
        # request timeout so a stuck-but-connected agent costs its own
        # lane at most this long (it never stalls the fleet — dispatch
        # runs on per-agent lanes).
        self.dispatch_timeout_s = (
            float(dispatch_timeout_s) if dispatch_timeout_s is not None
            else self.request_timeout_s
        )
        # Whether the deadline was hand-set: the planner's
        # dispatch_timeout_s policy (obs.plan) only fills the knob when
        # the user left it genuinely unset — an explicit value wins and
        # journals a plan_override (the same precedence as redundancy).
        self._dispatch_timeout_explicit = dispatch_timeout_s is not None
        self.default_tenant = default_tenant
        self.journal = journal
        self.journal_path = journal_path
        self.telemetry = telemetry
        self._policy = ControlPolicy(
            max_queue_depth=max_queue_depth,
            max_tenant_inflight=max_tenant_inflight,
            drr_quantum_keys=drr_quantum_keys,
            tenant_weights=dict(tenant_weights or {}),
            slo_shed_ms=slo_shed_ms,
        )
        self._cv = threading.Condition()
        self._flush_lock = threading.Lock()
        # Persist pipeline: snapshots build under _cv (cheap dict work),
        # file IO runs OUTSIDE it (`_flush_persist`) — a slow fsync must
        # not serialize the whole control plane behind the lock.
        self._persist_lock = threading.Lock()
        self._persist_seq = 0
        self._persist_written = 0
        self._persist_pending: tuple | None = None
        self._jobs: dict[str, _Job] = {}
        self._links: dict[tuple, _AgentLink] = {
            addr: _AgentLink(addr) for addr in parse_agent_addrs(agents)
        }
        self._affinity: dict[str, str] = {}  # rung prefix -> agent_id
        self._seq = 0
        self._shutdown = False
        self._dead = False  # threads stop: a kill, or a shutdown's last step
        # `kill` alone: a killed controller writes and deletes nothing more.
        # A clean shutdown also sets `_dead` to quiet its readers, but a
        # result finishing beside it still flushes and drops its spool.
        self._killed = False
        self._closed = False
        self._done_jobs = 0
        self._failed_jobs = 0
        self._svc_metrics = Metrics(journal=journal)
        if telemetry is not None:
            telemetry.attach(self._svc_metrics)
        # The live health plane: agents stream bounded
        # telemetry deltas on the heartbeat cadence; the analyzer folds
        # them into rolling per-agent why-slow verdicts the `health`
        # routing arm and the degraded->flight-bundle contract read.
        self.health_telemetry = bool(health_telemetry)
        self.health = HealthAnalyzer(
            degraded_score=degraded_score, slo_ms=slo_shed_ms,
        )
        self._degraded: dict[str, bool] = {}
        # Closed-loop redundancy policy (obs.plan): with
        # autotune on and no explicit ``redundancy``, every dispatch stamps
        # a planned ``r`` into its submit header, sized from the observed
        # loss rate + the rolling health verdicts.  An explicit value wins
        # and journals a plan_override.  The planner rides the controller
        # journal's own events (health_verdict, agent-loss reroutes), so
        # its state replays from the journal alone.
        from dsort_tpu_torch.obs.plan import Planner

        self.autotune = bool(autotune)
        self.redundancy = int(redundancy) if redundancy is not None else None
        # The mode axis of the same policy: how a
        # planned r > 1 ships its premium — full copies when losses are
        # observed, parity slots when the fleet is merely degraded.
        self.redundancy_mode = (
            str(redundancy_mode) if redundancy_mode is not None else None
        )
        self.planner = Planner()
        self.planner.attach(self._svc_metrics)
        self.flight = None
        if flight_dir:
            from dsort_tpu_torch.obs.flight import FlightRecorder

            # Dumps ONLY on degraded flips: the agents' own services keep
            # their eviction recorders, and the schedulers theirs.
            self.flight = FlightRecorder(
                flight_dir, state_fn=self.agent_info,
                events=frozenset({"agent_degraded"}),
            )
            self.flight.attach(self._svc_metrics)
        if self.journal is not None:
            self.journal.emit("clock_sync", source=self.controller_id)
        restored = self._load_state()
        for link in self._links.values():
            self._connect(link)
        if restored is not None:
            self._reconcile_restore(restored)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="dsort-fleet-dispatch",
        )
        self._heartbeater = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="dsort-fleet-heartbeat",
        )
        # One dispatch lane per agent: the dispatcher only routes; the
        # lane does the socket round-trip.  A stuck-but-connected agent
        # blocks ITS lane, never fleet-wide dispatch.
        self._lanes = [
            threading.Thread(
                target=self._lane_loop, args=(link,), daemon=True,
                name=f"dsort-fleet-lane-{link.addr[1]}",
            )
            for link in self._links.values()
        ]
        self._started = False
        self._publish_gauges()
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._heartbeater.start()
            for lane in self._lanes:
                lane.start()

    def __enter__(self) -> "FleetController":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- persistence ---------------------------------------------------------

    def _state_path(self) -> str | None:
        return (
            os.path.join(self.state_dir, _STATE_FILE) if self.state_dir
            else None
        )

    def _spool_path(self, jid: str) -> str | None:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir, "spool", f"{jid}.npy")

    def _persist_locked(self) -> None:
        """Snapshot the control plane (caller holds ``_cv``).  Only the
        dict build happens here; the caller MUST call `_flush_persist`
        after releasing the lock — the restart contract still writes
        BEFORE any acknowledgement leaves the process, but disk latency
        never serializes the lock."""
        if self._state_path() is None:
            return
        agents = {
            l.aid: f"{l.addr[0]}:{l.addr[1]}"
            for l in self._links.values() if l.aid
        }
        state = {
            "version": 1,
            "controller_id": self.controller_id,
            "seq": self._seq,
            "policy": self._policy.state_dict(),
            "agents": agents,
            "jobs": {
                jid: j.state() for jid, j in self._jobs.items()
                if j.status in ("queued", "dispatching", "inflight")
            },
        }
        self._persist_seq += 1
        self._persist_pending = (self._persist_seq, state)

    def _flush_persist(self) -> bool:
        """Write the newest pending snapshot atomically (tmp+fsync+rename).
        Runs outside ``_cv``; the sequence guard keeps concurrent flushers
        monotonic — a thread whose snapshot was superseded writes the
        newer one (which includes its transition) or skips.  False when
        the caller's transition is not on disk: the controller was killed,
        and a dead process writes nothing more."""
        path = self._state_path()
        if path is None:
            return True
        with self._cv:
            pending = self._persist_pending
        if pending is None:
            return True
        seq, state = pending
        with self._persist_lock:
            if self._killed:
                return False
            if seq <= self._persist_written:
                return True  # a newer snapshot already landed
            os.makedirs(self.state_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._persist_written = seq
        with self._cv:
            self._cv.notify_all()  # a landed snapshot is a transition too
        return True

    def _load_state(self) -> dict | None:
        path = self._state_path()
        if path is None or not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            state = json.load(f)
        # __init__-time (no threads yet), but the guarded fields stay
        # lock-disciplined anyway — the lint contract is uniform.
        with self._cv:
            self._seq = int(state.get("seq", 0))
            jobs = dict(state.get("jobs", {}))
            for jid, rec in jobs.items():
                metrics = Metrics(journal=self.journal)
                if self.telemetry is not None:
                    self.telemetry.attach(metrics)
                ticket = FleetTicket(
                    jid, rec["tenant"], int(rec["n_keys"]), metrics
                )
                job = _Job(
                    jid, rec["tenant"], int(rec["n_keys"]),
                    rec.get("dtype", "int32"), rec.get("label"), ticket,
                )
                job.status = rec.get("status", "queued")
                job.agent = rec.get("agent")
                job.readmits = int(rec.get("readmits", 0))
                self._jobs[jid] = job
            self._policy.load_state(dict(state.get("policy", {})))
            queued = sum(
                1 for j in self._jobs.values() if j.status == "queued"
            )
            inflight = sum(
                1 for j in self._jobs.values() if j.status == "inflight"
            )
        self._svc_metrics.bump("controller_restores")
        self._svc_metrics.event(
            "controller_restore", controller=self.controller_id,
            queued=queued, inflight=inflight, agents=len(self._links),
        )
        log.warning(
            "controller state restored: %d queued + %d in-flight job(s) "
            "over %d agent(s)", queued, inflight, len(self._links),
        )
        return state

    def _reconcile_restore(self, state: dict) -> None:
        """Re-bind in-flight jobs to the agents that still run (or hold)
        them; re-queue only the truly lost.  Runs after the initial
        connect pass, BEFORE the dispatcher starts — nothing can race."""
        with self._cv:
            for jid, job in list(self._jobs.items()):
                if job.status != "inflight":
                    continue
                link = self._link_by_aid_locked(job.agent)
                status = "unknown"
                if link is not None and link.alive:
                    status = link.job_statuses.get(jid, "unknown")
                if status in ("running", "done", "failed"):
                    # Never interrupted: the result frame will arrive (for
                    # done/failed ones the agent resent it on attach and
                    # the reader thread is already applying it).
                    link.inflight.add(jid)
                    continue
                # "lost": the agent is up but forgot the job (it restarted
                # too); "agent_lost": the agent never reconnected.
                alive = link is not None and link.alive
                self._requeue_locked(
                    job, frm=job.agent,
                    reason="lost" if alive else "agent_lost",
                )
            self._persist_locked()
            self._cv.notify_all()
        self._flush_persist()

    # -- agent links ---------------------------------------------------------

    def _connect(self, link: _AgentLink) -> bool:
        """Dial one agent: hello/welcome handshake, then the reader thread.
        Known in-flight job ids ride the hello so the agent can report
        their fate (the re-attach contract)."""
        with self._cv:
            known = [
                jid for jid, j in self._jobs.items() if j.status == "inflight"
            ]
        try:
            sock = socket.create_connection(link.addr, timeout=self.request_timeout_s)
            sock.settimeout(self.request_timeout_s)
            send_frame(sock, {
                "type": "hello", "controller_id": self.controller_id,
                "known_jobs": known,
                # Opt the agent into the health-plane delta stream, and
                # carry our (wall, mono) pair so the agent can journal a
                # peer clock_sync blessing (monotonic journal alignment).
                "telemetry": self.health_telemetry,
                **clock_pair(),
            })
            frame = recv_frame(sock)
            if frame is None or frame[0].get("type") != "welcome":
                raise ProtocolError(f"expected welcome, got {frame and frame[0]}")
            welcome = frame[0]
        except (OSError, ProtocolError) as e:
            log.warning("agent %s:%d unreachable: %s", *link.addr, e)
            link.alive = False
            return False
        sock.settimeout(None)
        first = link.aid is None
        if (
            self.journal is not None
            and isinstance(welcome.get("mono"), (int, float))
        ):
            # Protocol clock sync: bless the agent's (wall, mono) pair in
            # OUR journal so `obs.merge` can rebase that agent's journal
            # onto this one's monotonic frame without trusting wall clocks.
            self.journal.emit(
                "clock_sync", source=self.controller_id,
                peer=str(welcome["agent_id"]),
                peer_t=welcome.get("wall"), peer_mono=welcome.get("mono"),
            )
        with self._cv:
            link.sock = sock
            link.aid = str(welcome["agent_id"])
            link.alive = True
            link.draining = bool(welcome.get("draining"))
            link.big_jobs = bool(welcome.get("big_jobs"))
            link.capacity = int(welcome.get("capacity", 1))
            link.variants = set(welcome.get("variants", ()))
            link.job_statuses = {
                str(k): str(v) for k, v in dict(welcome.get("jobs", {})).items()
            }
            self.health.set_active(link.aid, True)
            self._cv.notify_all()
        self._svc_metrics.event(
            "agent_register", agent=link.aid,
            addr=f"{link.addr[0]}:{link.addr[1]}", capacity=link.capacity,
            big_jobs=link.big_jobs, draining=link.draining,
            variants=len(link.variants), reattach=not first,
        )
        if self.telemetry is not None:
            self._publish_gauges()
        threading.Thread(
            target=self._reader_loop, args=(link, sock), daemon=True,
            name=f"dsort-fleet-read-{link.addr[1]}",
        ).start()
        return True

    def _reader_loop(self, link: _AgentLink, sock) -> None:
        try:
            while not self._dead:
                frame = recv_frame(sock)
                if frame is None:
                    raise OSError("agent closed the connection")
                if self._dead:
                    return  # killed while this frame arrived: act on nothing
                header, payload = frame
                if header["type"] == "result":
                    self._on_result(link, header, payload)
                elif header["type"] == "telemetry":
                    # Async like results: a delta must never be consumed
                    # as (or discarded with) a request's reply.  A
                    # heartbeats-only controller IGNORES strays — an
                    # agent a previous controller opted in must not make
                    # this one journal verdicts it promised not to.
                    if self.health_telemetry:
                        self._on_telemetry(link, header)
                else:
                    with link._reply_cv:
                        link._replies.append((header, payload))
                        link._reply_cv.notify_all()
        except (OSError, ProtocolError) as e:
            if not self._dead and link.sock is sock:
                self._agent_down(link, str(e))

    def _request(self, link: _AgentLink, header: dict, payload: bytes = b"",
                 timeout: float | None = None,
                 expect: tuple = (),
                 lock_timeout: float | None = None) -> tuple[dict, bytes]:
        """One request/reply round-trip (requests serialize per link; the
        reader thread routes non-result frames back here).  ``expect``
        names the acceptable reply types: a stale reply from a previous
        timed-out round (a late heartbeat racing a submit) is discarded,
        never mis-associated.  ``lock_timeout`` bounds how long the caller
        will wait for the per-link request slot — raising `LaneBusy`
        instead of queueing behind a long in-flight dispatch."""
        timeout = timeout or self.request_timeout_s
        if not link.req_lock.acquire(
            timeout=-1 if lock_timeout is None else lock_timeout
        ):
            raise LaneBusy(
                f"agent {link.label()} request slot busy (mid-dispatch)"
            )
        try:
            with link._reply_cv:
                link._replies.clear()  # drop stale replies from a dead round
            with link.send_lock:
                if link.sock is None:
                    raise OSError("agent link down")
                send_frame(link.sock, header, payload)
            deadline = time.monotonic() + timeout
            with link._reply_cv:
                while True:
                    while link._replies:
                        reply = link._replies.pop(0)
                        if not expect or reply[0].get("type") in expect:
                            return reply
                    if not link.alive or link.sock is None:
                        raise OSError(
                            f"agent {link.label()} link dropped while "
                            f"awaiting {header.get('type')} reply"
                        )
                    left = deadline - time.monotonic()
                    if left <= 0 or self._dead:
                        raise TimeoutError(
                            f"agent {link.label()} did not reply to "
                            f"{header.get('type')} within {timeout}s"
                        )
                    link._reply_cv.wait(timeout=min(left, 0.5))
        finally:
            link.req_lock.release()

    def _send(self, link: _AgentLink, header: dict, payload: bytes = b"") -> None:
        with link.send_lock:
            if link.sock is not None:
                try:
                    send_frame(link.sock, header, payload)
                except OSError:
                    pass

    def _agent_down(self, link: _AgentLink, reason: str) -> None:
        """Connection-level agent loss: re-route its in-flight jobs."""
        with self._cv:
            if not link.alive:
                return
            link.alive = False
            try:
                if link.sock is not None:
                    link.sock.close()
            except OSError:
                pass
            link.sock = None
            with link._reply_cv:
                # Wake any request awaiting a reply from this link: the
                # dispatcher must fail fast to the requeue path, not poll
                # out its full timeout while the whole fleet's dispatch
                # stalls behind it.
                link._reply_cv.notify_all()
            lost = sorted(link.inflight) + list(link.pending)
            link.inflight.clear()
            link.pending.clear()
            if link.aid is not None:
                # A down agent keeps its health history (it may return)
                # but leaves the fleet-mean/straggler computation — and
                # its degraded flag: you cannot be the fleet's straggler
                # while not in the fleet.
                self.health.set_active(link.aid, False)
                self._degraded.pop(link.aid, None)
            for jid in lost:
                job = self._jobs.get(jid)
                if job is not None and job.status in ("inflight", "dispatching"):
                    self._requeue_locked(job, frm=link.aid, reason="agent_lost")
            self._persist_locked()
            self._cv.notify_all()
        self._flush_persist()
        log.warning(
            "agent %s down (%s): %d in-flight job(s) re-routed",
            link.label(), reason, len(lost),
        )
        self._publish_gauges()

    def _requeue_locked(self, job: _Job, frm: str | None, reason: str) -> None:
        self._discard_inflight_locked(job.jid)
        job.status = "queued"
        job.agent = None
        job.readmits += 1
        job.queued_mono = time.monotonic()
        self._policy.requeue(job.tenant, max(job.n_keys, 1), job.jid)
        job.ticket.metrics.bump("fleet_jobs_rerouted")
        job.ticket.metrics.event(
            "job_rerouted", job_id=job.jid, tenant=job.tenant, frm=frm,
            reason=reason, readmits=job.readmits,
        )

    def _link_by_aid_locked(self, aid: str | None) -> _AgentLink | None:
        if aid is None:
            return None
        for link in self._links.values():
            if link.aid == aid:
                return link
        return None

    # -- heartbeats ----------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._dead and not self._closed:
            time.sleep(self.heartbeat_s)
            for link in list(self._links.values()):
                if self._dead or self._closed:
                    return
                if not link.alive:
                    try:
                        self._connect(link)  # a restarted agent rejoins here
                    except Exception as e:  # the heartbeat thread must
                        # survive ANY reconnect failure — a dead heartbeat
                        # loop would silently freeze the whole fleet view
                        log.warning("reconnect to %s failed: %s",
                                    link.label(), e)
                    continue
                try:
                    # Bounded wait for the request slot: a lane mid-send to
                    # a stuck agent holds it for up to dispatch_timeout_s,
                    # and the health plane must not serialize behind one
                    # stall (the in-flight dispatch IS a liveness probe —
                    # its own deadline will fail the agent if it is dead).
                    header, _ = self._request(
                        link, {"type": "ping"}, expect=("heartbeat",),
                        lock_timeout=min(self.heartbeat_s, 1.0),
                    )
                except LaneBusy:
                    continue
                except (OSError, TimeoutError, ProtocolError) as e:
                    self._agent_down(link, f"heartbeat: {e}")
                    continue
                if header.get("type") != "heartbeat":
                    continue
                with self._cv:
                    was_draining = link.draining
                    link.draining = bool(header.get("draining"))
                    link.capacity = int(header.get("capacity", link.capacity))
                    link.variants = set(header.get("variants", link.variants))
                    self._cv.notify_all()
                self._svc_metrics.bump("fleet_heartbeats")
                self._svc_metrics.event(
                    "agent_heartbeat", agent=link.label(),
                    queued=header.get("queued"),
                    in_flight=header.get("in_flight"),
                    draining=link.draining, variants=len(link.variants),
                )
                if link.draining and not was_draining:
                    log.warning(
                        "agent %s reports draining: routing around it",
                        link.label(),
                    )
            self._publish_gauges()

    # -- admission -----------------------------------------------------------

    def _eligible_locked(self) -> list[_AgentLink]:
        """Agents that COULD take work (admission's no_capacity signal)."""
        return [
            l for l in self._links.values() if l.alive and not l.draining
        ]

    def _dispatchable_locked(self) -> list[_AgentLink]:
        """Agents with a free outstanding slot right now.  Outstanding
        dispatches are bounded by the agent's advertised capacity (its
        slice count) — backpressure is the controller's own queue, never a
        reject-retry loop against a busy agent.  Lane-pending and
        actively-sending jobs count against the slot: the dispatcher must
        not pile a slow agent's lane high with work other agents could
        take."""
        return [
            l for l in self._eligible_locked()
            if (len(l.inflight) + len(l.pending) + l.dispatching)
            < max(l.capacity, 1)
        ]

    def submit(
        self,
        data: np.ndarray,
        tenant: str | None = None,
        job_id: str | None = None,
        ckpt_job_id: str | None = None,
    ) -> tuple[Admission, FleetTicket | None]:
        """Admit one keys-only sort job; ``(verdict, ticket)`` — the
        cross-process twin of `SortService.submit` (non-blocking;
        backpressure is the verdict).  ``ckpt_job_id`` is accepted for
        CLI-surface parity but agents own their checkpoint namespaces."""
        data = np.asarray(data)
        tenant = tenant or self.default_tenant
        with self._cv:
            no_cap = not self._eligible_locked()
            verdict = self._policy.consider(
                tenant, self._shutdown, no_capacity=no_cap
            )
        if self.telemetry is not None:
            self.telemetry.admission_verdict(tenant, verdict.reason)
        if not verdict.admitted:
            self._svc_metrics.bump("jobs_rejected")
            # A rejection is a job of its own (its own ordinal), as in
            # `serve.SortService`: the job_lifecycle contract sees one
            # trace per rejection.
            self._svc_metrics.event(
                "job_rejected", job=new_job_ordinal(), tenant=tenant, reason=verdict.reason,
                queue_depth=verdict.queue_depth, n_keys=len(data),
            )
            log.warning(
                "fleet job rejected for tenant %s: %s (queue_depth=%d)",
                tenant, verdict.reason, verdict.queue_depth,
            )
            return verdict, None
        metrics = Metrics(journal=self.journal)
        if self.telemetry is not None:
            self.telemetry.attach(metrics)
        self.planner.attach(metrics)
        with self._cv:
            self._seq += 1
            # Scoped by controller identity: a NEW incarnation running
            # without state_dir must never mint a jid a previous
            # incarnation's agents still hold a result for (the agent's
            # duplicate-dispatch path would hand the old job's output to
            # the new job).
            jid = f"{self.controller_id}-{self._seq:06d}"
        ticket = FleetTicket(jid, tenant, len(data), metrics)
        job = _Job(jid, tenant, len(data), str(data.dtype), job_id, ticket)
        job.data = data
        spool = self._spool_path(jid)
        if spool is not None:
            try:
                os.makedirs(os.path.dirname(spool), exist_ok=True)
                # Atomic like the state file: a crash mid-write must leave
                # no torn .npy for the restarted dispatcher to choke on.
                tmp = spool + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, spool)
                # The spool is now the durable copy: a backlog of queued
                # jobs must not ALSO pin every payload in controller
                # memory (`_job_payload` reads the spool back at dispatch).
                job.data = None
            except OSError as e:
                # A full/unwritable state disk must fail THIS job as a
                # ticket error — never leak the admission slot the verdict
                # already counted, never throw into the REPL caller.
                with self._cv:
                    self._policy.admission.dequeued()
                    self._policy.finished(tenant)
                    self._failed_jobs += 1
                err = ControllerClosed(f"payload spool write failed: {e}")
                metrics.event(
                    "job_failed",
                    reason=(str(err).splitlines() or [repr(err)])[0][:120],
                )
                ticket._error = err
                ticket._done.set()
                log.error("fleet job %s not queued: %s", jid, err)
                return verdict, ticket
        metrics.bump("jobs_admitted")
        metrics.event(
            "job_admitted", tenant=tenant, queue_depth=verdict.queue_depth,
            n_keys=len(data), job_id=jid,
        )
        metrics.event(
            "job_start", mode="fleet", n_keys=len(data), job_id=job_id,
            tenant=tenant,
        )
        with self._cv:
            self._jobs[jid] = job
            self._policy.push(tenant, max(len(data), 1), jid)
            self._persist_locked()
            self._cv.notify_all()
        self._flush_persist()
        self._publish_gauges()
        return verdict, ticket

    # -- routing + dispatch --------------------------------------------------

    def _route_locked(self, job: _Job) -> tuple[_AgentLink, str]:
        live = self._dispatchable_locked()
        assert live, "dispatch loop gates on a dispatchable agent"

        def loaded(l):
            # Lane-pending and actively-sending jobs ARE load: during a
            # burst the dispatcher routes many jobs before the first
            # accept returns, and counting only accepted inflight would
            # scatter rungs across idle-LOOKING agents.
            busy = len(l.inflight) + len(l.pending) + l.dispatching
            return (busy / max(l.capacity, 1), l.label())

        if job.n_keys >= FLEET_SMALL_JOB_MAX:
            cands = [l for l in live if l.big_jobs] or live
            if self.routing == "health":
                # Health-aware big-job placement: send the full-mesh work
                # to the mesh whose measured straggler profile is cleanest
                # — degraded agents last, then by straggler score, then by
                # load.  Small jobs
                # below keep their locality stickiness untouched.
                scores = self.health.scores()
                if scores:
                    def penalty(l):
                        deg, sc = scores.get(l.aid, (False, 0.0))
                        return (bool(deg), sc) + loaded(l)

                    return min(cands, key=penalty), "health"
            return min(cands, key=loaded), "size"
        if self.routing == "random":
            return self._rng.choice(live), "random"
        prefix = fused_rung_prefix(job.n_keys, job.dtype)

        def sticky_ok(l):
            if l in live:
                return True
            # A busy home agent is worth a SHORT wait only when the rung
            # has ALREADY RUN there (it advertises the variant):
            # under a burst the dispatcher routes the whole queue before
            # any result returns, and without this bounded lane backlog
            # (one extra capacity's worth) every same-rung job would
            # spill and pay the rung's first call on another mesh.  A
            # rung that never ran is not worth waiting for — spilling
            # runs it first somewhere idle instead.
            return (
                l.alive and not l.draining
                and any(v.startswith(prefix) for v in l.variants)
                and (len(l.inflight) + len(l.pending) + l.dispatching)
                < 2 * max(l.capacity, 1)
            )

        # Sticky affinity first: the rung's home agent (set at its first
        # dispatch) keeps it deterministic even before a heartbeat refresh
        # advertises the fresh variant.
        aff = self._link_by_aid_locked(self._affinity.get(prefix))
        if aff is not None and sticky_ok(aff):
            return aff, "locality"
        hit = [
            l for l in self._eligible_locked()
            if sticky_ok(l) and any(v.startswith(prefix) for v in l.variants)
        ]
        if hit:
            link = min(hit, key=loaded)
            self._affinity[prefix] = link.aid
            return link, "locality"
        if aff is not None and aff.alive and not aff.draining:
            # The rung's home is merely busy: spill this job elsewhere but
            # keep the rung homed there for the next one.
            return min(live, key=loaded), "spill"
        link = min(live, key=loaded)
        self._affinity[prefix] = link.aid
        return link, "spill"

    def _job_payload(self, job: _Job) -> np.ndarray:
        if job.data is not None:
            return job.data
        spool = self._spool_path(job.jid)
        if spool is None or not os.path.exists(spool):
            raise ControllerClosed(
                f"job {job.jid} has no payload (spool missing)"
            )
        try:
            return np.load(spool)
        except (OSError, ValueError) as e:
            raise ControllerClosed(
                f"job {job.jid} spool unreadable: {e}"
            ) from e

    def _dispatch_loop(self) -> None:
        """Pop jobs in DRR order and ROUTE them — onto per-agent lanes.

        The dispatcher never touches a socket: the submit round-trip runs
        on the routed agent's own lane thread, so one stuck-but-connected
        agent blocks its lane for at most ``dispatch_timeout_s`` while
        every other agent keeps receiving work (drilled in
        ``tests/test_torch_fleet.py``)."""
        while not self._dead:
            with self._cv:
                nxt = None
                while nxt is None:
                    if self._dead:
                        return
                    if self._dispatchable_locked():
                        nxt = self._policy.pop()
                        if nxt is not None:
                            break
                    if (
                        self._shutdown
                        and self._policy.queue_depth == 0
                        and not any(
                            j.status in ("inflight", "dispatching")
                            for j in self._jobs.values()
                        )
                    ):
                        return
                    self._cv.wait(timeout=0.05)
                tenant, jid = nxt
                job = self._jobs.get(jid)
                if job is None or job.status != "queued":
                    continue  # completed/cancelled while queued (stale token)
                link, reason = self._route_locked(job)
                wait_s = time.monotonic() - job.queued_mono
                self._policy.note_wait(tenant, wait_s)
                job.status = "dispatching"
                job.agent = link.aid
                link.pending.append(jid)
                self._persist_locked()
                self._cv.notify_all()
            # Journal the routing DECISION here, in the dispatcher: pops
            # happen in DRR order on this one thread, so the job_routed
            # sequence in the trace IS the fairness order (the restart
            # drill replays the persisted policy against it) — per-agent
            # lanes would race accept-time emission across agents.  A
            # fast result can't swallow it either: it is written before
            # the submit leaves the process.  A failed dispatch follows
            # with job_rerouted, keeping the trace honest.
            job.ticket.metrics.event(
                "job_dequeued", tenant=tenant, wait_s=round(wait_s, 6),
                big=job.n_keys >= FLEET_SMALL_JOB_MAX, agent=link.label(),
            )
            job.ticket.metrics.bump("fleet_jobs_routed")
            job.ticket.metrics.event(
                "job_routed", job_id=jid, tenant=tenant, agent=link.label(),
                reason=reason, n_keys=job.n_keys,
            )
            self._flush_persist()

    def _lane_loop(self, link: _AgentLink) -> None:
        """One agent's dispatch lane: pull jobs the dispatcher routed
        here, run the submit round-trip, transition the state."""
        while True:
            with self._cv:
                while not link.pending and not self._dead and not self._closed:
                    self._cv.wait(timeout=0.1)
                if self._dead or self._closed:
                    return
                jid = link.pending.pop(0)
                job = self._jobs.get(jid)
                if job is None or job.status != "dispatching":
                    continue  # requeued/finished while lane-pending
                link.dispatching += 1
            try:
                self._dispatch_one(link, job)
            finally:
                with self._cv:
                    link.dispatching -= 1
                    self._cv.notify_all()

    def _plan_redundancy(self, job: _Job) -> int | None:
        """The per-dispatch redundancy decision (obs.plan's policy 3).

        Returns the ``r`` to stamp into the submit header, or None (no
        stamp: the agent's own ``JobConfig.redundancy`` applies).  An
        explicit controller-level value always wins — with autotune on the
        yield is journaled as a ``plan_override``.
        """
        if not self.autotune:
            return self.redundancy
        inputs = self.planner.redundancy_inputs(
            current=self.redundancy or 1, scores=self.health.scores(),
        )
        if self.redundancy is not None:
            return int(self.planner.note_override(
                "redundancy", self.redundancy, inputs, job.ticket.metrics,
            ))
        return int(self.planner.decide(
            "redundancy", inputs, job.ticket.metrics,
        ))

    def _plan_redundancy_mode(self, job: _Job, planned_r) -> str | None:
        """The mode axis of the per-dispatch redundancy decision.

        Returns the mode to stamp into the submit header, or None (no
        stamp: the agent's own ``JobConfig.redundancy_mode`` applies).
        Only consulted when the dispatch actually ships a replica plane
        (``planned_r`` > 1) — journaling a mode decision for an uncoded
        dispatch would be noise the replay verdict still had to satisfy.
        """
        if not self.autotune:
            return self.redundancy_mode
        if planned_r is None or int(planned_r) <= 1:
            return self.redundancy_mode
        inputs = self.planner.redundancy_mode_inputs(
            scores=self.health.scores(),
        )
        if self.redundancy_mode is not None:
            return str(self.planner.note_override(
                "redundancy_mode", self.redundancy_mode, inputs,
                job.ticket.metrics,
            ))
        return str(self.planner.decide(
            "redundancy_mode", inputs, job.ticket.metrics,
        ))

    def _plan_dispatch_timeout(self, job: _Job) -> float:
        """The per-dispatch SEND deadline (obs.plan's dispatch_timeout_s
        policy): p99 of the accept latencies this controller has observed,
        times headroom — so a stuck agent costs its lane seconds, not the
        full hand-set request budget.  An explicit constructor/conf value
        always wins; with autotune on the yield journals a plan_override.
        """
        if not self.autotune:
            return self.dispatch_timeout_s
        inputs = self.planner.dispatch_timeout_inputs(self.dispatch_timeout_s)
        if self._dispatch_timeout_explicit:
            return float(self.planner.note_override(
                "dispatch_timeout_s", self.dispatch_timeout_s, inputs,
                job.ticket.metrics,
            ))
        return float(self.planner.decide(
            "dispatch_timeout_s", inputs, job.ticket.metrics,
        ))

    def _dispatch_one(self, link: _AgentLink, job: _Job) -> None:
        jid, tenant = job.jid, job.tenant
        # The routing is on disk before the submit leaves the process, so a
        # restarted controller knows every job an agent may hold (the
        # dispatcher's own flush may still be under way); a killed
        # controller sends nothing.
        if not self._flush_persist():
            return
        try:
            payload_arr = self._job_payload(job)
            meta, payload = encode_array(payload_arr)
            planned_r = self._plan_redundancy(job)
            red = {} if planned_r is None else {"redundancy": int(planned_r)}
            planned_mode = self._plan_redundancy_mode(job, planned_r)
            if planned_mode is not None:
                red["redundancy_mode"] = str(planned_mode)
            t_send = time.monotonic()
            header, _ = self._request(
                link,
                {"type": "submit", "job_id": jid, "tenant": tenant,
                 "label": job.label, **red, **meta},
                payload,
                timeout=self._plan_dispatch_timeout(job),
                expect=("accepted", "rejected"),
            )
        except (OSError, TimeoutError, ProtocolError) as e:
            self._agent_down(link, f"dispatch: {e}")
            with self._cv:
                if job.status == "dispatching":
                    # _agent_down only re-queues inflight/pending jobs; the
                    # one mid-send is this lane's to put back through the
                    # full re-route path (journaled job_rerouted, readmits
                    # bump, fresh queue-wait clock).
                    self._requeue_locked(job, frm=link.aid,
                                         reason="dispatch_failed")
                    self._persist_locked()
                    self._cv.notify_all()
            self._flush_persist()
            return
        except Exception as e:
            # ANY payload/encode failure (a torn spool after a crash
            # mid-write raises ValueError from np.load) must fail THAT
            # job, never kill the daemon lane and freeze its agent.
            self._finish_error(job, e)
            return
        if header.get("type") == "rejected":
            # The agent's local admission refused (draining/bounded):
            # re-queue and let routing try elsewhere next round.  The
            # every-agent-rejects bound is decided BEFORE re-queueing —
            # failing a job AFTER its token went back in the DRR would
            # leave a phantom entry inflating the queue depth.
            exhausted = job.readmits >= 3 * max(len(self._links), 1)
            with self._cv:
                link.draining = link.draining or (
                    header.get("reason") == "shutting_down"
                )
                if not exhausted and job.status == "dispatching":
                    self._requeue_locked(job, frm=link.aid,
                                         reason=str(header.get("reason")))
                    self._persist_locked()
                self._cv.notify_all()
            self._flush_persist()
            if exhausted:
                self._finish_error(job, ControllerClosed(
                    f"job {jid} rejected by every agent "
                    f"({header.get('reason')})"
                ))
            time.sleep(0.05)
            return
        # The agent accepted: transition to inflight (the routing trace
        # was already journaled by the dispatcher, in DRR order).  The
        # accept round-trip is journaled per dispatch — the measured
        # input the dispatch_timeout_s policy sizes its deadline from
        # (the planner taps this metrics object, so the fold is live).
        job.ticket.metrics.event(
            "job_dispatched", job_id=jid, agent=link.label(),
            accept_latency_s=round(time.monotonic() - t_send, 6),
        )
        with self._cv:
            if job.status != "dispatching":
                # The result beat us here: the job is already finished
                # — never resurrect it as inflight or re-occupy the
                # slot its completion just freed.
                return
            if not link.alive:
                # The agent died between the accepted reply and here
                # (its _agent_down saw the job still mid-dispatch and
                # re-queued nothing): treat as agent loss ourselves —
                # at-least-once, never a stranded inflight on a dead
                # link that no later path would revisit.
                self._requeue_locked(job, frm=link.aid,
                                     reason="agent_lost")
            else:
                job.status = "inflight"
                job.agent = link.aid
                link.inflight.add(jid)
            self._persist_locked()
            self._cv.notify_all()
        self._flush_persist()
        self._publish_gauges()

    # -- health plane ---------------------------------------------------------

    def _on_telemetry(self, link: _AgentLink, header: dict) -> None:
        """Fold one agent's streamed delta and journal its refreshed
        verdict; a degraded FLIP additionally journals ``agent_degraded``
        (dumping a flight bundle when ``flight_dir`` is set)."""
        aid = str(header.get("agent_id") or link.aid or link.label())
        self.health.ingest(aid, header.get("delta") or {})
        self._svc_metrics.bump("fleet_telemetry_frames")
        # ONE fleet-wide recompute per frame: the gauge publish below
        # reuses this dict instead of re-scoring every agent.
        verdicts = self.health.verdicts()
        verdict = verdicts.get(aid)
        if verdict is None:
            return
        now = bool(verdict["degraded"])
        with self._cv:
            was = self._degraded.get(aid, False)
            self._degraded[aid] = now
            self._cv.notify_all()  # health routing reads the verdicts
        self._svc_metrics.bump("health_verdicts")
        # The typed rolling verdict: one event per ingested delta, so the
        # journal's LAST health_verdict per agent IS the live final state
        # (the live==replay drill keys on exactly this).
        self._svc_metrics.event(
            "health_verdict",
            **{k: verdict[k] for k in (
                "agent", "busy_s", "score", "straggler", "dominant_phase",
                "splits", "slo_risk", "degraded", "seq",
            )},
        )
        if now and not was:
            # Emitted OUTSIDE _cv: the flight recorder's dump reads the
            # fleet state (`agent_info`) which takes the lock itself.
            self._svc_metrics.bump("agent_degradations")
            self._svc_metrics.event(
                "agent_degraded", agent=aid, score=verdict["score"],
                dominant_phase=verdict["dominant_phase"],
            )
            log.warning(
                "agent %s flipped DEGRADED (%.2fx fleet-mean busy, "
                "dominant phase %s): health routing penalizes it for big "
                "jobs", aid, verdict["score"], verdict["dominant_phase"],
            )
        elif was and not now:
            log.warning("agent %s recovered (no longer degraded)", aid)
        self._publish_gauges(verdicts)

    def health_verdicts(self) -> dict[str, dict]:
        """The rolling per-agent why-slow verdicts (`obs.health`)."""
        return self.health.verdicts()

    # -- completion ----------------------------------------------------------

    def _on_result(self, link: _AgentLink, header: dict, payload: bytes) -> None:
        jid = str(header.get("job_id"))
        with self._cv:
            job = self._jobs.get(jid)
            link.variants = set(header.get("variants", link.variants))
            if job is None or job.status in ("done", "failed"):
                # A late duplicate (at-least-once reroute: the job already
                # finished elsewhere) still frees this agent's slot — a
                # stale inflight entry would eat its bounded capacity
                # forever.
                self._discard_inflight_locked(jid)
                self._cv.notify_all()
                late = True
            else:
                late = False
        if late:
            self._send(link, {"type": "result_ack", "job_id": jid})
            return
        if header.get("ok"):
            try:
                out = decode_array(header, payload)
            except ProtocolError as e:
                durable = self._finish_error(job, ControllerClosed(f"bad result: {e}"))
            else:
                durable = self._finish_ok(job, out, link)
        else:
            durable = self._finish_error(
                job,
                ControllerClosed(str(header.get("reason", "agent failure"))),
                link,
            )
        # The ack only once our state persisted: a crash in between (or a
        # kill that stopped the write) leaves the agent holding the result
        # for the next attach, never loses it.
        if durable:
            self._send(link, {"type": "result_ack", "job_id": jid})

    def _discard_inflight_locked(self, jid: str) -> None:
        """Free ``jid``'s outstanding slot on EVERY link (caller holds
        ``_cv``): after a reroute a job may be recorded on a different
        link than the one delivering its result — including a lane's
        pending list it never left."""
        for l in self._links.values():
            l.inflight.discard(jid)
            if jid in l.pending:
                l.pending.remove(jid)

    def _drop_spool(self, jid: str) -> None:
        spool = self._spool_path(jid)
        if spool is not None:
            try:
                os.remove(spool)
            except OSError:
                pass

    def _finish_ok(self, job: _Job, out: np.ndarray, link: _AgentLink) -> bool:
        """Complete ``job``; whether its completion is on disk."""
        with self._cv:
            if job.status in ("done", "failed"):
                return True  # a duplicate delivery already finished this job
            job.status = "done"
            self._discard_inflight_locked(job.jid)
            self._policy.finished(job.tenant)
            self._done_jobs += 1
            self._jobs.pop(job.jid, None)
            self._persist_locked()
            self._cv.notify_all()
        job.ticket.metrics.event("result_fetch", n_keys=len(out))
        job.ticket.metrics.event(
            "job_done", n_keys=len(out),
            counters=dict(job.ticket.metrics.counters),
        )
        # The completion must be durable BEFORE the caller acks the agent
        # (which then drops its held copy of the result).
        durable = self._flush_persist()
        job.data = None
        if durable:  # a killed controller deletes nothing either
            self._drop_spool(job.jid)
        job.ticket._result = out
        job.ticket._done.set()
        self._publish_gauges()
        self._flush_journal()
        return durable

    def _finish_error(self, job: _Job, e: BaseException,
                      link: _AgentLink | None = None) -> bool:
        """Fail ``job``; whether its failure is on disk."""
        with self._cv:
            if job.status in ("done", "failed"):
                return True  # a duplicate delivery already finished this job
            job.status = "failed"
            self._discard_inflight_locked(job.jid)
            self._policy.finished(job.tenant)
            self._failed_jobs += 1
            self._jobs.pop(job.jid, None)
            self._persist_locked()
            self._cv.notify_all()
        job.ticket.metrics.event(
            "job_failed",
            reason=(str(e).splitlines() or [repr(e)])[0][:120],
            counters=dict(job.ticket.metrics.counters),
        )
        durable = self._flush_persist()
        if durable:
            self._drop_spool(job.jid)
        job.ticket._error = e
        job.ticket._done.set()
        log.error("fleet job %s (tenant %s) failed: %s", job.jid, job.tenant, e)
        self._publish_gauges()
        self._flush_journal()
        return durable

    # -- telemetry / introspection -------------------------------------------

    def _publish_gauges(self, verdicts: dict | None = None) -> None:
        if self.telemetry is None:
            return
        with self._cv:
            depth = self._policy.queue_depth
            agents = sum(1 for l in self._links.values() if l.alive)
            draining = sum(
                1 for l in self._links.values() if l.alive and l.draining
            )
        self.telemetry.set_gauge("queue_depth", depth)
        self.telemetry.set_gauge("fleet_agents", agents)
        self.telemetry.set_gauge("fleet_agents_draining", draining)
        if verdicts is None:
            verdicts = self.health.verdicts()
        if verdicts:
            self.telemetry.set_gauge(
                "fleet_agents_degraded",
                sum(1 for v in verdicts.values() if v["degraded"]),
            )
            for aid, v in verdicts.items():
                labels = {"agent": aid}
                self.telemetry.set_series(
                    "agent_health_score", labels, v["score"]
                )
                self.telemetry.set_series(
                    "agent_health_degraded", labels,
                    1.0 if v["degraded"] else 0.0,
                )
                self.telemetry.set_series(
                    "agent_health_busy_ms", labels, v["busy_s"] * 1e3
                )
                # Info-style series: the dominant phase / straggler bit
                # ride as labels (keyed by agent, so a refreshed verdict
                # REPLACES the stale series instead of accumulating).
                self.telemetry.set_series(
                    "agent_health_info",
                    {
                        "agent": aid,
                        "dominant_phase": str(v["dominant_phase"] or "-"),
                        "straggler": "1" if v["straggler"] else "0",
                    },
                    1.0,
                    key=labels,
                )

    def stats(self) -> dict:
        with self._cv:
            return {
                "queued": self._policy.queue_depth,
                # in_flight keeps its meaning: ACCEPTED and running
                # on an agent; lane-held jobs surface separately.
                "in_flight": sum(
                    1 for j in self._jobs.values() if j.status == "inflight"
                ),
                "dispatching": sum(
                    1 for j in self._jobs.values()
                    if j.status == "dispatching"
                ),
                "done": self._done_jobs,
                "failed": self._failed_jobs,
                "agents": sum(1 for l in self._links.values() if l.alive),
                "agents_draining": sum(
                    1 for l in self._links.values() if l.alive and l.draining
                ),
                "agents_degraded": sum(
                    1 for d in self._degraded.values() if d
                ),
            }

    def agent_info(self) -> list[dict]:
        with self._cv:
            return [
                {
                    "agent": l.label(), "alive": l.alive,
                    "draining": l.draining, "big_jobs": l.big_jobs,
                    "capacity": l.capacity, "in_flight": len(l.inflight),
                    "variants": sorted(l.variants),
                }
                for l in self._links.values()
            ]

    def _flush_journal(self) -> None:
        if self.journal is not None and self.journal_path:
            with self._flush_lock:
                try:
                    self.journal.flush_jsonl(self.journal_path)
                except OSError:
                    pass

    # -- shutdown ------------------------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> bool:
        """Stop admission and wind down.  ``drain=True`` completes every
        queued and in-flight job first (jobs keep running on their
        agents); ``drain=False`` fails queued jobs with `ControllerClosed`
        but still waits for the in-flight ones."""
        dropped = []
        with self._cv:
            if self._closed:
                return True
            first = not self._shutdown
            self._shutdown = True
            queued = self._policy.queued
            in_flight = sum(
                1 for j in self._jobs.values() if j.status == "inflight"
            )
            if not drain:
                while True:
                    nxt = self._policy.pop()
                    if nxt is None:
                        break
                    dropped.append(nxt[1])
            self._cv.notify_all()
        if first:
            self._svc_metrics.event(
                "serve_drain", reason="shutdown", drain=bool(drain),
                queued=queued, in_flight=in_flight,
            )
        for jid in dropped:
            job = self._jobs.get(jid)
            if job is not None:
                self._finish_error(
                    job, ControllerClosed("controller shutting down")
                )
        if drain and not self._started:
            self.start()
        if self._started and self._dispatcher.is_alive():
            self._dispatcher.join(timeout=timeout)
            if self._dispatcher.is_alive():
                return False
        with self._cv:
            self._closed = True
            done, failed = self._done_jobs, self._failed_jobs
            self._persist_locked()
        self._flush_persist()
        # Quiet the reader threads BEFORE the sockets drop: a clean `bye`
        # must not read as an agent loss.
        self._dead = True
        for link in self._links.values():
            self._send(link, {"type": "bye"})
            try:
                if link.sock is not None:
                    link.sock.close()
            except OSError:
                pass
        self._svc_metrics.event(
            "serve_stop", jobs_done=done, jobs_failed=failed,
            counters=dict(self._svc_metrics.counters),
        )
        self._publish_gauges()
        self._flush_journal()
        return True

    def kill(self) -> None:
        """Abrupt controller death for the restart drill: threads stop,
        sockets drop, NOTHING is drained or marked cleanly shut down — the
        persisted state is whatever the last transition wrote.  In-flight
        jobs keep running on their agents; a new `FleetController` over
        the same ``state_dir`` re-attaches to them.  As a process's death
        would, it ends every agent stream at once (``shutdown``, not a bare
        ``close``, which leaves a reader thread holding the stream open),
        and no thread of it writes the state after this returns."""
        self._killed = True
        self._dead = True
        with self._cv:
            self._cv.notify_all()
        with self._persist_lock:
            pass  # a write under way lands before the return; none starts after
        for link in self._links.values():
            if link.sock is not None:
                try:
                    link.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    link.sock.close()
                except OSError:
                    pass
            link.sock = None
            link.alive = False
