"""Fleet execution agent: one `SortService` on the card behind a TCP port.

Counterpart of ``dsort_tpu/fleet/agent.py``.  `FleetAgent` is the
execution half of the fleet: it wraps a `serve.SortService` (slices on
CUDA streams, the variant cache, eviction and re-admission, graceful
drain) behind a framed-JSON TCP endpoint (`fleet.proto`), so a torch-free
controller process can route jobs onto it.  The agent is the only side
that imports torch.  Its service owns ``num_workers`` virtual workers on
``device`` (the card unless ``device="cpu"`` is asked), or runs a
``runner`` (one opaque slot); two agents in one process share the card,
each with its own workers and streams, and the process-wide first-call
ledger (`obs.prof.LEDGER`), which both advertise.

Contract with the controller:

- **Jobs survive the controller.**  A submitted job runs to completion on
  the agent whatever happens to the controller connection; finished
  results are held in memory and resent on every controller (re)attach
  until a ``result_ack`` confirms durable receipt.
- **Re-attach by journaled job id.**  A controller's ``hello`` carries the
  fleet job ids it believes live here; the ``welcome`` reply reports each
  as ``running`` / ``done`` / ``failed`` / ``unknown``, so a restarted
  controller re-binds in-flight work instead of re-dispatching it.
- **Locality advertising.**  ``welcome`` / ``heartbeat`` / ``result``
  frames carry the agent's variant-cache keys and first-call ledger labels
  (flat labels), the signal the controller's locality routing keys on.
- **Draining.**  `drain()` (or a ``drain`` frame, or SIGTERM in ``cli
  fleet-agent``) finishes queued and in-flight work but refuses new fleet
  submits with the typed ``shutting_down`` verdict; heartbeats advertise
  the state so the controller routes around this agent.
"""

from __future__ import annotations

import socket
import threading
import uuid
from collections import OrderedDict

#: Bound on finished results held for an absent/unacking controller.  A
#: result evicted here is NOT lost work: a re-attaching controller that
#: still cares sees status "unknown" and re-dispatches (at-least-once) —
#: whereas an unbounded store would let orphaned controllers (restarted
#: without their state_dir) pin sorted outputs until the agent OOMs.
DONE_STORE_MAX = 256

from dsort_tpu_torch.fleet.proto import (
    MAX_ADVERTISED_VARIANTS,
    MAX_FRAME_BYTES,
    ProtocolError,
    bounded_frame,
    clock_pair,
    decode_array,
    encode_array,
    recv_frame,
    send_frame,
    variant_label_of_key,
)
from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.agent")


class _Detached(Exception):
    """Clean controller detach (a ``bye`` frame) — not a fault."""


def _drop(sock) -> None:
    """Shut a socket down, then close it.  A bare ``close()`` does not
    wake a thread of this process blocked on the socket, and the peer
    sees no end of stream until that thread lets go; ``shutdown`` ends
    the stream at once, as the death of the process would."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FleetAgent:
    """Serve one mesh-owning `SortService` to a fleet controller."""

    def __init__(
        self,
        service=None,
        *,
        runner=None,
        num_workers: int = 8,
        device=None,
        job=None,
        serve=None,
        telemetry=None,
        host: str = "127.0.0.1",
        port: int = 0,
        agent_id: str | None = None,
        journal=None,
        journal_path: str | None = None,
        big_jobs: bool | None = None,
        start: bool = True,
    ):
        if service is None:
            from dsort_tpu_torch.serve import SortService

            service = SortService(
                num_workers, device, job=job, serve=serve, runner=runner,
                telemetry=telemetry, journal=journal,
                journal_path=journal_path,
            )
        self.service = service
        self.journal = journal if journal is not None else service.journal
        self.journal_path = journal_path or service.journal_path
        self.agent_id = agent_id or f"agent-{uuid.uuid4().hex[:8]}"
        if big_jobs is None:
            # A runner-mode service (one opaque slot) takes whatever its
            # runner takes; a mesh service takes big jobs on its whole
            # mesh (`SpmdScheduler.sort`).
            big_jobs = service._sched is not None or service._runner is not None
        self.big_jobs = bool(big_jobs)
        self._lock = threading.Lock()
        self._jobs: dict[str, object] = {}       # fleet jid -> JobTicket
        # jid -> (ok, result|reason), oldest first, DONE_STORE_MAX-bounded
        self._done: OrderedDict[str, tuple] = OrderedDict()
        self._draining = False
        self._closed = False
        self._conn = None
        self._conn_gen = 0
        self._send_lock = threading.Lock()
        # Health plane: the delta collector is built lazily when a
        # controller's hello opts in (telemetry=True) — a heartbeats-only
        # controller pays nothing.  The CURRENT controller's preference
        # gates the stream: a heartbeats-only controller attaching after
        # an opted-in one must not keep receiving frames.
        self._collector = None
        self._telemetry_on = False
        if self.journal is not None:
            # The merge handshake: one blessed (wall, mono) pair per agent
            # so `cli report --merge` aligns this journal's
            # monotonic base with the controller's.
            self.journal.emit("clock_sync", source=self.agent_id)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(4)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"dsort-fleet-agent-{self.port}",
        )
        if start:
            self._accept_thread.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- state the controller reads -----------------------------------------

    def variant_labels(self) -> list[str]:
        """Flat labels of every cached variant + first-call ledger entry — the
        locality-routing advertisement.  RECENCY order (oldest first) and
        bounded to `MAX_ADVERTISED_VARIANTS` with eviction-oldest-first: a
        long-running agent's heartbeat must not inflate with its first-call
        history, and the freshest rungs are the ones locality wants."""
        cached = [
            variant_label_of_key(k) for k in self.service.variants.keys()
        ]  # VariantCache.keys() is LRU order, oldest first
        seen = set(cached)
        from dsort_tpu_torch.obs.prof import LEDGER

        # Ledger-only labels are historical first calls no longer (or never)
        # in the cache — OLDER than anything the LRU still holds, so they
        # rank first and evict first.
        labels = [
            label for label in LEDGER.snapshot()  # first-call order
            if label not in seen
        ] + cached
        return labels[-MAX_ADVERTISED_VARIANTS:]

    def _info(self) -> dict:
        st = self.service.stats()
        return {
            "agent_id": self.agent_id,
            "capacity": max(st["slices"], 1),
            "big_jobs": self.big_jobs,
            "draining": self._draining,
            "queued": st["queued"],
            "in_flight": st["in_flight"],
            "variants": self.variant_labels(),
            # Protocol-level clock sync: the controller journals this pair
            # as a peer `clock_sync` blessing so `cli report --merge`
            # aligns the two journals on MONOTONIC clocks.
            **clock_pair(),
        }

    def job_status(self, jid: str) -> str:
        with self._lock:
            if jid in self._done:
                return "done" if self._done[jid][0] else "failed"
            if jid in self._jobs:
                return "running"
        return "unknown"

    def drain(self) -> None:
        """Finish queued + in-flight fleet jobs; refuse new submits."""
        self._draining = True
        log.warning("agent %s draining: no new fleet jobs accepted",
                    self.agent_id)

    # -- connection handling -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._send_lock:
                old, self._conn = self._conn, conn
                self._conn_gen += 1
                gen = self._conn_gen
            if old is not None:
                _drop(old)  # a new controller supersedes the old link
            threading.Thread(
                target=self._conn_loop, args=(conn, gen), daemon=True,
                name=f"dsort-fleet-conn-{self.port}",
            ).start()

    def _conn_loop(self, conn, gen: int) -> None:
        try:
            while not self._closed:
                frame = recv_frame(conn)
                if frame is None:
                    return
                header, payload = frame
                self._handle(conn, header, payload)
        except _Detached:
            log.info("agent %s: controller detached cleanly", self.agent_id)
        except (ProtocolError, OSError) as e:
            if not self._closed:
                log.warning("agent %s controller link dropped: %s",
                            self.agent_id, e)
        finally:
            with self._send_lock:
                if self._conn_gen == gen:
                    self._conn = None
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, header: dict, payload: bytes = b"") -> bool:
        with self._send_lock:
            conn = self._conn
            if conn is None:
                return False
            try:
                send_frame(conn, header, payload)
                return True
            except (OSError, ProtocolError):
                # A send failure (dead link OR an unsendable frame) must
                # never escape into a waiter thread — the result stays in
                # the store for the next attach.
                return False

    def _enable_telemetry(self) -> None:
        """Build + wire the health delta collector (idempotent): it taps
        the service metrics AND every admitted job's metrics
        (`SortService.job_taps`), so the streamed deltas see exactly the
        events the agent's journal sees."""
        if self._collector is not None:
            return
        from dsort_tpu_torch.obs.health import HealthDeltaCollector

        collector = HealthDeltaCollector()
        collector.attach(self.service._svc_metrics)
        self.service.job_taps.append(collector)
        self._collector = collector

    def _send_telemetry(self) -> None:
        """Drain + ship one bounded ``telemetry`` frame (no-op until a
        controller opted in via hello).  A failed send folds the delta
        BACK into the collector — the exact running sums must survive a
        detached controller like held results do, or work completed while
        disconnected would vanish from the agent's health history."""
        if self._collector is None or not self._telemetry_on:
            return
        delta = self._collector.drain()
        sent = self._send(bounded_frame({
            "type": "telemetry", "agent_id": self.agent_id,
            **clock_pair(), "delta": delta,
        }))
        if not sent:
            self._collector.restore(delta)

    def _handle(self, conn, header: dict, payload: bytes) -> None:
        ftype = header["type"]
        if ftype == "hello":
            # The opt-in follows the CURRENT controller: telemetry=False
            # stops the stream even if a previous controller enabled it
            # (the collector keeps accumulating — cheap — so a later
            # opted-in controller sees the full history).
            self._telemetry_on = bool(header.get("telemetry"))
            if self._telemetry_on:
                self._enable_telemetry()
            if (
                self.journal is not None
                and isinstance(header.get("mono"), (int, float))
            ):
                # The symmetric half of the protocol clock sync: bless the
                # controller's (wall, mono) pair in THIS journal.
                self.journal.emit(
                    "clock_sync", source=self.agent_id,
                    peer=str(header.get("controller_id")),
                    peer_t=header.get("wall"), peer_mono=header.get("mono"),
                )
            known = [str(j) for j in header.get("known_jobs", ())]
            statuses = {j: self.job_status(j) for j in known}
            self._send({"type": "welcome", **self._info(), "jobs": statuses})
            # Results that finished while no controller was attached (or
            # whose ack never landed) are resent now — the re-attach half
            # of the restart contract.
            for jid in known:
                if statuses[jid] in ("done", "failed"):
                    self._push_result(jid)
        elif ftype == "ping":
            self._send({"type": "heartbeat", **self._info()})
            # The health plane rides the heartbeat cadence: one bounded
            # delta frame follows every heartbeat reply.
            self._send_telemetry()
        elif ftype == "submit":
            self._on_submit(header, payload)
        elif ftype == "result_ack":
            with self._lock:
                self._done.pop(str(header.get("job_id")), None)
        elif ftype == "drain":
            self.drain()
            self._send({"type": "heartbeat", **self._info()})
        elif ftype == "bye":
            raise _Detached
        else:  # registered but one-directional (controller-side) frame
            raise ProtocolError(f"unexpected frame {ftype!r} at agent")

    # -- job execution -------------------------------------------------------

    def _on_submit(self, header: dict, payload: bytes) -> None:
        jid = str(header["job_id"])
        tenant = header.get("tenant") or "default"
        label = header.get("label") or jid
        with self._lock:
            duplicate = jid in self._jobs or jid in self._done
            if not duplicate:
                # Reserve the jid UNDER the duplicate check: a redispatch
                # racing this handler on a newer connection must see the
                # reservation, or the job runs twice (the restart drill's
                # one-job_start-per-job invariant).
                self._jobs[jid] = None
        if duplicate:
            # A duplicate dispatch (controller retry racing an accept)
            # must not run twice: re-accept idempotently — and resend a
            # held result NOW, because a controller that re-dispatched
            # after a dropped accept is waiting on this job and the
            # hello-time resend already passed.
            self._send({"type": "accepted", "job_id": jid,
                        "duplicate": True})
            self._push_result(jid)
            return
        try:
            if self._draining or self._closed:
                self._send({"type": "rejected", "job_id": jid,
                            "reason": "shutting_down"})
                return
            try:
                data = decode_array(header, payload)
            except (ProtocolError, KeyError, ValueError) as e:
                self._send({"type": "rejected", "job_id": jid,
                            "reason": f"bad_payload: {e}"})
                return
            red = header.get("redundancy")
            mode = header.get("redundancy_mode")
            verdict, ticket = self.service.submit(
                data, tenant=tenant, job_id=label,
                redundancy=int(red) if red is not None else None,
                redundancy_mode=str(mode) if mode is not None else None,
            )
            if not verdict.admitted:
                self._send({"type": "rejected", "job_id": jid,
                            "reason": verdict.reason})
                return
            with self._lock:
                self._jobs[jid] = ticket
        finally:
            with self._lock:
                # A rejected/failed path drops its reservation; a real
                # ticket stays.
                if self._jobs.get(jid) is None:
                    self._jobs.pop(jid, None)
        self._send({"type": "accepted", "job_id": jid})
        threading.Thread(
            target=self._waiter, args=(jid, ticket), daemon=True,
            name=f"dsort-fleet-wait-{jid}",
        ).start()

    def _record_done(self, jid: str, entry: tuple) -> None:
        with self._lock:
            self._jobs.pop(jid, None)
            self._done[jid] = entry
            self._done.move_to_end(jid)
            evicted = []
            while len(self._done) > DONE_STORE_MAX:
                evicted.append(self._done.popitem(last=False)[0])
        for old in evicted:
            log.warning(
                "agent %s evicted unacked result for job %s (store at its "
                "%d-entry bound); a controller that still wants it will "
                "re-dispatch", self.agent_id, old, DONE_STORE_MAX,
            )

    def _waiter(self, jid: str, ticket) -> None:
        try:
            out = ticket.result()
        except BaseException as e:
            reason = (str(e).splitlines() or [repr(e)])[0][:200]
            self._record_done(jid, (False, reason))
        else:
            self._record_done(jid, (True, out))
        if self.journal is not None and self.journal_path:
            try:
                self.journal.flush_jsonl(self.journal_path)
            except OSError:
                pass
        self._push_result(jid)
        # A completion is a health-plane edge worth shipping immediately:
        # the phase seconds this job just accumulated reach the controller
        # with the result instead of waiting out a heartbeat period.
        self._send_telemetry()

    def _push_result(self, jid: str) -> None:
        with self._lock:
            entry = self._done.get(jid)
        if entry is None:
            return
        ok, value = entry
        if ok:
            meta, payload = encode_array(value)
            if len(payload) > MAX_FRAME_BYTES:
                # The sorted output cannot ride one frame: demote to a
                # TYPED failure so the controller's ticket fails loudly
                # instead of hanging behind an unsendable result (result
                # streaming is not built).
                value = (
                    f"result of {len(payload)} bytes exceeds the "
                    f"{MAX_FRAME_BYTES}-byte frame limit"
                )
                with self._lock:
                    self._done[jid] = (False, value)
                ok = False
            else:
                sent = self._send(
                    {"type": "result", "job_id": jid, "ok": True, **meta,
                     "variants": self.variant_labels()},
                    payload,
                )
        if not ok:
            sent = self._send(
                {"type": "result", "job_id": jid, "ok": False,
                 "reason": value, "variants": self.variant_labels()},
            )
        if not sent:
            log.info(
                "agent %s holds result for job %s (no controller attached)",
                self.agent_id, jid,
            )

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True) -> None:
        """Wind the agent down (``drain=True`` completes queued +
        in-flight jobs first, the SIGTERM path of ``cli fleet-agent``)."""
        if self._closed:
            return
        self._draining = True
        self.service.shutdown(drain=drain)
        self._closed = True
        _drop(self._listener)
        with self._send_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            _drop(conn)

    def kill(self) -> None:
        """Abrupt death for fault drills: sockets drop, queued jobs are
        abandoned (`ServiceClosed`), nothing is flushed gracefully."""
        self._closed = True
        _drop(self._listener)
        with self._send_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            _drop(conn)
        self.service.shutdown(drain=False, timeout=5.0)

    def __enter__(self) -> "FleetAgent":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
