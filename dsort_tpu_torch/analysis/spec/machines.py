"""Declarative protocol state machines: the fleet's lifecycles as data.

Counterpart of ``dsort_tpu/analysis/spec/machines.py``: the reference's
literal, with every handler and obligation naming the port's own fleet
sources (`fleet/agent.py`, `fleet/controller.py`), whose arms carry the
same frame vocabulary.  The port's `FleetAgent.kill` / `close` shut their
sockets down where the reference's only close them; that changes when a
peer sees the end of the stream, not which frames either side sends or
handles.

`PROTOCOL_SPEC` writes down what the handler code means: the agent-side
link machine (`fleet/agent.py` `_handle`), the controller-side job
machine (`fleet/controller.py` — reader-loop frames plus the dispatch
lane's reply frames), and the serve admission machine
(`serve/admission.py`) — states × `FRAME_TYPES`/`ADMISSION_REASONS`
events × guards → transitions, with per-transition obligations naming
the discharge call that makes the guard true ("persist before
result_ack").

The spec is a PURE dict literal on purpose: the DS10xx checker family
(`analysis/checkers/spec.py`) reads it by PARSING this source — the same
registry discipline as `EVENT_TYPES`/`FRAME_TYPES` — and cross-checks it
against the handler source both ways (every declared handled frame has a
dispatch arm, every arm is declared, no receivable frame is silently
droppable, every obligation's discharge call is present and ordered
before the frame it must precede).  The reference's model checker
(``dsort spec``) consumes the same structure as its transition oracle.

Spec schema per machine:

- ``registry``: which registry the event alphabet draws from
  (``FRAME_TYPES`` or ``ADMISSION_REASONS``).
- ``handler``: ``(repo-relative path, function name)`` of the dispatch
  site, or absent when coverage is registry-exhaustiveness only.
- ``receives``: the registry subset this side can be sent.
- ``handled``: frames with a dispatch arm in ``handler``.
- ``replies``: frames consumed as request replies (``expect=`` tuples),
  not by the dispatch chain.
- ``internal``: non-frame events (scheduler actions, timeouts).
- ``ignorable``: ``{state: (frames legitimately dropped there,)}``.
- ``states`` / ``initial`` / ``transitions``: the machine proper;
  transitions are ``(state, event, target, guard)`` rows.
- ``obligations``: ``{"file", "function", "must_call", "before_send"?}``
  rows — the named function must call ``must_call``, and when
  ``before_send`` names a frame type, the call must precede every send
  of that frame within the function.
"""

from __future__ import annotations

#: The protocol spec registry (pure literal: parsed, never imported, by
#: the DS10xx checker; imported only by the model checker and tests).
PROTOCOL_SPEC = {
    "agent_link": {
        "doc": "FleetAgent's per-connection frame machine",
        "registry": "FRAME_TYPES",
        "handler": ("dsort_tpu_torch/fleet/agent.py", "_handle"),
        "receives": ("hello", "ping", "submit", "result_ack", "drain",
                     "bye"),
        "handled": ("hello", "ping", "submit", "result_ack", "drain",
                    "bye"),
        "replies": (),
        "internal": ("job_finished",),
        "states": ("attached", "draining", "detached"),
        "initial": "attached",
        "ignorable": {},
        "transitions": (
            ("attached", "hello", "attached",
             "re-handshake: advertise info, report known_jobs statuses, "
             "resend done results whose ack never landed"),
            ("attached", "ping", "attached",
             "heartbeat reply + one bounded telemetry delta"),
            ("attached", "submit", "attached",
             "duplicate-check AND jid reservation atomically under _lock; "
             "duplicate -> idempotent accept + resend held result"),
            ("attached", "result_ack", "attached",
             "drop the held result from the bounded done store"),
            ("attached", "drain", "draining",
             "stop admitting; running jobs finish and their results ship"),
            ("attached", "bye", "detached",
             "controller detached cleanly; agent keeps running"),
            ("attached", "job_finished", "attached",
             "waiter thread records the done entry and pushes the result"),
            ("draining", "hello", "draining",
             "re-handshake still answered while draining"),
            ("draining", "ping", "draining", "heartbeat advertises draining"),
            ("draining", "submit", "draining",
             "rejected with the typed shutting_down reason"),
            ("draining", "result_ack", "draining",
             "late acks for pre-drain jobs still clear the done store"),
            ("draining", "drain", "draining", "idempotent"),
            ("draining", "bye", "detached", "clean detach while draining"),
            ("draining", "job_finished", "draining",
             "in-flight work finishes during the drain"),
        ),
        "obligations": (
            {"file": "dsort_tpu_torch/fleet/agent.py", "function": "_on_submit",
             "must_call": "_push_result",
             "why": "a duplicate dispatch re-sends the held result NOW — "
                    "the controller behind it missed the hello-time resend"},
            {"file": "dsort_tpu_torch/fleet/agent.py", "function": "_waiter",
             "must_call": "_record_done",
             "why": "the result enters the bounded done store before it is "
                    "pushed, so a crashed push can always resend"},
            {"file": "dsort_tpu_torch/fleet/agent.py", "function": "_handle",
             "must_call": "_push_result",
             "why": "the hello arm resends done results for known_jobs — "
                    "the re-attach half of the restart contract"},
        ),
    },
    "controller_job": {
        "doc": "FleetController's per-job lifecycle (queued -> dispatching "
               "-> inflight -> done/failed with at-least-once requeues)",
        "registry": "FRAME_TYPES",
        "handler": ("dsort_tpu_torch/fleet/controller.py", "_reader_loop"),
        "receives": ("welcome", "heartbeat", "accepted", "rejected",
                     "result", "telemetry"),
        "handled": ("result", "telemetry"),
        "replies": ("welcome", "heartbeat", "accepted", "rejected"),
        "internal": ("dispatch", "agent_lost", "restore"),
        "states": ("queued", "dispatching", "inflight", "done", "failed"),
        "initial": "queued",
        # Events with no effect in a state, each a deliberate decision
        # (DS1004 turns an UNdeclared drop into a finding): stale DRR
        # tokens discard at the pop site, late accept/reject replies are
        # discarded by the expect= tuples of a newer round, a dead agent
        # is a no-op for a job it no longer holds, and terminal jobs are
        # popped from the table before the snapshot a restore would read.
        "ignorable": {
            "queued": ("accepted", "rejected"),
            "dispatching": ("dispatch", "restore"),
            "inflight": ("dispatch", "accepted", "rejected"),
            "done": ("dispatch", "accepted", "rejected", "agent_lost",
                     "restore"),
            "failed": ("dispatch", "accepted", "rejected", "agent_lost",
                       "restore"),
        },
        "transitions": (
            ("queued", "dispatch", "dispatching",
             "DRR pop in weighted order; persisted (as inflight) before "
             "the submit frame leaves the controller"),
            ("dispatching", "accepted", "inflight",
             "agent reserved the jid; slot counted against its bound"),
            ("dispatching", "rejected", "queued",
             "agent refused (draining/bad payload) and readmits below the "
             "3x-links exhaustion bound: requeue for another agent"),
            ("dispatching", "rejected", "failed",
             "rejected by every agent (readmits at the exhaustion bound): "
             "typed terminal failure, never an infinite requeue loop"),
            ("dispatching", "agent_lost", "queued",
             "link died mid-dispatch: at-least-once requeue "
             "(job_rerouted, readmits bump)"),
            ("inflight", "result", "done",
             "ok result: completion persisted durably BEFORE result_ack"),
            ("inflight", "result", "failed",
             "error result: typed failure persisted before the ack"),
            ("queued", "result", "done",
             "result from a pre-reroute attempt lands after the timeout "
             "requeue: finish now; the re-queued DRR token goes stale and "
             "the pop site discards it"),
            ("queued", "result", "failed",
             "error result for a requeued job: same race, failure path"),
            ("dispatching", "result", "done",
             "the result outraces the accepted reply (results ride the "
             "reader thread, accepts ride the dispatch lane): finish"),
            ("dispatching", "result", "failed",
             "error result outracing the accept: typed terminal failure"),
            ("inflight", "agent_lost", "queued",
             "agent died holding the job: requeue on a survivor"),
            ("queued", "agent_lost", "queued",
             "death of an agent the job never reached is a no-op"),
            ("done", "result", "done",
             "late duplicate (at-least-once reroute finished elsewhere): "
             "free the slot, re-ack, NEVER re-finish"),
            ("failed", "result", "failed",
             "late duplicate after a failure: same idempotent re-ack"),
            ("queued", "restore", "queued",
             "controller restart: queued jobs reload inside the persisted "
             "policy snapshot in DRR order"),
            ("inflight", "restore", "inflight",
             "restart reconcile: the agent reports the job still running"),
            ("inflight", "restore", "done",
             "restart reconcile: the agent held a finished result for us"),
            ("inflight", "restore", "queued",
             "restart reconcile: the agent no longer knows the job "
             "(or is gone) — requeue, at-least-once"),
        ),
        "obligations": (
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_on_result", "must_call": "_finish_ok",
             "before_send": "result_ack",
             "why": "the completion (which persists durably) happens "
                    "before the ack that lets the agent drop its copy"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_on_result", "must_call": "_finish_error",
             "before_send": "result_ack",
             "why": "the failure path persists before the ack too"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_finish_ok", "must_call": "_flush_persist",
             "why": "durable-state-reflects-completion: fsync+rename "
                    "before the caller acks"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_finish_error", "must_call": "_flush_persist",
             "why": "failed is a terminal state and must survive restart"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_finish_ok", "must_call": "_persist_locked",
             "why": "the snapshot is built under _cv (flush runs outside)"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_agent_down", "must_call": "_requeue_locked",
             "why": "a dead agent's in-flight jobs re-enter the queue — "
                    "the no-lost-job half of at-least-once"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_dispatch_one", "must_call": "_persist_locked",
             "why": "the dispatching->inflight edge is persisted before "
                    "the lane returns"},
            {"file": "dsort_tpu_torch/fleet/controller.py",
             "function": "_requeue_locked", "must_call": "requeue",
             "why": "the DRR token goes back with the job — queue "
                    "conservation (a requeued job the policy never sees "
                    "would strand at depth-accounting time)"},
        ),
    },
    "serve_admission": {
        "doc": "AdmissionController's typed verdict lattice",
        "registry": "ADMISSION_REASONS",
        "receives": ("admitted", "no_capacity", "queue_full",
                     "tenant_limit", "shutting_down", "slo_shed"),
        "handled": (),
        "replies": (),
        "internal": (),
        "covers_registry": True,
        "states": ("submitted", "queued", "rejected"),
        "initial": "submitted",
        "ignorable": {},
        "transitions": (
            ("submitted", "admitted", "queued",
             "counted into the queue depth by the same verdict"),
            ("submitted", "no_capacity", "rejected",
             "every agent draining/absent: the fleet's typed no"),
            ("submitted", "queue_full", "rejected",
             "global bounded-depth backpressure"),
            ("submitted", "tenant_limit", "rejected",
             "per-tenant inflight bound"),
            ("submitted", "shutting_down", "rejected",
             "drain in progress: no new work"),
            ("submitted", "slo_shed", "rejected",
             "live p95 queue wait over the --slo-shed-ms target"),
        ),
        "obligations": (),
    },
}

#: Safety invariant catalog (the reference's, verbatim): what the model
#: checker proves over every explored interleaving.  Keys are the
#: invariant ids violations carry; values are the one-line contracts.
SPEC_INVARIANTS = {
    "no_lost_job": "every submitted job is always present in the "
                   "controller's table (in memory and, across a crash, "
                   "in the durable snapshot) until a terminal state",
    "no_double_finish": "a job reaches a terminal state at most once — "
                        "late duplicate results never re-finish",
    "durable_before_ack": "whenever a result_ack is on the wire, the "
                          "durable snapshot already records that job's "
                          "terminal state",
    "no_double_run": "an agent starts a given job id at most once "
                     "(at-least-once across agents, at-most-once per "
                     "agent)",
    "bounded_outstanding": "a controller never holds more than its "
                           "outstanding-cap jobs on one agent",
    "queue_conservation": "every queued job holds exactly one DRR "
                          "token, and a token for a non-queued job is "
                          "legal only when that job is terminal (the "
                          "stale token the dispatcher's pop site "
                          "lazily discards)",
}
