"""Typed admission control: the service's backpressure surface.

Counterpart of ``dsort_tpu/serve/admission.py``, verdict for verdict.
Every `SortService.submit` returns an `Admission` verdict before any work
is queued: backpressure is a return value, never an exception or a
blocked caller.  The verdict vocabulary (`ADMISSION_REASONS`) is part of
the journal schema: an admitted job emits ``job_admitted``, a rejected
one ``job_rejected`` with the same reason string.

Pure bookkeeping (no torch): the service calls it under its own lock, so
none of these methods take locks.
"""

from __future__ import annotations

import dataclasses

#: The full verdict vocabulary, journal- and test-enforced (ARCHITECTURE §8).
ADMISSION_REASONS = (
    "admitted",        # accepted: the job is queued for dispatch
    "no_capacity",     # fleet plane (§12): every execution agent is draining
                       # or gone — backing off cannot help until an agent
                       # returns, so this outranks the queue bounds
    "queue_full",      # global queue-depth limit reached (back off, retry)
    "tenant_limit",    # this tenant's in-flight limit reached (tenant backs off)
    "shutting_down",   # the service is draining; no new work is accepted
    "slo_shed",        # --slo-shed-ms: this tenant's live p95 queue wait is
                       # over target while work is queued — shed instead of
                       # growing the wait (recovers once the queue drains)
)


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admission verdict: the typed backpressure signal.

    ``queue_depth``/``tenant_depth`` snapshot the state the verdict was
    computed against (AFTER the job was queued, for an admitted one), so a
    client can implement load-aware backoff from the verdict alone.
    """

    admitted: bool
    reason: str            # one of ADMISSION_REASONS
    tenant: str
    queue_depth: int       # jobs queued service-wide
    tenant_depth: int      # this tenant's queued + running jobs

    def __post_init__(self) -> None:
        if self.reason not in ADMISSION_REASONS:
            raise ValueError(
                f"unknown admission reason {self.reason!r}; add it to "
                "serve.admission.ADMISSION_REASONS"
            )


class AdmissionController:
    """Bounded per-tenant in-flight and global queue-depth admission.

    ``max_queue_depth`` bounds jobs *queued* (not yet dispatched)
    service-wide; ``max_tenant_inflight`` bounds one tenant's queued plus
    running jobs, so a single heavy tenant saturates its own budget before
    it can fill the shared queue.
    """

    def __init__(self, max_queue_depth: int, max_tenant_inflight: int):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}"
            )
        if max_tenant_inflight < 1:
            raise ValueError(
                f"max_tenant_inflight must be >= 1, got {max_tenant_inflight}"
            )
        self.max_queue_depth = max_queue_depth
        self.max_tenant_inflight = max_tenant_inflight
        self.queue_depth = 0
        self._tenant_inflight: dict[str, int] = {}

    def tenant_inflight(self, tenant: str) -> int:
        return self._tenant_inflight.get(tenant, 0)

    def consider(
        self, tenant: str, shutting_down: bool, shed: bool = False,
        no_capacity: bool = False,
    ) -> Admission:
        """The verdict for one submission; an admitted job is counted.

        ``shed`` is the SLO-driven signal the service computes (live p95
        queue wait over target with work still queued); it ranks below the
        hard bounds — a full queue is still ``queue_full``, the more
        actionable verdict for a backing-off client.  ``no_capacity`` is
        the fleet controller's signal that every execution agent is
        draining or dead; it outranks the queue bounds (a client retry is
        pointless until an agent returns) but not ``shutting_down``.
        """
        depth = self.queue_depth
        t_depth = self.tenant_inflight(tenant)
        if shutting_down:
            reason = "shutting_down"
        elif no_capacity:
            reason = "no_capacity"
        elif depth >= self.max_queue_depth:
            reason = "queue_full"
        elif t_depth >= self.max_tenant_inflight:
            reason = "tenant_limit"
        elif shed:
            reason = "slo_shed"
        else:
            reason = "admitted"
            self.queue_depth += 1
            self._tenant_inflight[tenant] = t_depth + 1
            depth, t_depth = depth + 1, t_depth + 1
        return Admission(reason == "admitted", reason, tenant, depth, t_depth)

    def dequeued(self) -> None:
        """A queued job moved to dispatch (still counted against its tenant)."""
        self.queue_depth = max(self.queue_depth - 1, 0)

    def requeued(self) -> None:
        """An evicted in-flight job went back on the queue (re-admission)."""
        self.queue_depth += 1

    def finished(self, tenant: str) -> None:
        """A job left the service (done or failed): release the tenant slot."""
        left = self.tenant_inflight(tenant) - 1
        if left > 0:
            self._tenant_inflight[tenant] = left
        else:
            self._tenant_inflight.pop(tenant, None)

    # -- serialization (the fleet controller's restart contract, §12) --------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the admission counts."""
        return {
            "queue_depth": int(self.queue_depth),
            "tenant_inflight": dict(self._tenant_inflight),
        }

    def load_state(self, state: dict) -> None:
        self.queue_depth = int(state.get("queue_depth", 0))
        self._tenant_inflight = {
            str(t): int(n)
            for t, n in dict(state.get("tenant_inflight", {})).items()
            if int(n) > 0
        }
