"""The serving layer's control plane as one serializable state machine.

Counterpart of ``dsort_tpu/serve/policy.py``: admission, weighted DRR and
SLO shedding folded into `ControlPolicy`, whose ``state_dict()`` /
``load_state()`` round-trip the whole queue state (per-tenant FIFO
contents in DRR order, deficits, rotation, admission counts, the shed
windows).  Pure: it imports numpy and the two pure modules beside it, no
torch; the owner calls every method under its own lock.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from dsort_tpu_torch.serve.admission import Admission, AdmissionController
from dsort_tpu_torch.serve.fair import DeficitRoundRobin

#: Sliding-window length of measured queue waits per tenant (`slo_shed_ms`).
SHED_WINDOW = 32


class ControlPolicy:
    """Admission + weighted DRR + SLO shedding as one state machine.

    The constructor takes plain numbers, not a `ServeConfig`, so the
    object stays a pure state machine; the service builds one from its
    config.
    """

    def __init__(
        self,
        max_queue_depth: int = 64,
        max_tenant_inflight: int = 16,
        drr_quantum_keys: int = 1 << 14,
        tenant_weights: dict | None = None,
        slo_shed_ms: float | None = None,
    ):
        self.admission = AdmissionController(max_queue_depth, max_tenant_inflight)
        self.drr = DeficitRoundRobin(
            quantum=drr_quantum_keys, weights=dict(tenant_weights or {})
        )
        self.slo_shed_ms = slo_shed_ms
        # Bounded deques — not the cumulative SLO histogram — so the shed
        # signal decays: once the queue drains, new near-zero waits
        # displace the congested ones and admission recovers.
        self._recent_waits: dict[str, deque] = {}

    # -- admission -----------------------------------------------------------

    def consider(
        self, tenant: str, shutting_down: bool = False,
        no_capacity: bool = False,
    ) -> Admission:
        """The typed verdict for one submission (an admitted job is
        counted into the queue depth).  Computes the SLO-shed signal
        internally from the measured wait windows."""
        return self.admission.consider(
            tenant, shutting_down, shed=self.should_shed(tenant),
            no_capacity=no_capacity,
        )

    def should_shed(self, tenant: str) -> bool:
        """``--slo-shed-ms``: live p95 of this tenant's recent measured
        queue waits over target WHILE work is queued.  The queued-work
        gate is what makes the verdict self-healing: an empty queue means
        a new job would wait ~0, so it is always admitted — and its
        near-zero wait then washes the congested window out."""
        if not self.slo_shed_ms:
            return False
        if self.admission.queue_depth <= 0:
            return False
        waits = list(self._recent_waits.get(tenant) or ())
        if not waits:
            return False
        return float(np.percentile(waits, 95)) * 1e3 > self.slo_shed_ms

    def note_wait(self, tenant: str, wait_s: float) -> None:
        """Record one measured queue wait (feeds the shed windows)."""
        dq = self._recent_waits.get(tenant)
        if dq is None:
            dq = self._recent_waits[tenant] = deque(maxlen=SHED_WINDOW)
        dq.append(float(wait_s))

    # -- queue ---------------------------------------------------------------

    def push(self, tenant: str, cost: int, token) -> None:
        """Queue one ADMITTED job (its depth was counted by `consider`)."""
        self.drr.push(tenant, cost, token)

    def pop(self):
        """Next ``(tenant, token)`` in weighted-DRR order (None when
        empty); the popped job leaves the admission queue depth."""
        nxt = self.drr.pop()
        if nxt is not None:
            self.admission.dequeued()
        return nxt

    def requeue(self, tenant: str, cost: int, token) -> None:
        """An evicted/re-routed in-flight job goes back on the queue."""
        self.admission.requeued()
        self.drr.push(tenant, cost, token)

    def finished(self, tenant: str) -> None:
        """A job left the service (done or failed)."""
        self.admission.finished(tenant)

    @property
    def queue_depth(self) -> int:
        return self.admission.queue_depth

    @property
    def queued(self) -> int:
        return len(self.drr)

    # -- serialization -------------------------------------------------------

    def state_dict(self, token_fn=None) -> dict:
        """JSON-able snapshot of the WHOLE control plane — queues in DRR
        order, deficits, rotation, admission counts, shed windows."""
        return {
            "admission": self.admission.state_dict(),
            "drr": self.drr.state_dict(token_fn),
            "recent_waits": {
                t: [round(w, 6) for w in dq]
                for t, dq in self._recent_waits.items() if dq
            },
        }

    def load_state(self, state: dict, token_fn=None) -> None:
        self.admission.load_state(dict(state.get("admission", {})))
        self.drr.load_state(dict(state.get("drr", {})), token_fn)
        self._recent_waits = {
            str(t): deque((float(w) for w in ws), maxlen=SHED_WINDOW)
            for t, ws in dict(state.get("recent_waits", {})).items()
        }
