"""Weighted deficit round robin over per-tenant job queues.

Counterpart of ``dsort_tpu/serve/fair.py``, pop for pop.  Classic DRR
(Shreedhar & Varghese) with job cost = key count: each tenant's queue
accrues ``quantum * weight`` deficit per visit and dispatches jobs while
its deficit covers their cost, so a tenant submitting huge jobs consumes
its share in keys, not in queue slots.  An emptied queue resets its
deficit (no credit banked while idle).

Pure data structure: the service drives it under its own lock.
"""

from __future__ import annotations

from collections import deque


def parse_weights(spec: str | None) -> dict[str, float]:
    """``"acme=2,blue=1"`` -> ``{"acme": 2.0, "blue": 1.0}`` (None -> {})."""
    out: dict[str, float] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        name, eq, value = item.partition("=")
        if eq != "=" or not name.strip():
            raise ValueError(
                f"tenant weight {item!r} must be NAME=WEIGHT (e.g. acme=2)"
            )
        w = float(value)
        if w <= 0:
            raise ValueError(f"tenant weight for {name!r} must be > 0, got {w}")
        out[name.strip()] = w
    return out


class DeficitRoundRobin:
    """Per-tenant FIFO queues scheduled by weighted deficit round robin."""

    def __init__(self, quantum: int = 1 << 18, weights: dict[str, float] | None = None):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = int(quantum)
        self.weights = dict(weights or {})
        self._queues: dict[str, deque] = {}
        self._deficit: dict[str, float] = {}
        self._rotation: deque[str] = deque()  # active tenants, visit order

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depths(self) -> dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def weight_of(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def push(self, tenant: str, cost: int, item) -> None:
        """Enqueue one job of ``cost`` key-units on ``tenant``'s queue."""
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
        if not q:
            # (Re)activation joins the END of the rotation with zero credit:
            # a tenant cannot jump the round by letting its queue drain.
            self._deficit[tenant] = 0.0
            if tenant not in self._rotation:
                self._rotation.append(tenant)
        q.append((max(int(cost), 1), item))

    def pop(self):
        """The next ``(tenant, item)`` in DRR order, or None when empty.

        Visits tenants in rotation; a visit grants ``quantum * weight``
        deficit, and the tenant dispatches while its head job's cost is
        covered.  Guaranteed to terminate: every full rotation strictly
        increases some active tenant's deficit toward its bounded head
        cost.
        """
        while self._rotation:
            tenant = self._rotation[0]
            q = self._queues.get(tenant)
            if not q:
                # Deactivate: deficit resets so idleness never banks credit.
                self._rotation.popleft()
                self._deficit.pop(tenant, None)
                continue
            cost, item = q[0]
            if self._deficit[tenant] >= cost:
                q.popleft()
                self._deficit[tenant] -= cost
                if not q:
                    self._rotation.popleft()
                    self._deficit.pop(tenant, None)
                return tenant, item
            # Not covered yet: grant this visit's quantum and move on.
            self._deficit[tenant] += self.quantum * self.weight_of(tenant)
            self._rotation.rotate(-1)
        return None

    # -- serialization (the fleet controller's restart contract, §12) --------

    def state_dict(self, token_fn=None) -> dict:
        """JSON-able snapshot: queues (in FIFO order), deficits, rotation.

        ``token_fn`` maps each queued item to its serialized form (the
        fleet controller stores job ids; the default assumes the items
        already are JSON-able).  Restoring through `load_state` preserves
        the exact DRR dispatch order — the restart drill's contract.
        """
        fn = token_fn or (lambda item: item)
        return {
            "queues": {
                t: [[int(c), fn(item)] for c, item in q]
                for t, q in self._queues.items() if q
            },
            "deficit": {t: float(d) for t, d in self._deficit.items()},
            "rotation": [t for t in self._rotation],
        }

    def load_state(self, state: dict, token_fn=None) -> None:
        fn = token_fn or (lambda tok: tok)
        self._queues = {
            str(t): deque((int(c), fn(tok)) for c, tok in q)
            for t, q in dict(state.get("queues", {})).items()
        }
        self._deficit = {
            str(t): float(d)
            for t, d in dict(state.get("deficit", {})).items()
            if t in self._queues
        }
        # Rotation keeps the persisted visit order; tenants that appeared
        # in the queues but not the rotation (shouldn't happen) append at
        # the end so no queued job is ever stranded.
        rot = [t for t in state.get("rotation", ()) if self._queues.get(t)]
        rot += [t for t in self._queues if t not in rot and self._queues[t]]
        self._rotation = deque(rot)
        for t in self._rotation:
            self._deficit.setdefault(t, 0.0)
