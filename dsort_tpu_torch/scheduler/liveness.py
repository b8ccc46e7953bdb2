"""Worker liveness table (the reference's ``is_alive[]``, done right).

The reference tracks liveness in a bare int array read/written by all threads
with no lock (``server.c:19,232,361,369`` — SURVEY.md §5.2 calls out the
benign-by-luck race), detects death only via failed ``send``/``recv`` return
codes, and optimistically revives every worker at the start of each job
(``server.c:222,278``).  This table keeps the *semantics* — linear scan for
the first live worker (``server.c:368-384``), per-job optimistic revival —
but is lock-protected, records heartbeat timestamps (fixing the reference's
hang-blindness: a worker that hangs without closing its socket blocks the
reference forever, SURVEY.md §5.3), and keeps failure/reassignment counters.
"""

from __future__ import annotations

import enum
import threading
import time


class WorkerState(enum.Enum):
    ALIVE = "alive"
    DEAD = "dead"


class WorkerTable:
    """Thread-safe liveness registry for the mesh's logical workers."""

    def __init__(self, num_workers: int, heartbeat_timeout_s: float = 10.0):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._lock = threading.Lock()
        self._state = [WorkerState.ALIVE] * num_workers
        self._last_heartbeat = [time.monotonic()] * num_workers
        self.death_count = 0

    def heartbeat(self, worker: int) -> None:
        with self._lock:
            self._last_heartbeat[worker] = time.monotonic()

    def is_alive(self, worker: int) -> bool:
        with self._lock:
            return self._state[worker] is WorkerState.ALIVE

    def mark_dead(self, worker: int) -> None:
        with self._lock:
            if self._state[worker] is WorkerState.ALIVE:
                self._state[worker] = WorkerState.DEAD
                self.death_count += 1

    def first_live(self, exclude: int | None = None) -> int | None:
        """Linear scan for the first live worker (server.c:368-384 semantics).

        Returns None when no live worker remains — the caller's cue for the
        reference's clean-abort path (``server.c:387-390``).
        """
        with self._lock:
            for i in range(self.num_workers):
                if i != exclude and self._state[i] is WorkerState.ALIVE:
                    return i
        return None

    def live_workers(self) -> list[int]:
        with self._lock:
            return [
                i
                for i in range(self.num_workers)
                if self._state[i] is WorkerState.ALIVE
            ]

    def check_heartbeats(self) -> list[int]:
        """Mark workers whose heartbeat lapsed as dead; return newly dead."""
        now = time.monotonic()
        newly_dead = []
        with self._lock:
            for i in range(self.num_workers):
                if (
                    self._state[i] is WorkerState.ALIVE
                    and now - self._last_heartbeat[i] > self.heartbeat_timeout_s
                ):
                    self._state[i] = WorkerState.DEAD
                    self.death_count += 1
                    newly_dead.append(i)
        return newly_dead

    def revive_all(self) -> None:
        """Per-job optimistic revival (server.c:222,278): a worker that died
        last job is presumed alive again and re-detected on first use."""
        now = time.monotonic()
        with self._lock:
            self._state = [WorkerState.ALIVE] * self.num_workers
            self._last_heartbeat = [now] * self.num_workers
