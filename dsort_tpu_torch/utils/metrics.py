"""Per-phase timers and counters for one job.

Counterpart of ``dsort_tpu/utils/metrics.py``: the same `Metrics` (phase
wall times, counters, optional journal and live taps) and `PhaseTimer`.
The counter and event names the sample sort uses are the reference's own
(``capacity_retries`` / ``capacity_retry``), so the two packages' metrics
compare key for key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict

from dsort_tpu_torch.utils.events import STAMP_DECIMALS

#: Process-wide job ordinals: the first event a `Metrics` emits claims the
#: next one, and every event of that job carries it as the ``job`` field.
_JOB_ORDINALS = itertools.count(1)


def new_job_ordinal() -> int:
    """The next process-wide ``job`` ordinal (`Metrics.event` stamps one
    per `Metrics`; an event that stands for a job of its own takes one)."""
    return next(_JOB_ORDINALS)


@dataclasses.dataclass
class Metrics:
    """Accumulated per-phase wall times and counters for one job.

    Lock-protected: dict read-modify-write is not atomic across threads.
    ``journal`` is any object with ``emit(etype, **fields)`` returning a
    record with a ``mono`` stamp; ``taps`` are objects with
    ``observe(etype, fields, mono, metrics)``.
    """

    phase_s: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    counters: dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    journal: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    taps: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    _job_ord: int | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def add(self, phase: str, seconds: float) -> None:
        with self._lock:
            self.phase_s[phase] += seconds

    def bump(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self.counters[counter] += by

    def event(self, etype: str, **fields) -> None:
        """Emit a journal event and fan it out to the live taps (a no-op
        when neither is attached)."""
        if self.journal is None and not self.taps:
            return
        fields.setdefault("job", self._job_ordinal())
        mono = None
        if self.journal is not None:
            # The taps get the stamp as the journal records it, so a replay
            # of the journal derives what they did: a duration on a
            # histogram bucket's bound lands in the same bucket both ways.
            mono = round(self.journal.emit(etype, **fields).mono, STAMP_DECIMALS)
        if self.taps:
            if mono is None:
                mono = time.monotonic()
            for tap in list(self.taps):
                tap.observe(etype, dict(fields), mono, self)

    def _job_ordinal(self) -> int:
        with self._lock:
            if self._job_ord is None:
                self._job_ord = new_job_ordinal()
            return self._job_ord

    def total_s(self) -> float:
        return sum(self.phase_s.values())

    def summary(self) -> dict:
        return {
            "phases_ms": {k: round(v * 1e3, 3) for k, v in self.phase_s.items()},
            "counters": dict(self.counters),
            "total_ms": round(self.total_s() * 1e3, 3),
        }


class PhaseTimer:
    """Context-manager timer feeding a `Metrics` object.

    A phase's wall time is host time: a phase that ends in a device sync
    (the sample sort's count fetch) covers its device work too.  Each
    phase is also a ``dsort:<phase>`` range (`utils.tracing.annotate`), so
    under ``cli run --profile-dir`` the phases line up against the kernels
    in the trace.
    """

    def __init__(self, metrics: Metrics):
        self.metrics = metrics

    @contextlib.contextmanager
    def phase(self, name: str):
        from dsort_tpu_torch.utils.tracing import annotate

        self.metrics.event("phase_start", phase=name)
        t0 = time.perf_counter()
        try:
            with annotate(f"dsort:{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.metrics.add(name, dt)
            self.metrics.event("phase_end", phase=name, seconds=round(dt, 6))
