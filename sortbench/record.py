"""What one run recorded, as the metric readers see it.

A reader (``metrics/<name>.py``) is a function ``read(run) -> float |
None`` of a `Run`; None means it found nothing to read, and the harness
leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses

from sortbench.yardstick import hbm_peak, sort_bytes


@dataclasses.dataclass
class Job:
    """One job of the measured window."""

    start: float  # host clock, seconds
    end: float
    items: int  # keys or records in the job
    phase_s: dict  # the program's Metrics.phase_s
    counters: dict  # the program's Metrics.counters
    captured: bool  # inside the traced sub-window
    error: str | None = None


@dataclasses.dataclass
class Run:
    config: dict
    device_kind: str
    setup_s: float
    window_start: float
    jobs: list
    trace: object | None = None  # `trace.Trace` of the traced sub-window

    @property
    def done(self) -> list:
        return [j for j in self.jobs if j.error is None]

    @property
    def steady(self) -> list:
        """Completed jobs outside the traced sub-window: the profiler's
        cost is not in their host times."""
        return [j for j in self.done if not j.captured]

    def items_per_s(self) -> float | None:
        """All the work completed over the whole window: from its start to
        the end of its last job."""
        span = self.jobs[-1].end - self.window_start if self.jobs else 0.0
        return sum(j.items for j in self.done) / span if span > 0 and self.done else None

    def phase_ms(self, phase: str) -> float | None:
        """The program's host time of ``phase`` per steady job, in ms."""
        jobs = [j for j in self.steady if phase in j.phase_s]
        return 1e3 * sum(j.phase_s[phase] for j in jobs) / len(jobs) if jobs else None

    def counter_per_item(self, counter: str) -> float | None:
        """The program's counter ``counter`` per key or record sorted."""
        jobs = [j for j in self.steady if counter in j.counters]
        items = sum(j.items for j in jobs)
        return sum(j.counters[counter] for j in jobs) / items if items else None

    def device_s_per_job(self, cats, names=None) -> float | None:
        """Traced device time of such operations per captured job (s)."""
        if self.trace is None or not self.trace.jobs:
            return None
        return self.trace.busy_s(cats, names) / len(self.trace.jobs)

    def least_job_s(self) -> float | None:
        """The least time the card could take for one job's sort."""
        peak = hbm_peak(self.device_kind)
        if peak is None or not self.done:
            return None
        return sort_bytes(self.done[0].items, self.config["item_bytes"]) / peak
