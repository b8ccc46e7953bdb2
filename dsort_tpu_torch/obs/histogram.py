"""Streaming latency histogram: fixed log-spaced buckets, O(1) observe.

Counterpart of ``dsort_tpu/obs/histogram.py``, bucket for bucket: the SLO
quantiles are computed live (the metrics endpoint snapshots mid-session)
and post hoc from a journal, and both share this one deterministic
structure, so a scrape and a journal replay that saw the same durations
report identical quantiles — in either package.
"""

from __future__ import annotations

import bisect
import math
import threading

#: Bucket upper bounds in seconds: 100 us .. ~26 h, factor 2^(1/4) — ~19%
#: worst-case quantile resolution, 120 buckets, fixed for every histogram
#: so live and journal-derived instances always agree bucket-for-bucket.
BUCKET_BOUNDS: tuple[float, ...] = tuple(
    1e-4 * (2.0 ** (i / 4.0)) for i in range(120)
)


class LatencyHistogram:
    """Thread-safe log-bucketed duration histogram with quantile readout."""

    def __init__(self):
        self._lock = threading.Lock()
        # one overflow bucket past the last bound
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._total = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        i = bisect.bisect_left(BUCKET_BOUNDS, s)
        with self._lock:
            self._counts[i] += 1
            self._total += 1
            self._sum += s
            if s > self._max:
                self._max = s

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding rank ``ceil(q * count)``.

        Deterministic (no interpolation): the reported figure is a hard
        "no worse than" bound, and two histograms over the same samples
        always report the same value.  0.0 on an empty histogram.
        """
        with self._lock:
            if self._total == 0:
                return 0.0
            rank = min(max(math.ceil(q * self._total), 1), self._total)
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    if i >= len(BUCKET_BOUNDS):
                        # Overflow bucket: the largest observed duration is
                        # the only honest "no worse than" bound left.
                        return self._max
                    return BUCKET_BOUNDS[i]
        return self._max  # pragma: no cover (loop always returns)

    def snapshot(self) -> dict:
        """JSON-able state (count, sum, nonzero buckets) for ``/json``."""
        with self._lock:
            return {
                "count": self._total,
                "sum": round(self._sum, 6),
                "buckets": {
                    str(i): c for i, c in enumerate(self._counts) if c
                },
            }
