"""Live health plane: streaming deltas -> rolling why-slow verdicts.

Counterpart of ``dsort_tpu/obs/health.py``: the streaming twin of
`obs.analyze`.

- **`HealthDeltaCollector`**: a `Metrics` event tap accumulating the
  analyzer's inputs as bounded deltas — per-phase wall seconds
  (``phase_end``), queue waits (``job_dequeued``), first calls
  (``variant_compiled``), the worst skew report and the high-water
  watermark.  `drain()` returns one delta dict and resets.  The running
  sums are exact; only the sample windows are bounded.
- **`HealthAnalyzer`**: folds deltas into rolling per-source verdicts in
  `obs.analyze.VERDICT_KEYS`' vocabulary (``dominant_phase``,
  ``straggler``, ``splits``, ``skew``, ``hbm`` spelled and computed the
  same way), so a live verdict and a replay of the same journal through
  `obs.analyze.analyze_records` compare field by field: straggler score
  against the mean busy time, dominant phase, queue/first-call/execute
  split, SLO-breach risk (rolling p95 queue wait against a target) and the
  ``degraded`` bit.

The deltas come from the agents: each `fleet.FleetAgent` taps its
service's `Metrics` with a collector and streams bounded ``telemetry``
frames to the `fleet.FleetController`, which folds them into one analyzer
(one source per agent), as the reference's fleet does; any `Metrics` can
be tapped the same way.  `health_table` is the one copy of the
health pane's columns, shared with ``cli top`` (`obs.top.render_health`).
"""

from __future__ import annotations

import threading
from collections import deque

from dsort_tpu_torch.obs.analyze import VERDICT_KEYS

#: Per-agent verdict keys, the reference's.  The ones the replay analyzer also reports are spelled
#: identically (`SHARED_VERDICT_KEYS` must stay a subset of
#: `obs.analyze.VERDICT_KEYS` — test-pinned), so live and post-hoc
#: verdicts are comparable field by field.
HEALTH_VERDICT_KEYS = (
    "agent",
    "busy_s",
    "score",
    "straggler",
    "dominant_phase",
    "splits",
    "skew",
    "hbm",
    "slo_risk",
    "degraded",
    "seq",
)

#: The vocabulary shared with the replay analyzer, by construction.
SHARED_VERDICT_KEYS = tuple(
    k for k in HEALTH_VERDICT_KEYS if k in VERDICT_KEYS
)
assert SHARED_VERDICT_KEYS == (
    "straggler", "dominant_phase", "splits", "skew", "hbm",
)

#: Bounds on the collector's sample windows (NOT on the exact sums).
WAIT_WINDOW = 64
COMPILE_WINDOW = 32


class _HealthSums:
    """The EXACT running sums both ends of the stream accumulate — one
    copy of the merge rule (`merge_delta`), shared by the collector's
    failed-send `restore` and the analyzer's `_AgentHealth.fold`, so the
    two sides can never desynchronize field by field."""

    def __init__(self):
        self.phase_s: dict[str, float] = {}
        self.wait_sum = 0.0
        self.wait_count = 0
        self.compile_sum = 0.0
        self.compile_count = 0
        self.skew: dict | None = None
        self.hbm: dict | None = None
        self.jobs_done = 0
        self.jobs_failed = 0

    def merge_delta(self, delta: dict) -> None:
        """Fold one delta dict's sums in: phase seconds and wait/compile
        sums ADD (exactness), skew/HBM take the worst, job counts add."""
        for phase, sec in dict(delta.get("phases") or {}).items():
            if isinstance(sec, (int, float)):
                self.phase_s[str(phase)] = (
                    self.phase_s.get(str(phase), 0.0) + float(sec)
                )
        self.wait_sum += float(delta.get("wait_s_sum", 0.0) or 0.0)
        self.wait_count += int(delta.get("wait_count", 0) or 0)
        self.compile_sum += float(delta.get("compile_s_sum", 0.0) or 0.0)
        self.compile_count += int(delta.get("compile_count", 0) or 0)
        skew = delta.get("skew")
        if isinstance(skew, dict) and (
            self.skew is None
            or skew.get("max_mean_ratio", 0.0)
            > self.skew.get("max_mean_ratio", 0.0)
        ):
            self.skew = dict(skew)
        hbm = delta.get("hbm")
        if isinstance(hbm, dict) and (
            self.hbm is None
            or hbm.get("bytes_in_use", 0) > self.hbm.get("bytes_in_use", 0)
        ):
            self.hbm = dict(hbm)
        self.jobs_done += int(delta.get("jobs_done", 0) or 0)
        self.jobs_failed += int(delta.get("jobs_failed", 0) or 0)


class HealthDeltaCollector:
    """Agent-side `Metrics` tap accumulating bounded health deltas.

    Attach to every `Metrics` whose events land in the agent's journal
    (the service's metrics plus each admitted job's — the
    `SortService.job_taps` seam); `drain()` under the heartbeat cadence.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._s = _HealthSums()
        self._waits: deque = deque(maxlen=WAIT_WINDOW)
        self._compiles: deque = deque(maxlen=COMPILE_WINDOW)

    # -- tap protocol ------------------------------------------------------

    def attach(self, metrics) -> None:
        """Tap a `Metrics` instance (idempotent)."""
        if self not in metrics.taps:
            metrics.taps.append(self)

    def observe(self, etype: str, fields: dict, mono: float, metrics) -> None:
        if etype == "phase_end":
            sec = fields.get("seconds")
            if isinstance(sec, (int, float)):
                phase = str(fields.get("phase", "?"))
                with self._lock:
                    self._s.phase_s[phase] = (
                        self._s.phase_s.get(phase, 0.0) + float(sec)
                    )
        elif etype == "job_dequeued":
            w = fields.get("wait_s")
            if isinstance(w, (int, float)):
                with self._lock:
                    self._s.wait_sum += float(w)
                    self._s.wait_count += 1
                    self._waits.append(float(w))
        elif etype == "variant_compiled":
            sec = fields.get("compile_s")
            if isinstance(sec, (int, float)):
                with self._lock:
                    self._s.compile_sum += float(sec)
                    self._s.compile_count += 1
                    self._compiles.append({
                        "variant": str(fields.get("variant", "?")),
                        "compile_s": float(sec),
                    })
        elif etype == "skew_report":
            ratio = fields.get("max_mean_ratio", 0.0)
            with self._lock:
                if (
                    self._s.skew is None
                    or ratio > self._s.skew.get("max_mean_ratio", 0.0)
                ):
                    self._s.skew = {
                        "max_mean_ratio": ratio,
                        "recv_argmax": fields.get("recv_argmax"),
                    }
        elif etype == "hbm_watermark":
            b = fields.get("bytes_in_use", 0)
            with self._lock:
                if (
                    self._s.hbm is None
                    or b > self._s.hbm.get("bytes_in_use", 0)
                ):
                    self._s.hbm = {
                        "bytes_in_use": b,
                        "phase": fields.get("phase", "?"),
                    }
        elif etype == "job_done":
            with self._lock:
                self._s.jobs_done += 1
        elif etype == "job_failed":
            with self._lock:
                self._s.jobs_failed += 1

    # -- the delta stream --------------------------------------------------

    def drain(self) -> dict:
        """One bounded delta dict; resets the accumulation.  Running sums
        are exact (never evicted downstream); the ``waits``/``compiles``
        windows are recent samples, oldest first."""
        with self._lock:
            self._seq += 1
            s = self._s
            delta = {
                "seq": self._seq,
                "phases": dict(s.phase_s),
                "wait_s_sum": s.wait_sum,
                "wait_count": s.wait_count,
                "waits": list(self._waits),
                "compile_s_sum": s.compile_sum,
                "compile_count": s.compile_count,
                "compiles": list(self._compiles),
                "skew": s.skew,
                "hbm": s.hbm,
                "jobs_done": s.jobs_done,
                "jobs_failed": s.jobs_failed,
            }
            self._s = _HealthSums()
            self._waits.clear()
            self._compiles.clear()
        return delta

    def restore(self, delta: dict) -> None:
        """Fold a drained-but-undelivered delta BACK (the agent's send
        failed — no controller attached / link dropped mid-frame).  The
        exact sums must survive a disconnect like results do, or a slow
        agent that completed work while detached under-reports its busy
        time forever and never scores as the straggler it is.  The sums
        merge through the SAME rule the analyzer folds with
        (`_HealthSums.merge_delta`); only the sample windows are handled
        here (restored samples are OLDER — they prepend)."""
        with self._lock:
            self._s.merge_delta(delta)
            old = [w for w in delta.get("waits") or ()
                   if isinstance(w, (int, float))]
            self._waits = deque(
                old + list(self._waits), maxlen=self._waits.maxlen
            )
            self._compiles = deque(
                [dict(c) for c in delta.get("compiles") or ()]
                + list(self._compiles),
                maxlen=self._compiles.maxlen,
            )


class _AgentHealth(_HealthSums):
    """Rolling accumulation of one agent's streamed deltas (the shared
    sums plus liveness, the delta sequence high-water mark, and the
    rolling wait window the SLO-risk p95 reads)."""

    def __init__(self):
        super().__init__()
        self.active = True
        self.seq = 0
        self.waits: deque = deque(maxlen=2 * WAIT_WINDOW)

    def fold(self, delta: dict) -> None:
        self.seq = max(self.seq, int(delta.get("seq", 0)))
        self.merge_delta(delta)
        for w in delta.get("waits") or ():
            if isinstance(w, (int, float)):
                self.waits.append(float(w))

    def busy_s(self) -> float:
        return sum(self.phase_s.values())


def _wait_p95(waits) -> float | None:
    if not waits:
        return None
    ordered = sorted(waits)
    return ordered[min(int(0.95 * len(ordered)), len(ordered) - 1)]


class HealthAnalyzer:
    """Controller-side incremental why-slow analyzer over streamed deltas.

    `ingest(agent, delta)` folds one agent's delta; `verdicts()` scores
    every known agent against the fleet-mean busy time exactly the way
    `obs.analyze.analyze_records` scores merged-journal sources, so the
    live straggler name, dominant phase and split match a replay of the
    same journals.  ``degraded`` flips when an agent is the fleet
    straggler at >= ``degraded_score`` times the mean (with at least
    ``min_busy_s`` of measured busy time — an idle fleet has no
    stragglers) or its rolling p95 queue wait breaches ``slo_ms``.
    """

    def __init__(
        self,
        degraded_score: float = 1.5,
        min_busy_s: float = 0.05,
        slo_ms: float | None = None,
    ):
        self.degraded_score = float(degraded_score)
        self.min_busy_s = float(min_busy_s)
        self.slo_ms = float(slo_ms) if slo_ms is not None else None
        self._lock = threading.Lock()
        self._agents: dict[str, _AgentHealth] = {}
        self._frames = 0

    def ingest(self, agent: str, delta: dict) -> None:
        with self._lock:
            st = self._agents.get(str(agent))
            if st is None:
                st = self._agents[str(agent)] = _AgentHealth()
            st.active = True  # a streaming agent is alive by definition
            st.fold(dict(delta or {}))
            self._frames += 1

    def set_active(self, agent: str, active: bool) -> None:
        """Mark one agent's liveness.  A DOWN agent keeps its rolling
        history (it may reconnect) but leaves the fleet-mean/straggler
        computation — a permanently-dead agent's frozen busy time must
        not make the one remaining healthy agent score as a straggler."""
        with self._lock:
            st = self._agents.get(str(agent))
            if st is not None:
                st.active = bool(active)

    def forget(self, agent: str) -> None:
        """Drop one agent's rolling state (it left the fleet for good)."""
        with self._lock:
            self._agents.pop(str(agent), None)

    @property
    def frames(self) -> int:
        with self._lock:
            return self._frames

    def agents(self) -> list[str]:
        with self._lock:
            return sorted(self._agents)

    def _verdict_locked(self, aid: str, mean_busy: float,
                        straggler_aid: str | None) -> dict:
        st = self._agents[aid]
        busy = st.busy_s()
        score = busy / mean_busy if mean_busy > 0 else 1.0
        dominant = (
            max(st.phase_s, key=st.phase_s.get) if st.phase_s else None
        )
        # The split mirrors obs.analyze.analyze_records verbatim (same
        # rounding, same subtraction) — the live==replay contract.
        compile_s = round(st.compile_sum, 6)
        total_phase_s = round(busy, 6)
        splits = {
            "queue_wait_s": round(st.wait_sum, 6),
            "compile_s": compile_s,
            "execute_s": round(max(total_phase_s - compile_s, 0.0), 6),
            "phase_wall_s": total_phase_s,
        }
        p95 = _wait_p95(st.waits)
        slo_risk = None
        if self.slo_ms is not None and p95 is not None:
            slo_risk = {
                "p95_wait_ms": round(p95 * 1e3, 3),
                "target_ms": self.slo_ms,
                "ratio": round(p95 * 1e3 / self.slo_ms, 3),
            }
        is_straggler = aid == straggler_aid
        degraded = st.active and bool(
            (
                is_straggler
                and score >= self.degraded_score
                and busy >= self.min_busy_s
            )
            or (slo_risk is not None and slo_risk["ratio"] >= 1.0)
        )
        return {
            "agent": aid,
            "busy_s": round(busy, 6),
            "score": round(score, 3),
            "straggler": is_straggler,
            "dominant_phase": dominant,
            "splits": splits,
            "skew": dict(st.skew) if st.skew else None,
            "hbm": dict(st.hbm) if st.hbm else None,
            "slo_risk": slo_risk,
            "degraded": degraded,
            "seq": st.seq,
        }

    def verdicts(self) -> dict[str, dict]:
        """``{agent_id: verdict}`` over every agent that ever streamed.

        The fleet mean and the straggler argmax are computed over ACTIVE
        agents only (`set_active`): a dead agent's frozen busy time must
        neither dilute the mean nor hold the straggler slot; its last
        verdict still renders (scored vs the live mean, never degraded).
        """
        with self._lock:
            if not self._agents:
                return {}
            busy = {
                a: st.busy_s() for a, st in self._agents.items() if st.active
            }
            if not busy:  # every agent down: score against all history
                busy = {a: st.busy_s() for a, st in self._agents.items()}
            mean_busy = sum(busy.values()) / len(busy)
            straggler_aid = None
            if len(busy) >= 2:
                # Same argmax the replay analyzer takes over merged
                # sources; sorted() makes ties deterministic.
                straggler_aid = max(sorted(busy), key=lambda a: busy[a])
            return {
                aid: self._verdict_locked(aid, mean_busy, straggler_aid)
                for aid in sorted(self._agents)
            }

    def verdict(self, agent: str) -> dict | None:
        return self.verdicts().get(str(agent))

    def scores(self) -> dict[str, tuple[bool, float]]:
        """``{agent_id: (degraded, score)}`` — the routing penalty input
        (`FleetController._route_locked`, ``routing="health"``)."""
        return {
            aid: (v["degraded"], v["score"])
            for aid, v in self.verdicts().items()
        }


def straggler_position(analyzer: HealthAnalyzer, agents) -> int | None:
    """Mesh POSITION of the degraded straggler among ``agents``, or None.

    The production binding for `SampleSort.straggler_fn`: ``agents`` is the attempt's agent ids in mesh-position order,
    and only a verdict that is BOTH the fleet straggler argmax AND
    degraded names a position — a merely-slowest-of-a-healthy-fleet
    agent never triggers the serve race, matching the routing penalty's
    own gate (`scores`).  Fault drills bind `FaultInjector.straggler`
    through the same seam instead, so tests exercise the identical
    race path a measured verdict would take.
    """
    verdicts = analyzer.verdicts()
    for pos, aid in enumerate(agents):
        v = verdicts.get(str(aid))
        if v is not None and v["straggler"] and v["degraded"]:
            return pos
    return None


def health_table(rows: dict[str, dict], indent: str = "") -> list[str]:
    """THE health-pane table — one copy of the columns, shared by the
    verdict-side renderer below and the scrape-side ``dsort top`` pane
    (`obs.top.render_health`).  ``rows``: per-agent cells with ``score``,
    ``degraded``, ``busy_ms``, ``dominant_phase``, ``straggler`` (marked
    ``*``)."""
    lines = [
        f"{indent}{'agent':<18}{'score':>8}{'degraded':>10}{'busy ms':>12}"
        f"{'dominant phase':>18}"
    ]
    for agent in sorted(rows):
        r = rows[agent]
        mark = "*" if r.get("straggler") else ""
        lines.append(
            f"{indent}{agent + mark:<18}{r.get('score', 0.0):>8.2f}"
            f"{'yes' if r.get('degraded') else 'no':>10}"
            f"{r.get('busy_ms', 0.0):>12.1f}"
            f"{str(r.get('dominant_phase') or '-'):>18}"
        )
    return lines


def format_health(verdicts: dict[str, dict]) -> str:
    """Human health pane over analyzer verdicts."""
    if not verdicts:
        return "(no health telemetry yet)\n"
    rows = {
        aid: {
            "score": v["score"],
            "degraded": v["degraded"],
            "busy_ms": v["busy_s"] * 1e3,
            "dominant_phase": v["dominant_phase"],
            "straggler": v["straggler"],
        }
        for aid, v in verdicts.items()
    }
    return "\n".join(health_table(rows)) + "\n"
