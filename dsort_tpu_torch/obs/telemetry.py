"""Live metrics registry and its Prometheus text snapshot.

Counterpart of ``dsort_tpu/obs/telemetry.py``: one `Telemetry` aggregates
a session's observable state across jobs — counter totals, phase wall
time, job outcomes, jobs in flight, operator gauges (queue depth, free
slices, the variant cache), per-tenant admission verdicts and SLO
histograms (`obs.slo`), the planner's decision series — fed by `Metrics`
event taps (`attach`).  `render_prometheus` writes the Prometheus text
exposition format (0.0.4), the same text as the reference's for the same
event stream; `parse_prometheus_text` is the minimal parser the tests
round-trip through; `obs.server` serves it.
"""

from __future__ import annotations

import threading
from collections import defaultdict

from dsort_tpu_torch.obs.histogram import LatencyHistogram
from dsort_tpu_torch.obs.slo import SLO_QUANTILES, SloStateMachine
from dsort_tpu_torch.utils.events import COUNTERS


class Telemetry:
    """Session-wide aggregate of counters, phases, gauges and SLO stages."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = defaultdict(int)
        self._phase_s: dict[str, float] = defaultdict(float)
        self._jobs: dict[tuple[str, str], int] = defaultdict(int)
        self._in_flight = 0
        self._gauges: dict[str, float] = {"queue_depth": 0.0}
        # Labeled gauge series keyed by (name, identity labels) — the
        # per-agent health gauges (ARCHITECTURE §13) ride here.
        self._series: dict[tuple[str, tuple], tuple[tuple, float]] = {}
        self._slo: dict[tuple[str, str], LatencyHistogram] = {}
        self._admissions: dict[tuple[str, str], int] = defaultdict(int)

    # -- ingestion ---------------------------------------------------------

    def attach(self, metrics) -> None:
        """Tap a `Metrics` instance so its events feed this registry.

        Idempotent per (metrics, telemetry) pair — schedulers and the CLI
        may both attach the same pair.
        """
        for tap in metrics.taps:
            if isinstance(tap, _TelemetryTap) and tap.telemetry is self:
                return
        metrics.taps.append(_TelemetryTap(self))

    def observe_stage(self, tenant: str, stage: str, seconds: float) -> None:
        key = (str(tenant), str(stage))
        with self._lock:
            h = self._slo.get(key)
            if h is None:
                h = self._slo[key] = LatencyHistogram()
        h.observe(seconds)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[str(name)] = float(value)

    def set_series(
        self, name: str, labels: dict, value: float, key: dict | None = None
    ) -> None:
        """Set one LABELED gauge sample (``dsort_<name>{labels} value``).

        ``key`` (default: all of ``labels``) identifies the series for
        replacement — an info-style series whose non-key labels carry
        current state (the health pane's ``dominant_phase``) REPLACES its
        stale incarnation instead of accumulating one series per distinct
        label set.
        """
        def flat(d):
            return tuple(sorted((str(k), str(v)) for k, v in d.items()))

        with self._lock:
            self._series[(str(name), flat(key if key is not None else labels))] = (
                flat(labels), float(value)
            )

    def inc_counter(self, name: str, by: int = 1) -> None:
        """Directly bump a session counter (serving-layer events that have
        no per-job `Metrics` to ride a ``job_done`` absorption on)."""
        with self._lock:
            self._counters[str(name)] += int(by)

    def admission_verdict(self, tenant: str, reason: str) -> None:
        """Count one admission verdict — the per-tenant backpressure series
        (``dsort_admissions_total{tenant=,reason=}``) the serving layer
        publishes on every `SortService.submit`."""
        with self._lock:
            self._admissions[(str(tenant), str(reason))] += 1

    def _job_started(self) -> None:
        with self._lock:
            self._in_flight += 1

    def _job_finished(self, tenant: str, outcome: str) -> None:
        with self._lock:
            self._in_flight = max(self._in_flight - 1, 0)
            self._jobs[(str(tenant), str(outcome))] += 1

    def _absorb_counters(self, delta: dict) -> None:
        with self._lock:
            for k, v in delta.items():
                if isinstance(v, (int, float)) and v:
                    self._counters[str(k)] += int(v)

    def _absorb_phase(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._phase_s[str(phase)] += float(seconds)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able full state (the ``/json`` endpoint + ``dsort top``)."""
        from dsort_tpu_torch.obs.prof import LEDGER

        ledger = LEDGER.snapshot()
        with self._lock:
            series_raw = sorted(self._series.items())
            snap = {
                "variant_ledger": ledger,
                "counters": dict(self._counters),
                "phase_seconds": {
                    k: round(v, 6) for k, v in self._phase_s.items()
                },
                "jobs": {
                    f"{t}/{o}": n for (t, o), n in self._jobs.items()
                },
                "jobs_in_flight": self._in_flight,
                "gauges": dict(self._gauges),
                "admissions": {
                    f"{t}/{r}": n for (t, r), n in self._admissions.items()
                },
                "slo": {
                    f"{t}/{s}": h.snapshot() for (t, s), h in self._slo.items()
                },
            }
        snap["series"] = {
            f"{name}{{{','.join(f'{k}={v}' for k, v in labels)}}}": v2
            for (name, _key), (labels, v2) in series_raw
        }
        return snap

    def render_prometheus(self) -> str:
        """The Prometheus text exposition snapshot (scrape body)."""
        from dsort_tpu_torch.obs.prof import LEDGER

        ledger = LEDGER.snapshot()
        with self._lock:
            counters = dict(self._counters)
            phases = dict(self._phase_s)
            jobs = dict(self._jobs)
            in_flight = self._in_flight
            gauges = dict(self._gauges)
            series = dict(self._series)
            admissions = dict(self._admissions)
            slo = dict(self._slo)
        lines = [
            "# HELP dsort_counter_total Registered framework counters "
            "(utils.events.COUNTERS).",
            "# TYPE dsort_counter_total counter",
        ]
        # EVERY registered counter renders (0 when never bumped): scrape
        # series must not appear and vanish with job mix.
        for name in sorted(set(COUNTERS) | set(counters)):
            lines.append(
                f'dsort_counter_total{{name="{name}"}} '
                f"{counters.get(name, 0)}"
            )
        lines.append("# TYPE dsort_phase_seconds_total counter")
        for phase in sorted(phases):
            lines.append(
                f'dsort_phase_seconds_total{{phase="{phase}"}} '
                f"{phases[phase]:.6f}"
            )
        lines.append("# TYPE dsort_jobs_total counter")
        for (tenant, outcome) in sorted(jobs):
            lines.append(
                f'dsort_jobs_total{{tenant="{tenant}",outcome="{outcome}"}} '
                f"{jobs[(tenant, outcome)]}"
            )
        if admissions:
            lines.append(
                "# HELP dsort_admissions_total Serving-layer admission "
                "verdicts per tenant (serve.admission.ADMISSION_REASONS)."
            )
            lines.append("# TYPE dsort_admissions_total counter")
            for (tenant, reason) in sorted(admissions):
                lines.append(
                    f'dsort_admissions_total{{tenant="{tenant}",'
                    f'reason="{reason}"}} {admissions[(tenant, reason)]}'
                )
        if ledger:
            from dsort_tpu_torch.obs.prof import LEDGER_GAUGES

            # The first-call ledger (obs.prof): one row per variant, same
            # labels as the journal's variant_compiled events — scrape ==
            # journal replay is the test contract.
            lines.append(
                "# HELP dsort_variant_compile_seconds Cumulative jit "
                "compile seconds per ladder-rung variant (obs.prof)."
            )
            for metric, field in LEDGER_GAUGES:
                lines.append(f"# TYPE {metric} gauge")
                for label in sorted(ledger):
                    value = ledger[label][field]
                    if value is None:  # not measurable on this device
                        continue
                    lines.append(f'{metric}{{variant="{label}"}} {value:.6g}')
        lines.append("# TYPE dsort_jobs_in_flight gauge")
        lines.append(f"dsort_jobs_in_flight {in_flight}")
        for name in sorted(gauges):
            metric = f"dsort_{name}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {gauges[name]:g}")
        # Labeled gauge series (per-agent health, ARCHITECTURE §13).
        typed: set[str] = set()
        for (name, _key), (labels, value) in sorted(series.items()):
            metric = f"dsort_{name}"
            if metric not in typed:
                typed.add(metric)
                lines.append(f"# TYPE {metric} gauge")
            body = ",".join(f'{k}="{v}"' for k, v in labels)
            lines.append(f"{metric}{{{body}}} {value:g}")
        lines.append(
            "# HELP dsort_job_stage_seconds Per-tenant SLO stage latency "
            "quantiles (obs.slo)."
        )
        lines.append("# TYPE dsort_job_stage_seconds summary")
        for (tenant, stage) in sorted(slo):
            h = slo[(tenant, stage)]
            labels = f'tenant="{tenant}",stage="{stage}"'
            for q in SLO_QUANTILES:
                lines.append(
                    f'dsort_job_stage_seconds{{{labels},quantile="{q}"}} '
                    f"{h.quantile(q):.6g}"
                )
            lines.append(
                f"dsort_job_stage_seconds_count{{{labels}}} {h.count}"
            )
            lines.append(
                f"dsort_job_stage_seconds_sum{{{labels}}} {h.sum:.6f}"
            )
        return "\n".join(lines) + "\n"


class _TelemetryTap:
    """Per-`Metrics` event tap feeding one `Telemetry`.

    Owns the per-job SLO state machine and the counter high-water mark for
    its Metrics instance (``job_done`` carries CUMULATIVE counters, so the
    registry must absorb deltas or a fused-fallback double ``job_done``
    would double-count).
    """

    def __init__(self, telemetry: Telemetry):
        self.telemetry = telemetry
        self._slo = SloStateMachine(telemetry.observe_stage)
        self._last_counters: dict = {}
        self._started: set = set()

    def observe(self, etype: str, fields: dict, mono: float, metrics) -> None:
        tel = self.telemetry
        job = fields.get("job")
        if etype == "job_start" and job not in self._started:
            self._started.add(job)
            tel._job_started()
        elif etype in ("job_done", "job_failed"):
            if job in self._started:
                self._started.discard(job)
                tenant = self._slo.tenant_of(job)
                tel._job_finished(
                    tenant, "done" if etype == "job_done" else "failed"
                )
            c = fields.get("counters")
            if isinstance(c, dict):
                tel._absorb_counters(
                    {
                        k: v - self._last_counters.get(k, 0)
                        for k, v in c.items()
                    }
                )
                self._last_counters = dict(c)
        elif etype == "phase_end":
            sec = fields.get("seconds")
            if isinstance(sec, (int, float)):
                tel._absorb_phase(fields.get("phase", "?"), sec)
        elif etype in ("plan_decision", "plan_override"):
            # The planner plane's gauges (ARCHITECTURE §15): per-policy
            # decision/override counts plus an info-style series carrying
            # the last chosen value — absorbed from the SAME journaled
            # events the plan verdict replays, wherever telemetry is
            # attached (serve, fleet, CLI), zero extra wiring.
            policy = str(fields.get("policy", "?"))
            which = (
                "plan_decisions" if etype == "plan_decision"
                else "plan_overrides"
            )
            with tel._lock:
                k = (which, (("policy", policy),))
                _, cur = tel._series.get(k, ((), 0.0))
                tel._series[k] = ((("policy", policy),), cur + 1.0)
            if etype == "plan_decision":
                chosen = fields.get("chosen")
                shown = (
                    f"[{len(chosen)} keys]"
                    if isinstance(chosen, (list, tuple)) else str(chosen)
                )
                tel.set_series(
                    "plan_info",
                    {"policy": policy, "chosen": shown},
                    1.0,
                    key={"policy": policy},
                )
        # The SLO machine consumes job_start BEFORE the outcome branches
        # above pop its state, and job_done after — step() order matters
        # only relative to its own reads, so one call at the end suffices.
        self._slo.step(etype, fields, mono)


def parse_prometheus_text(text: str) -> dict[tuple[str, tuple], float]:
    """Minimal Prometheus text parser: the tier-1 scrape round-trip.

    Returns ``{(metric_name, ((label, value), ...)): float}`` with labels
    sorted.  Covers exactly the subset `Telemetry.render_prometheus` emits
    (no escapes inside label values, no timestamps) and raises ValueError
    on anything that does not parse — a torn scrape must fail the gate, not
    vanish.
    """
    out: dict[tuple[str, tuple], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"unparseable metric line: {raw!r}")
        value = float(value_part)  # ValueError propagates
        labels: tuple = ()
        name = name_part.strip()
        if name.endswith("}"):
            name, _, label_body = name.partition("{")
            label_body = label_body[:-1]
            pairs = []
            for item in label_body.split(","):
                if not item:
                    continue
                k, eq, v = item.partition("=")
                if eq != "=" or not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"unparseable labels: {raw!r}")
                pairs.append((k, v[1:-1]))
            labels = tuple(sorted(pairs))
        if not name or any(ch in name for ch in "{} "):
            raise ValueError(f"unparseable metric name: {raw!r}")
        out[(name, labels)] = value
    return out
