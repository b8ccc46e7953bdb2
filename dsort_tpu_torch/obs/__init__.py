"""The observability plane: telemetry, SLOs, the flight recorder, the
first-call ledger and the planner.

Counterpart of ``dsort_tpu/obs``, cut to what is ported:

- `obs.histogram` / `obs.slo`: per-tenant stage latencies (admit ->
  dispatch -> sorted -> fetched), live and from a journal, identically;
- `obs.telemetry` + `obs.server`: the live metrics registry fed by
  `Metrics` taps, in Prometheus text over a localhost HTTP endpoint
  (``cli serve --metrics-port``);
- `obs.flight`: a bounded event ring per scheduler or service that dumps
  a postmortem bundle whenever a recovery path fires;
- `obs.prof`: the ledger of each variant's first call per stream
  (``variant_compiled``) and the memwatch tap (``hbm_watermark``);
- `obs.plan`: the planner (``plan_decision`` / ``plan_override``).

Not ported yet: ``obs.analyze``, ``obs.health``, ``obs.merge`` and
``obs.top`` (``dsort report`` / ``dsort top``).
"""

from dsort_tpu_torch.obs.flight import (  # noqa: F401
    BUNDLE_SCHEMA_KEYS,
    RECOVERY_EVENTS,
    FlightRecorder,
)
from dsort_tpu_torch.obs.histogram import LatencyHistogram  # noqa: F401
from dsort_tpu_torch.obs.plan import (  # noqa: F401
    PLAN_DECISION_FIELDS,
    PLAN_OVERRIDE_FIELDS,
    PLAN_POLICIES,
    Planner,
    plan_table,
    probe_skew,
    replay_decision,
)
from dsort_tpu_torch.obs.prof import (  # noqa: F401
    LEDGER,
    LEDGER_EVENT_FIELDS,
    CompileLedger,
    MemWatch,
    device_memory_snapshot,
    instrument_first_call,
    ledger_from_journal,
    variant_label,
)
from dsort_tpu_torch.obs.server import MetricsServer  # noqa: F401
from dsort_tpu_torch.obs.slo import SLO_QUANTILES, SLO_STAGES, slo_from_journal  # noqa: F401
from dsort_tpu_torch.obs.telemetry import Telemetry, parse_prometheus_text  # noqa: F401

__all__ = [
    "BUNDLE_SCHEMA_KEYS",
    "CompileLedger",
    "FlightRecorder",
    "LEDGER",
    "LEDGER_EVENT_FIELDS",
    "LatencyHistogram",
    "MemWatch",
    "MetricsServer",
    "PLAN_DECISION_FIELDS",
    "PLAN_OVERRIDE_FIELDS",
    "PLAN_POLICIES",
    "Planner",
    "RECOVERY_EVENTS",
    "SLO_QUANTILES",
    "SLO_STAGES",
    "Telemetry",
    "device_memory_snapshot",
    "instrument_first_call",
    "ledger_from_journal",
    "parse_prometheus_text",
    "plan_table",
    "probe_skew",
    "replay_decision",
    "slo_from_journal",
    "variant_label",
]
