"""Per-tenant SLO stage latencies, derived live and from a journal.

Counterpart of ``dsort_tpu/obs/slo.py``.  The job lifecycle the journal
records maps onto four stage boundaries — ``job_start`` (admit), the first
``attempt_start`` (dispatch), ``job_done`` (sorted), ``result_fetch``
(fetched) — and one state machine (`SloStateMachine`) backs both
consumers: `obs.telemetry`'s live tap and `slo_from_journal`'s replay, so
a scrape and a replay of one session report the same quantiles.  The
``tenant`` label rides ``job_start``; jobs in an interleaved journal are
told apart by the ``job`` ordinal `Metrics.event` stamps on every record.
"""

from __future__ import annotations

from dsort_tpu_torch.obs.histogram import LatencyHistogram

#: The stage vocabulary, in lifecycle order.  ``admit_to_sorted`` is the
#: end-to-end figure admission control (ROADMAP item 1) keys on.
SLO_STAGES: tuple[str, ...] = (
    "admit_to_dispatch",
    "dispatch_to_sorted",
    "sorted_to_fetched",
    "admit_to_sorted",
)

#: Quantiles the endpoint exposes per (tenant, stage).
SLO_QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99)

DEFAULT_TENANT = "default"


class _JobState:
    """Stage-boundary stamps of one in-flight job (keyed by ``job`` ordinal)."""

    __slots__ = ("tenant", "admit", "dispatch", "sorted")

    def __init__(self, tenant: str, admit: float):
        self.tenant = tenant
        self.admit = admit
        self.dispatch: float | None = None
        self.sorted: float | None = None

    def durations(self, done_mono: float) -> list[tuple[str, float]]:
        """Stage durations closable at ``job_done``/``job_failed`` time."""
        out = [("admit_to_sorted", done_mono - self.admit)]
        if self.dispatch is not None:
            out.append(("admit_to_dispatch", self.dispatch - self.admit))
            out.append(("dispatch_to_sorted", done_mono - self.dispatch))
        return out


class SloStateMachine:
    """The shared event -> stage-duration derivation.

    Call `step` with every event (in emission order per job); completed
    stage durations are reported through ``sink(tenant, stage, seconds)``.
    Uses only GIL-atomic dict/attr operations: concurrent emitters (the
    taskpool's shard threads) can at worst race two first-``attempt_start``
    stamps carrying near-identical monos — job_start/job_done, which gate
    the histograms, are single-threaded in every execution mode.
    """

    def __init__(self, sink):
        self._sink = sink
        self._jobs: dict = {}       # job ordinal -> _JobState
        self._done: dict = {}       # job ordinal -> (tenant, sorted mono)

    def step(self, etype: str, fields: dict, mono: float) -> None:
        job = fields.get("job")
        if etype == "job_start":
            # A repeated job_start on one ordinal is the fused path falling
            # back to the scheduler: admission already happened, keep it.
            if job not in self._jobs:
                self._jobs[job] = _JobState(
                    str(fields.get("tenant", DEFAULT_TENANT)), mono
                )
        elif etype == "attempt_start":
            st = self._jobs.get(job)
            if st is not None and st.dispatch is None:
                st.dispatch = mono
        elif etype in ("job_done", "job_failed"):
            st = self._jobs.pop(job, None)
            if st is not None:
                for stage, sec in st.durations(mono):
                    self._sink(st.tenant, stage, sec)
                if etype == "job_done":
                    self._done[job] = (st.tenant, mono)
                    # Bound retained terminal states: the fetch (if any)
                    # follows its job_done closely; a session never needs
                    # more than a handful pending.
                    while len(self._done) > 64:
                        self._done.pop(next(iter(self._done)))
        elif etype == "result_fetch":
            done = self._done.pop(job, None)
            if done is not None:
                tenant, sorted_mono = done
                self._sink(tenant, "sorted_to_fetched", mono - sorted_mono)

    @property
    def in_flight(self) -> int:
        return len(self._jobs)

    def tenant_of(self, job, default: str = DEFAULT_TENANT) -> str:
        """Tenant of an in-flight job ordinal (``default`` when unknown)."""
        st = self._jobs.get(job)
        return st.tenant if st is not None else default


def slo_from_journal(records: list[dict]) -> dict[tuple[str, str], LatencyHistogram]:
    """Replay a journal into ``{(tenant, stage): LatencyHistogram}``.

    Accepts raw or merged (`obs.merge`) records; jobs are keyed by
    ``(src, job)`` so a merged multi-host trace never conflates two hosts'
    ordinals.  Records predating the ``job`` stamp are skipped — no guess
    beats no data for an SLO.
    """
    hists: dict[tuple[str, str], LatencyHistogram] = {}

    def sink(tenant: str, stage: str, seconds: float) -> None:
        key = (tenant, stage)
        h = hists.get(key)
        if h is None:
            h = hists[key] = LatencyHistogram()
        h.observe(seconds)

    machines: dict = {}  # src -> SloStateMachine
    for r in sorted(records, key=lambda r: (r.get("mono", 0.0), r.get("seq", 0))):
        if "job" not in r or "mono" not in r:
            continue
        src = r.get("src", 0)
        m = machines.get(src)
        if m is None:
            m = machines[src] = SloStateMachine(sink)
        fields = {k: v for k, v in r.items() if k not in ("seq", "t", "mono", "type")}
        m.step(r["type"], fields, r["mono"])
    return hists
