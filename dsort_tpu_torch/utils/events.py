"""Structured per-job event journal: `Event` and `EventLog`.

Counterpart of ``dsort_tpu/utils/events.py``'s journal: a thread-safe log of
typed, monotonic-timestamped records that a `Metrics` fans its events into
(``Metrics(journal=EventLog())``), persisted as JSONL in the reference's
record format (``seq``, ``t``, ``mono``, ``type``, then the fields) — the
``--journal`` artifact of ``cli run`` and ``cli serve``; `COUNTERS` names
every counter.  The registries hold the reference's types of every ported
plane, the serving layer, the planner, the compile ledger and the flight
recorder included, with its descriptions word for word; the native
coordinator's lines (``worker_join``, ``task_done``, ...) land through
`EventLog.ingest` with the coordinator's own clock stamps, and the
fleet's (``agent_*``, ``job_routed``, ``controller_restore``,
``health_verdict``, ...) from `fleet.controller` and `fleet.agent`.

``EventLog(rotate_bytes=...)`` (``--journal-rotate-mb``) bounds any one
JSONL file; the journal's two consumers are `to_chrome_trace` (a Perfetto
``trace_event`` object: one pid per source journal, one tid per job) and
`format_report` (the human timeline behind ``cli report``), both as the
reference's, so either package renders the other's journal alike.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time

#: The event types this package emits, with the reference's descriptions.
#: `EventLog.emit` refuses any other type, so the journal's schema stays
#: documented here rather than drifting site by site.
EVENT_TYPES: dict[str, str] = {
    "job_start": "a sort job entered a scheduler (n_keys, mode)",
    "job_done": "the job completed (n_keys)",
    "job_failed": "the job failed cleanly (reason)",
    "clock_sync": "a process published one (wall, mono) clock pair, so a merger can align "
                  "the journals of a process group (process)",
    "attempt_start": "one execution attempt began (worker/live, shard)",
    "heartbeat_lapse": "a bounded wait lapsed — possible hang (worker/kind)",
    "probe": "a liveness probe ran on one device (worker, ok)",
    "worker_dead": "a worker/device was declared dead (worker, stage)",
    "mesh_reform": "the SPMD mesh re-formed over survivors (survivors)",
    "reassign": "a shard moved to another worker (shard, frm, to)",
    "fused_fallback": "the fused small-job path failed over to the "
                      "scheduler (reason)",
    "worker_join": "a worker joined the native coordinator cluster (worker)",
    "task_done": "one shard's result landed (native coordinator; worker, "
                 "task)",
    "capacity_retry": "an all_to_all bucket overflowed; retry resized "
                      "(observed, cap_pair)",
    "transient_retry": "a transient runtime error retried in place (worker)",
    "checkpoint_persist": "shard/range state persisted (kind, id, n)",
    "checkpoint_restore": "persisted state restored instead of re-sorting "
                          "(kind, n)",
    "checkpoint_clear": "stale/partial persisted state was cleared (reason)",
    "phase_start": "a timed phase opened (phase)",
    "phase_end": "a timed phase closed (phase, seconds)",
    "exchange_step": "one ring exchange step was planned with its measured "
                     "capacity (step, cap, bytes)",
    "exchange_resize": "a ring step's adaptive capacity exceeded the static "
                       "policy allocation — the per-step successor of the "
                       "whole-job capacity retry (step, cap, policy_cap)",
    "result_fetch": "a sorted result crossed device->host (n_keys) — the "
                    "'fetched' stage boundary of the SLO histograms",
    "skew_report": "the ring plan's measured bucket histogram, reduced "
                   "(max_mean_ratio, send/recv device loads, predicted "
                   "imbalance) — the skew signal the analyzer reads",
    "fused_exchange_launch": "one fused ring kernel launch replaced the "
                             "P-1 per-step collective dispatches (steps, "
                             "dispatches, dispatches_replaced, total_cap)",
    "fused_exchange_step": "one planned in-kernel step of the fused ring "
                           "(step, cap, bytes) — the fused twin of "
                           "exchange_step",
    "device_handle": "a device-resident result handle was made "
                     "(n_keys, shards)",
    "device_handle_invalidated": "a mesh re-form invalidated outstanding "
                                 "device-resident handles (reason, n)",
    "device_validate": "on-device validation ran over a device-resident "
                       "result (ok, n)",
    "device_consume": "a next stage consumed a device-resident result "
                      "(n_keys, donated)",
    # The coded redundancy plane (parallel.coded):
    "coded_replica_ship": "one coded exchange planned its redundancy plane "
                          "— full bucket copies to r-1 ring successors "
                          "(mode=replicate) or GF(256) parity slots "
                          "(mode=parity) (redundancy, mode, slots, bytes)",
    "coded_recover": "a dead worker's range was reconstructed by a LOCAL "
                     "merge of a survivor's replica slots — zero keys "
                     "re-sorted, zero re-dispatch (dead, holders, "
                     "recovered_keys, replica_bytes, redundancy, mode, "
                     "wall_s — the host merge — and fetch_s — the "
                     "snapshot's device-to-host copy)",
    "coded_budget_exceeded": "losses exceeded the replica budget (a dead "
                             "range's every holder dead too); recovery "
                             "degraded cleanly to the re-run path (dead, "
                             "redundancy)",
    "parity_recover": "a dead worker's range was reconstructed through the "
                      "GF(256) parity plane — survivors' retained out-"
                      "buckets plus XOR/RAID-6 parity slots solved the "
                      "missing buckets (dead, holders, recovered_keys, "
                      "replica_bytes, redundancy, mode, wall_s, fetch_s)",
    "coded_straggler_serve": "a range owned by the measured straggler was "
                             "served from the replica/parity plane because "
                             "the reconstruction finished before the "
                             "owner's fetch — the exactly-once claim of "
                             "the straggler-first protocol (range, mode, "
                             "holders, recovered_keys, wall_s)",
    "coded_owner_fetch": "the straggler-first race's owner leg completed — "
                         "``won`` says whether the owner's own fetch beat "
                         "the reconstruction (the serve event is then "
                         "absent) or arrived late and was discarded "
                         "(range, won, wall_s)",
    # The hierarchical exchange (parallel.exchange):
    "hier_exchange_plan": "one two-level exchange was sized from the (H,H) "
                          "host matrix (hosts, dev_per_host, legs, agg_cap, "
                          "scatter_cap, dcn_bytes, intra_bytes, "
                          "flat_ring_dcn_bytes)",
    "hier_exchange_leg": "one planned host-shift DCN leg of the two-level "
                         "exchange — H aggregated transfers, one per "
                         "(src-host, dst-host) pair (shift, cap, bytes)",
    "hier_reform": "the host grouping re-planned after a loss — a lost "
                   "worker re-forms within its host; a lost host shrinks "
                   "the (H,H) legs to survivors or downgrades to the flat "
                   "ring (survivors, hosts_before, hosts_after, downgraded)",
    # The out-of-core wave pipeline (models.wave_sort):
    "wave_start": "one input wave entered the mesh pipeline "
                  "(wave, n_keys)",
    "wave_done": "a wave's runs all landed in the (wave, run) store "
                 "(wave, runs, n_keys)",
    "wave_resume": "an interrupted wave's missing runs were re-sorted at "
                   "run granularity — restart-resume or in-flight repair "
                   "(wave, missing, present, reason)",
    # The flight recorder, the serving layer, the compile ledger and the
    # planner (obs.flight, serve, obs.prof, obs.plan), in the reference's
    # words:
    "flight_dump": "the fault flight recorder dumped a postmortem bundle "
                   "(path, recovery_path)",
    "job_admitted": "admission control accepted a job into the service "
                    "queue (tenant, queue_depth, n_keys)",
    "job_rejected": "admission control rejected a job (tenant, reason — "
                    "one of serve.admission.ADMISSION_REASONS)",
    "job_dequeued": "the fair scheduler dequeued a job for dispatch "
                    "(tenant, wait_s — the measured queue wait, big, "
                    "slices)",
    "job_evicted": "a fault evicted a queued/in-flight job from its mesh "
                   "slice (tenant, reason, slice, readmits) — dumps one "
                   "flight-recorder bundle per eviction",
    "job_readmitted": "an evicted job re-entered the service queue "
                      "(tenant, readmits)",
    "slice_retired": "a mesh sub-slice failed its liveness probe and left "
                     "the packing rotation (slice)",
    "variant_prewarm": "compiled-variant cache rungs were prewarmed at "
                       "startup (n, rungs)",
    "serve_drain": "the service began draining — no new admissions "
                   "(reason, drain, queued, in_flight)",
    "serve_stop": "the service wound down; the journal's close event "
                  "(jobs_done, jobs_failed, counters)",
    "variant_compiled": "one jit compile landed in the variant ledger "
                        "(variant, compile_s, flops, bytes_accessed, "
                        "peak/temp/output/argument_hbm_bytes)",
    "hbm_watermark": "a --memwatch device-memory snapshot at a phase "
                     "boundary (phase, edge, bytes_in_use, "
                     "max_device_bytes, source)",
    # The fleet plane (fleet/):
    "agent_register": "a fleet execution agent (re)registered with the "
                      "controller (agent, addr, capacity, big_jobs, "
                      "draining, variants, reattach)",
    "agent_heartbeat": "one controller->agent heartbeat round-trip (agent, "
                       "queued, in_flight, draining, variants)",
    "job_routed": "the fleet controller dispatched a job onto an agent "
                  "(job_id, tenant, agent, reason — locality/size/spill/"
                  "random/health, n_keys)",
    "job_rerouted": "a routed/in-flight job re-entered the fleet queue "
                    "after its agent drained, died, or forgot it (job_id, "
                    "tenant, frm, reason, readmits)",
    "job_dispatched": "an agent accepted a dispatched job — the submit "
                      "round-trip the send deadline must cover (job_id, "
                      "agent, accept_latency_s; the dispatch_timeout_s "
                      "policy's measured input)",
    "controller_restore": "a restarted fleet controller restored its "
                          "persisted queue + in-flight state (controller, "
                          "queued, inflight, agents)",
    # The health plane (obs.health over the fleet protocol):
    "health_verdict": "the controller's rolling why-slow verdict for one "
                      "agent, refreshed per ingested telemetry delta "
                      "(agent, score, straggler, dominant_phase, splits, "
                      "slo_risk, degraded, seq — obs.health."
                      "HEALTH_VERDICT_KEYS)",
    "agent_degraded": "an agent's health verdict flipped degraded — the "
                      "controller dumps a flight bundle and health routing "
                      "penalizes it for big jobs (agent, score, "
                      "dominant_phase)",
    "plan_decision": "the closed-loop planner chose a knob value from "
                     "measured inputs, journaled BEFORE dispatch (policy — "
                     "one of obs.plan.PLAN_POLICIES, chosen, inputs — the "
                     "measured dict the pure policy replays from, rejected "
                     "— alternatives with reasons)",
    "plan_override": "an explicit flag/conf value won over the planner "
                     "while autotune was on (policy, explicit — the value "
                     "that won, planned — what the planner would have "
                     "chosen, inputs)",
}

#: Every `Metrics.bump` name in this package, with its meaning, under the
#: reference's names (``tests/test_torch_coded.py`` greps the package to
#: keep it exhaustive).
COUNTERS: dict[str, str] = {
    "reassignments": "shards moved to another worker after a failure",
    "heartbeat_timeouts": "taskpool attempts abandoned on a lapsed wait",
    "cold_wait_retries": "cold-key waits extended (likely a first build)",
    "transient_retries": "transient runtime errors retried in place",
    "device_runtime_errors": "real CUDA runtime failures routed to recovery",
    "device_deaths": "workers marked dead after failed probes",
    "mesh_reforms": "SPMD mesh re-formed over surviving workers",
    "spmd_wait_timeouts": "bounded in-flight SPMD program waits lapsed",
    "capacity_retries": "all_to_all bucket overflows resized and re-run",
    "shards_restored": "taskpool shards served from checkpoint",
    "spmd_phase_restores": "SPMD local-sort phases restored from checkpoint",
    "shuffle_phase_restores": "SPMD shuffle phases fully restored",
    "shuffle_ranges_restored": "persisted shuffle ranges restored",
    "shuffle_resort_keys": "keys re-sorted by the shuffle resume path",
    "runs_resumed": "external-sort runs restored from a previous run",
    "runs_sorted": "external-sort runs sorted this run",
    "native_merges": "k-way merges executed in native code",
    "fused_small_jobs": "jobs served by the fused single-program path",
    "fused_fallbacks": "fused-path failures retried on the SPMD scheduler",
    "device_handles": "device-resident result handles made",
    "device_handle_reruns": "invalidated device-resident handles re-run on "
                            "the current mesh",
    "device_validates": "on-device validations executed",
    "device_consumes": "device-resident results consumed by a next stage",
    "exchange_ring_steps": "ring exchange transfer steps executed",
    "exchange_bytes_on_wire": "bytes the bucket exchange put on the wire "
                              "(every schedule; whole mesh; planned counts "
                              "on one card)",
    "exchange_bytes_saved": "wire bytes the ring schedule avoided vs the "
                            "policy-sized padded all_to_all",
    "fused_exchange_launches": "fused ring kernel launches (each replaces "
                               "P-1 per-step exchange dispatches)",
    "fused_exchange_steps": "steps executed inside fused ring kernel "
                            "launches",
    "coded_recoveries": "worker losses recovered by a local replica-slot "
                        "merge instead of a re-run (parallel.coded)",
    "coded_replica_bytes": "wire bytes the coded replica plane shipped "
                           "(also charged to exchange_bytes_on_wire)",
    "coded_recovered_keys": "keys reconstructed from replica slots by "
                            "coded recoveries (merged, never re-sorted)",
    "coded_straggler_serves": "ranges served from the replica/parity plane "
                              "ahead of their measured-straggler owner "
                              "(no failure involved; parallel.coded)",
    "hier_exchanges": "two-level (intra-host x DCN-leg) exchanges planned "
                      "and dispatched (parallel.exchange hier schedule)",
    "dcn_bytes_on_wire": "bytes the two-level exchange shipped over the "
                         "inter-host DCN legs (also charged to "
                         "exchange_bytes_on_wire)",
    "intra_host_bytes_on_wire": "bytes the two-level exchange kept on the "
                                "fast intra-host fabric (also charged to "
                                "exchange_bytes_on_wire)",
    "dcn_bytes_saved": "inter-host bytes the two-level schedule avoided vs "
                       "the flat ring's cross-host transfers for the same "
                       "measured histogram",
    "waves_sorted": "input waves run through the mesh exchange pipeline",
    "wave_runs_resorted": "(wave, run) store entries re-sorted by the "
                          "run-granular resume/repair path",
    "wave_resort_keys": "keys re-sorted by the wave resume/repair path",
    "batch_jobs_restored": "batched jobs served from checkpoint",
    "padded_elems": "elements allocated in batched padding layouts",
    "multihost_ranges_restored": "multi-process ranges restored",
    "multihost_resort_keys": "keys re-sorted by the multi-process resume path",
    # The flight recorder, the serving layer, the compile ledger and the
    # planner, in the reference's words:
    "flight_dumps": "postmortem bundles dumped by the fault flight recorder",
    "jobs_admitted": "jobs accepted by the serving layer's admission control",
    "jobs_rejected": "jobs rejected by admission control (typed verdict)",
    "jobs_readmitted": "evicted jobs re-admitted to the service queue",
    "slice_dispatches": "small jobs packed onto mesh sub-slices",
    "fullmesh_dispatches": "big jobs dispatched onto the full SPMD mesh",
    "variant_cache_hits": "compiled-variant cache hits (rung already cached)",
    "variant_cache_misses": "compiled-variant cache misses (rung compiled)",
    "variant_cache_evictions": "compiled variants dropped by the LRU bound",
    "variant_cache_prewarms": "compiled-variant rungs built by the startup "
                              "prewarm pass",
    "variant_compiles": "jit compiles recorded by the introspection ledger "
                        "(obs.prof; each carries cost/HBM analysis)",
    "hbm_watermarks": "device-memory snapshots taken at phase boundaries "
                      "(--memwatch)",
    # The fleet plane:
    "fleet_jobs_routed": "jobs the fleet controller dispatched onto "
                         "execution agents",
    "fleet_jobs_rerouted": "routed jobs re-queued after an agent drained, "
                           "died, or forgot them",
    "fleet_heartbeats": "controller->agent heartbeat round-trips completed",
    "controller_restores": "fleet controller restarts that restored "
                           "persisted queue/in-flight state",
    "fleet_telemetry_frames": "health-plane telemetry deltas the controller "
                              "ingested from its agents",
    "health_verdicts": "rolling per-agent health verdicts the controller "
                       "journaled",
    "agent_degradations": "agent health verdicts that flipped degraded "
                          "(each dumps one flight bundle)",
    "plan_decisions": "knob values the closed-loop planner chose from "
                      "measured inputs (obs.plan; each journals a "
                      "plan_decision)",
    "plan_overrides": "explicit flag/conf values that won over the planner "
                      "while autotune was on (each journals a "
                      "plan_override)",
}


#: Decimals of the seconds a record keeps of its ``t`` and ``mono`` stamps.
STAMP_DECIMALS = 6


@dataclasses.dataclass(frozen=True)
class Event:
    """One journal record.  ``t`` is wall-clock (cross-process mergeable);
    ``mono`` is ``time.monotonic()`` (in-process ordering and durations);
    ``seq`` is the per-log append index (total order even at equal clocks)."""

    seq: int
    t: float
    mono: float
    type: str
    fields: dict

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "t": round(self.t, STAMP_DECIMALS),
            "mono": round(self.mono, STAMP_DECIMALS),
            "type": self.type,
            **self.fields,
        }


class EventLog:
    """Thread-safe, append-only journal of typed events for one job or a run of jobs.

    ``rotate_bytes`` (``--journal-rotate-mb``) bounds any one JSONL file: a
    `flush_jsonl` that leaves ``path`` at or over the threshold renames it
    to ``path.N`` (N counting up: ``path.1`` is the oldest piece) and the
    next flush starts a fresh ``path``.  ``cli report`` stitches a rotated
    set back into one journal (`obs.merge.rotated_set`).  A flush, its size
    check and its rename run under one lock, so flushes from several
    threads (the service's slices) never tear or reorder a piece.
    """

    def __init__(self, rotate_bytes: int | None = None):
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()  # one flush (write + rotate) at a time
        self._events: list[Event] = []
        self._flushed = 0  # events already written by flush_jsonl
        self._rotate_bytes = rotate_bytes
        self._rotations = 0

    def emit(self, etype: str, **fields) -> Event:
        if etype not in EVENT_TYPES:
            raise ValueError(
                f"unregistered event type {etype!r}; add it to "
                "dsort_tpu_torch.utils.events.EVENT_TYPES"
            )
        t, mono = time.time(), time.monotonic()
        with self._lock:
            ev = Event(len(self._events), t, mono, etype, fields)
            self._events.append(ev)
        return ev

    def ingest(self, t: float, mono: float, etype: str, **fields) -> Event:
        """Append an event observed elsewhere (the native coordinator's
        drained lines) with its own timestamps, under this log's sequence."""
        if etype not in EVENT_TYPES:
            raise ValueError(f"unregistered event type {etype!r}")
        with self._lock:
            ev = Event(len(self._events), t, mono, etype, fields)
            self._events.append(ev)
        return ev

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def types(self) -> list[str]:
        """Event types in append order — the sequence tests assert on."""
        return [e.type for e in self.events()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def write_jsonl(self, path: str) -> None:
        """One JSON object per line — the ``--journal`` artifact format."""
        with open(path, "w", encoding="utf-8") as f:
            for e in self.events():
                f.write(json.dumps(e.to_dict()) + "\n")

    def flush_jsonl(self, path: str) -> None:
        """Write only the events not yet flushed, truncating on the FIRST
        flush so a stale file never mixes runs: IO per job stays
        O(new events), not O(all events).  With ``rotate_bytes`` set, a
        file left at or over the threshold rotates to ``path.N``
        afterwards (see the class docstring)."""
        with self._flush_lock:
            with self._lock:
                events = list(self._events)
                start = self._flushed
                self._flushed = len(events)
            if start == 0:
                # The anti-mixing guard covers the whole rotated set: a stale
                # run's path.N pieces would otherwise survive the truncation
                # and stitch into this run's trace in `cli report`.
                self._clear_rotated(path)
            if start == 0 or events[start:]:
                with open(path, "w" if start == 0 else "a", encoding="utf-8") as f:
                    for e in events[start:]:
                        f.write(json.dumps(e.to_dict()) + "\n")
            self._maybe_rotate(path)

    def _clear_rotated(self, path: str) -> None:
        if not self._rotate_bytes:
            return
        d = os.path.dirname(path) or "."
        name = re.escape(os.path.basename(path))
        try:
            for entry in os.listdir(d):
                if re.fullmatch(rf"{name}\.\d+", entry):
                    os.remove(os.path.join(d, entry))
        except OSError:  # diagnostics: never fatal
            return

    def _maybe_rotate(self, path: str) -> None:
        if not self._rotate_bytes:
            return
        try:
            if os.path.getsize(path) < self._rotate_bytes:
                return
            self._rotations += 1
            os.replace(path, f"{path}.{self._rotations}")
        except OSError:  # the journal is a diagnostic: never fatal
            return

    @staticmethod
    def read_jsonl(path: str) -> list[dict]:
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


# -- consumer 1: Chrome-trace (Perfetto trace_event) export -----------------


def to_chrome_trace(records: list[dict]) -> dict:
    """Records (``Event.to_dict`` shape) -> a Chrome ``trace_event`` object.

    ``phase_start``/``phase_end`` pairs become B/E duration events;
    everything else becomes an instant event with its fields as ``args``.
    Timestamps are microseconds on the monotonic clock, rebased to the
    first record.  Each source journal (the ``src`` field of a merged
    trace, `obs.merge`) renders as its own ``pid``, and each job (the
    ``job`` ordinal `Metrics.event` stamps) as its own ``tid`` within it,
    so concurrent jobs' phase spans never pair B/E markers across jobs;
    records without a job ordinal share tid 1.
    """
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    records = sorted(records, key=lambda r: (r["mono"], r.get("seq", 0)))
    t0 = records[0]["mono"]
    out = []
    tids: dict[tuple, int] = {}  # (pid, job ordinal) -> tid, first-seen order
    for r in records:
        us = (r["mono"] - t0) * 1e6
        args = {k: v for k, v in r.items() if k not in ("seq", "t", "mono", "type")}
        pid = int(r.get("src", 0)) + 1
        if "job" in r:
            # Job lanes start at tid 2: tid 1 holds the records with no job
            # ordinal, so they never pair B/E markers with a job's lane.
            key = (pid, r["job"])
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = sum(k[0] == pid for k in tids) + 2
                out.append(
                    {"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"job {r['job']}"}}
                )
        else:
            tid = 1
        common = {"pid": pid, "tid": tid, "ts": round(us, 1)}
        if r["type"] == "phase_start":
            out.append({"name": f"dsort:{args.get('phase', '?')}", "ph": "B", **common})
        elif r["type"] == "phase_end":
            out.append({"name": f"dsort:{args.get('phase', '?')}", "ph": "E", **common})
        else:
            out.append({"name": r["type"], "ph": "i", "s": "g", "args": args, **common})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# -- consumer 2: the human timeline behind `cli report` -----------------------


def format_report(records: list[dict]) -> str:
    """Human timeline + phase/counter tables for one journal.

    The timeline shows every non-phase event at its relative time; the phase
    table aggregates ``phase_end`` durations; the counter table shows the
    final counters carried by the last ``job_done``/``job_failed`` event,
    described from this package's `COUNTERS`.
    """
    if not records:
        return "(empty journal)\n"
    records = sorted(records, key=lambda r: (r["mono"], r.get("seq", 0)))
    t0 = records[0]["mono"]
    lines = ["timeline:"]
    phase_s: dict[str, float] = {}
    counters: dict[str, int] = {}
    for r in records:
        rel_ms = (r["mono"] - t0) * 1e3
        fields = {k: v for k, v in r.items() if k not in ("seq", "t", "mono", "type")}
        if r["type"] == "phase_end":
            sec = fields.get("seconds")
            if isinstance(sec, (int, float)):
                phase = fields.get("phase", "?")
                phase_s[phase] = phase_s.get(phase, 0.0) + sec
            continue
        if r["type"] == "phase_start":
            continue
        if r["type"] in ("job_done", "job_failed"):
            c = fields.pop("counters", None)
            if isinstance(c, dict):
                counters = c
        kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        lines.append(f"  {rel_ms:10.1f} ms  {r['type']:<18} {kv}".rstrip())
    if phase_s:
        lines.append("phases:")
        for k, v in sorted(phase_s.items()):
            lines.append(f"  {k:<14} {v * 1e3:10.3f} ms")
    if counters:
        lines.append("counters:")
        for k, v in sorted(counters.items()):
            desc = COUNTERS.get(k, "")
            lines.append(f"  {k:<26} {v:>10}  {desc}".rstrip())
    return "\n".join(lines) + "\n"
