"""Structured per-job event journal: `Event` and `EventLog`.

Counterpart of ``dsort_tpu/utils/events.py``'s journal: a thread-safe log of
typed, monotonic-timestamped records that a `Metrics` fans its events into
(``Metrics(journal=EventLog())``), persisted as JSONL in the reference's
record format (``seq``, ``t``, ``mono``, ``type``, then the fields) — the
``--journal`` artifact of ``cli run`` and ``cli serve``; `COUNTERS` names
every counter.  The registries hold the reference's types of every ported
plane, the serving layer, the planner, the compile ledger and the flight
recorder included, with its descriptions word for word.  Not ported yet:
the fleet's and the native runtime's events (``agent_*``, ``job_routed``,
``health_verdict``, ``worker_join``, ...), journal rotation, the
Chrome-trace export and the human report (``dsort report``).
"""

from __future__ import annotations

import dataclasses
import json
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
    "plan_decisions": "knob values the closed-loop planner chose from "
                      "measured inputs (obs.plan; each journals a "
                      "plan_decision)",
    "plan_overrides": "explicit flag/conf values that won over the planner "
                      "while autotune was on (each journals a "
                      "plan_override)",
}


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
            "t": round(self.t, 6),
            "mono": round(self.mono, 6),
            "type": self.type,
            **self.fields,
        }


class EventLog:
    """Thread-safe, append-only journal of typed events for one job or a run of jobs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[Event] = []
        self._flushed = 0  # events already written by flush_jsonl

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
        O(new events), not O(all events)."""
        with self._lock:
            events = list(self._events)
            start = self._flushed
            self._flushed = len(events)
        if start == 0 or events[start:]:
            with open(path, "w" if start == 0 else "a", encoding="utf-8") as f:
                for e in events[start:]:
                    f.write(json.dumps(e.to_dict()) + "\n")

    @staticmethod
    def read_jsonl(path: str) -> list[dict]:
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
