"""`SortService`: the event-driven multi-tenant serving core.

Counterpart of ``dsort_tpu/serve/service.py``:

  submit() ──Admission──▶ per-tenant queues ──DRR──▶ dispatcher ──▶ slices
  (non-blocking verdict)   (bounded depth)   (weighted fair)      or the mesh

- **Admission** (`serve.admission`): a typed verdict per submission —
  bounded global queue depth, per-tenant in-flight caps, SLO shedding;
  rejected work is a return value.  Verdicts are journaled
  (``job_admitted`` / ``job_rejected``) and counted per tenant.
- **Fair scheduling** (`serve.fair`): weighted deficit round robin over
  per-tenant FIFO queues, cost = key count; ``job_dequeued`` carries the
  measured queue wait.
- **Slices on one card.**  The scheduler's workers are virtual (rows of
  one card, `parallel.mesh.VirtualMesh`), so a slice is a group of
  ``slice_devices`` worker ids with a CUDA stream of its own.  Small jobs
  (< ``small_job_max``) run concurrently, one per free slice: the upload,
  the rung's padded sort (`models.pipelines._fused_small_fn`, the block
  kernels or S1) and the download are enqueued on the slice's stream,
  inside the callable the scheduler's bounded wait runs on the slice's
  lane thread (the current stream is per thread), so every tensor is
  allocated, used and freed on that stream.  Big jobs lease every slice
  and run `SpmdScheduler.sort` on the whole mesh on the default stream:
  big and small never overlap.
- **Faults.**  A loss on a slice (an injected `WorkerFailure` on its lead
  worker, a lapsed bounded wait, a CUDA device error) evicts the job
  (``job_evicted``: one flight bundle per eviction) and re-admits it
  (``job_readmitted``), at most once per live slice; the slice's lead is
  probed before it rejoins the free pool, and a failed probe retires it.
  One card is one context: when a slice's probe fails, the card itself is
  probed (`SpmdScheduler.probe_card`), and a failed card probe — a sticky
  CUDA error — retires every free slice at once (a slice in flight retires
  when its own job fails and its probe fails), so the queued jobs fail
  with "no live mesh slices remain" instead of waiting for a slice that
  will never come, and nothing is re-sorted on the host.  A re-form under a
  full-mesh job retires the dead workers' free slices (probe-gated).  An
  evicted coded job completes from its replica snapshot
  (`parallel.coded.journal_recovery`) with zero re-run.
- **The variant cache** (`serve.variants`): one fused variant per
  (rung, dtype, kernel), LRU-bounded with journaled hit/miss counters;
  `prewarm` runs each rung once on every slice's stream — the first call
  per stream, which `obs.prof` records — so the first tenant job of a
  size does not pay it.

Graceful shutdown: `shutdown(drain=True)` stops admission (verdict
``shutting_down``), completes every queued and in-flight job, journals
``serve_drain`` / ``serve_stop`` and flushes the journal.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig, ServeConfig
from dsort_tpu_torch.device import device_scope
from dsort_tpu_torch.scheduler.fault import (
    JobFailedError,
    ProgramWaitTimeout,
    WorkerFailure,
    classify_runtime_error,
)
from dsort_tpu_torch.serve.admission import Admission
from dsort_tpu_torch.serve.policy import ControlPolicy
from dsort_tpu_torch.serve.variants import VariantCache, fused_variant_key, spmd_variant_key
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer, new_job_ordinal

log = get_logger("serve")


class ServiceClosed(RuntimeError):
    """The service is shut down; the job was not (or will not be) run."""


class JobTicket:
    """Future-style handle for one admitted job."""

    def __init__(self, data: np.ndarray, tenant: str, job_id: str | None,
                 ckpt_job_id: str | None, metrics: Metrics):
        self.data = data
        self.tenant = tenant
        self.job_id = job_id
        self.ckpt_job_id = ckpt_job_id
        self.metrics = metrics
        self.n_keys = len(data)
        self.readmits = 0
        # Per-job overrides of JobConfig.redundancy / redundancy_mode
        # (None = the config's).
        self.redundancy: int | None = None
        self.redundancy_mode: str | None = None
        # A coded job evicted by a loss parks its replica snapshot here; the
        # re-dispatch completes from the slots instead of re-running.
        self.coded_state = None
        self.coded_dead: list = []
        self.admitted_mono = time.monotonic()
        self.queued_mono = self.admitted_mono  # reset on re-admission
        self._done = threading.Event()
        self._result: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id or self.metrics._job_ordinal()} not done within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class SortService:
    """Async job queue + fair scheduler + slice packing + variant cache.

    ``num_workers`` virtual workers of one `SpmdScheduler` on ``device``
    (``cuda`` unless ``cpu`` is asked), split into slices of
    ``serve.slice_devices`` workers.  ``runner`` (``runner(data, metrics,
    job_id=None)``, the CLI's ``taskpool`` / ``local`` sorters) replaces
    the scheduler: one execution slot, no packing, the same admission,
    fairness and shutdown.  ``start=False`` queues a whole workload before
    the dispatcher starts (`start`).
    """

    def __init__(
        self,
        num_workers: int = 8,
        device=None,
        job: JobConfig | None = None,
        serve: ServeConfig | None = None,
        telemetry=None,
        journal=None,
        journal_path: str | None = None,
        injector=None,
        runner=None,
        start: bool = True,
    ):
        self.job = job or JobConfig()
        self.serve = serve or ServeConfig()
        self.telemetry = telemetry
        self.journal = journal
        self.journal_path = journal_path
        self._injector = injector
        self._runner = runner
        self._cv = threading.Condition()
        self._flush_lock = threading.Lock()
        self._shutdown = False
        self._closed = False
        self._done_jobs = 0
        self._failed_jobs = 0
        # The control plane (serve.policy): admission + weighted DRR + SLO
        # shedding as one state machine, driven under self._cv throughout.
        self._policy = ControlPolicy(
            max_queue_depth=self.serve.max_queue_depth,
            max_tenant_inflight=self.serve.max_tenant_inflight,
            drr_quantum_keys=self.serve.drr_quantum_keys,
            tenant_weights=dict(self.serve.tenant_weights),
            slo_shed_ms=self.serve.slo_shed_ms,
        )
        self.variants = VariantCache(self.serve.variant_cache_entries)
        self._inflight: dict = {}  # ticket -> allocated slice ids
        if runner is None:
            from dsort_tpu_torch.scheduler import SpmdScheduler

            self._sched = SpmdScheduler(
                num_workers, device, self.job, injector, telemetry=telemetry,
            )
            self.device = self._sched.device
            # A worker reaped under a full-mesh job leaves the slice
            # rotation too — probe-gated, as an eviction is.
            self._sched.reform_listeners.append(self._on_mesh_reform)
            self._devices = list(self._sched.devices)
            self._set_slices(max(min(self.serve.slice_devices, len(self._devices)), 1))
        else:
            self._sched = None
            self.device = None
            self._devices = []
            self._slices = {0: None}
            self._streams = {0: None}
        self._free = set(self._slices)
        self._small_max = self.serve.small_job_max
        if self._small_max is None:
            from dsort_tpu_torch.models.pipelines import FUSED_SMALL_JOB_MAX

            self._small_max = FUSED_SMALL_JOB_MAX
        # Extra per-job taps: objects with ``.attach(metrics)`` offered
        # every admitted job's Metrics.  The planner rides here, so every
        # admission folds into its rolling inputs (the prewarm mix).
        self.job_taps: list = []
        from dsort_tpu_torch.obs.plan import Planner

        self.planner = Planner(job=self.job)
        self.job_taps.append(self.planner)
        # Service-level metrics: rejections and lifecycle events with no
        # per-job Metrics to ride on.
        self._svc_metrics = Metrics(journal=journal)
        if telemetry is not None:
            telemetry.attach(self._svc_metrics)
        self.planner.attach(self._svc_metrics)
        # The slice width from the journaled admission mix when autotune is
        # on and SERVE_SLICE_DEVICES is unset (obs.plan); the decision (or
        # the explicit key's plan_override) is journaled before any worker
        # thread starts.
        if self._sched is not None:
            from dsort_tpu_torch.obs.plan import planned_slice_devices

            records = []
            if journal is not None and hasattr(journal, "events"):
                records = [{"type": e.type, **e.fields} for e in journal.events()]
            cur = max(min(self.serve.slice_devices, len(self._devices)), 1)
            planned = int(planned_slice_devices(
                self.job, self.serve, cur, len(self._devices), records, self._svc_metrics,
            ))
            s = max(min(planned, len(self._devices)), 1)
            if s != cur:
                self._set_slices(s)
                self._free = set(self._slices)
        self.flight = None
        if self.job.flight_recorder_dir:
            from dsort_tpu_torch.obs.flight import FlightRecorder

            # The service recorder dumps evictions only (the scheduler's own
            # recorder covers re-forms and retries; a second dump of one
            # event would double-count); in runner mode, with no scheduler
            # recorder, it also dumps the coded reconstruction.
            svc_events = {"job_evicted"}
            if runner is not None:
                svc_events.add("coded_recover")
            self.flight = FlightRecorder(
                self.job.flight_recorder_dir, ring_size=self.job.flight_ring_size,
                state_fn=self._flight_state, config=self.job,
                events=frozenset(svc_events),
            )
        self._pool = ThreadPoolExecutor(
            max_workers=max(len(self._slices), 1), thread_name_prefix="dsort-serve",
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="dsort-serve-dispatch"
        )
        self._started = False
        self._publish_gauges()
        if start:
            self.start()

    def _set_slices(self, s: int) -> None:
        """Groups of ``s`` worker ids, each with a stream of its own on the
        card (None on the CPU)."""
        devs = self._devices
        groups = [devs[i: i + s] for i in range(0, len(devs) - s + 1, s)]
        cuda = self.device.type == "cuda"
        with self._cv:
            self._slices = {i: g for i, g in enumerate(groups or [devs])}
            self._streams = {
                i: torch.cuda.Stream(self.device) if cuda else None for i in self._slices
            }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the dispatcher (idempotent)."""
        if not self._started:
            self._started = True
            self._dispatcher.start()

    def __enter__(self) -> "SortService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- admission ----------------------------------------------------------

    def submit(
        self,
        data: np.ndarray,
        tenant: str | None = None,
        job_id: str | None = None,
        ckpt_job_id: str | None = None,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ) -> tuple[Admission, JobTicket | None]:
        """Admit one keys-only sort job; returns ``(verdict, ticket)``.

        Non-blocking: backpressure is the verdict.  ``job_id`` is a client
        label (journal only); ``ckpt_job_id`` also routes the job through
        the checkpointed full-mesh path when ``JobConfig.checkpoint_dir``
        is set.  ``redundancy`` / ``redundancy_mode`` override the job
        config's for this job.
        """
        data = np.asarray(data)
        tenant = tenant or self.job.tenant
        with self._cv:
            verdict = self._policy.consider(tenant, self._shutdown)
        if self.telemetry is not None:
            self.telemetry.admission_verdict(tenant, verdict.reason)
        if not verdict.admitted:
            self._svc_metrics.bump("jobs_rejected")
            # A rejected submission is a job of its own: its own ordinal,
            # so the job_lifecycle contract sees one trace per rejection
            # (on the service's ordinal, every rejection of a session
            # would fall into one trace of repeated job_rejected).
            self._svc_metrics.event(
                "job_rejected", job=new_job_ordinal(), tenant=tenant, reason=verdict.reason,
                queue_depth=verdict.queue_depth, n_keys=len(data),
            )
            log.warning(
                "job rejected for tenant %s: %s (queue_depth=%d)",
                tenant, verdict.reason, verdict.queue_depth,
            )
            return verdict, None
        metrics = Metrics(journal=self.journal)
        if self.telemetry is not None:
            self.telemetry.attach(metrics)
        if self.flight is not None:
            self.flight.attach(metrics)
        for tap in list(self.job_taps):
            tap.attach(metrics)
        ticket = JobTicket(data, tenant, job_id, ckpt_job_id, metrics)
        ticket.redundancy = redundancy
        ticket.redundancy_mode = redundancy_mode
        metrics.bump("jobs_admitted")
        metrics.event(
            "job_admitted", tenant=tenant, queue_depth=verdict.queue_depth,
            n_keys=len(data), dtype=str(data.dtype),
        )
        # The SLO 'admit' stamp: job_start at admission, so the
        # admit_to_dispatch histogram is the queue wait.  The executing
        # scheduler's own job_start on the same ordinal keeps this stamp.
        metrics.event(
            "job_start", mode="serve", n_keys=len(data), job_id=job_id, tenant=tenant,
        )
        with self._cv:
            self._policy.push(tenant, max(len(data), 1), ticket)
            self._cv.notify_all()
        self._publish_gauges()
        return verdict, ticket

    # -- dispatch -----------------------------------------------------------

    def _is_big(self, ticket: JobTicket) -> bool:
        if self._runner is not None:
            return False
        if ticket.ckpt_job_id and self.job.checkpoint_dir:
            # Resumable jobs take the checkpointed full-mesh path at any size.
            return True
        return ticket.n_keys >= self._small_max

    def _resources_free_locked(self, big: bool) -> bool:
        if not self._slices:
            return True  # every slice retired: dispatch fails loudly below
        if big:
            return len(self._free) == len(self._slices)
        return bool(self._free)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                nxt = None
                while nxt is None:
                    nxt = self._policy.pop()
                    if nxt is not None:
                        break
                    # Drain-exit only when nothing is queued, in flight, or
                    # admitted but not yet pushed (submit counts the job in
                    # queue_depth before it pushes it).
                    if (
                        self._shutdown
                        and not self._inflight
                        and self._policy.queue_depth == 0
                    ):
                        return
                    self._cv.wait(timeout=0.05)
                tenant, ticket = nxt
                big = self._is_big(ticket)
                while not self._resources_free_locked(big):
                    self._cv.wait(timeout=0.05)
                if not self._slices:
                    alloc = ()
                else:
                    alloc = tuple(sorted(self._free)) if big else (min(self._free),)
                self._free.difference_update(alloc)
                self._inflight[ticket] = alloc
            self._publish_gauges()
            if not alloc and self._runner is None:
                self._finish_error(ticket, JobFailedError("no live mesh slices remain"), alloc)
                continue
            wait_s = time.monotonic() - ticket.queued_mono
            self._note_wait(tenant, wait_s)
            ticket.metrics.event(
                "job_dequeued", tenant=tenant, wait_s=round(wait_s, 6),
                big=big, slices=list(alloc),
            )
            self._pool.submit(self._execute, ticket, alloc, big)

    def _note_wait(self, tenant: str, wait_s: float) -> None:
        with self._cv:
            self._policy.note_wait(tenant, wait_s)

    # -- execution ----------------------------------------------------------

    def _execute(self, ticket: JobTicket, alloc: tuple, big: bool) -> None:
        try:
            out = None
            if ticket.coded_state is not None:
                # An evicted coded job completes from the replica snapshot
                # its failed attempt left behind; an over-budget snapshot
                # returns None and degrades to the ordinary dispatch.
                state, dead = ticket.coded_state, list(ticket.coded_dead)
                ticket.coded_state, ticket.coded_dead = None, []
                out = self._complete_coded(ticket, state, dead)
            if out is None and self._runner is not None:
                out = self._runner(ticket.data, ticket.metrics, job_id=ticket.ckpt_job_id)
            elif out is None and big:
                out = self._sort_big(ticket)
            elif out is None:
                out = self._sort_small(ticket, alloc[0])
        except BaseException as e:
            if not big and self._should_readmit(ticket, e):
                self._evict_and_readmit(ticket, alloc, e)
            else:
                self._finish_error(ticket, e, alloc)
        else:
            self._finish_ok(ticket, out, alloc)

    def _sort_big(self, ticket: JobTicket) -> np.ndarray:
        m = ticket.metrics
        m.bump("fullmesh_dispatches")
        self.variants.note(
            spmd_variant_key(
                ticket.n_keys, len(self._devices), str(ticket.data.dtype),
                self.job.local_kernel, self.job.capacity_factor, self.job.exchange,
            ),
            metrics=m,
        )
        self._publish_gauges()
        return self._sched.sort(
            ticket.data, metrics=m, job_id=ticket.ckpt_job_id,
            redundancy=ticket.redundancy, redundancy_mode=ticket.redundancy_mode,
        )

    def _on_slice(self, sid: int, fn):
        """``fn`` wrapped to run on slice ``sid``'s stream (the card made
        current), on whichever thread calls it."""
        stream = self._streams.get(sid)

        def run():
            with device_scope(self.device), (
                torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            ):
                return fn()

        return run

    def _sort_small(self, ticket: JobTicket, sid: int) -> np.ndarray:
        from dsort_tpu_torch.models.pipelines import (
            _fused_small_fn,
            fused_sort_small,
            pad_for_fused,
            pad_rung,
        )
        from dsort_tpu_torch.obs.prof import LEDGER

        m = ticket.metrics
        data = ticket.data
        worker = self._slices[sid][0]
        m.event("attempt_start", worker=worker, slice=sid)
        m.bump("slice_dispatches")

        def inject():
            # Inside the bounded callable: an injected stall on the slice is
            # caught by the wait like a wedged program.
            if self._injector is not None:
                self._injector.check(worker, "slice")

        lane = ("slice", worker)
        if data.dtype.kind == "f" or len(data) == 0:
            # Float keys remap through the order-preserving carrier inside.
            def run_float():
                inject()
                return fused_sort_small(data, self.job.local_kernel, m, device=self.device)

            out = self._sched.run_bounded(
                self._on_slice(sid, run_float), n_keys=len(data), tag=f"slice{sid}",
                lane_key=lane,
            )
        else:
            n = len(data)
            dtype_str = str(data.dtype)
            kernel = self.job.local_kernel
            timer = PhaseTimer(m)
            with timer.phase("partition"):
                buf = pad_for_fused(data)

            def run():
                # The injection point, then the variant (a failed slice
                # counts no cache lookup, as in the reference), then the
                # upload, sort and download on the slice's stream; the
                # download is the completion barrier.
                inject()
                fn = self.variants.get_or_build(
                    fused_variant_key(n, dtype_str, kernel),
                    lambda: _fused_small_fn(pad_rung(n), dtype_str, kernel),
                    metrics=m,
                )
                x = torch.from_numpy(buf).to(self.device)
                return fn(x, n).cpu().numpy()

            with timer.phase("local_sort"):
                out = self._sched.run_bounded(
                    self._on_slice(sid, run), n_keys=n, tag=f"slice{sid}", lane_key=lane,
                )[:n]
        LEDGER.drain_to(m)
        m.bump("fused_small_jobs")
        m.event("job_done", n_keys=len(data), counters=dict(m.counters))
        self._publish_gauges()
        return out

    # -- fault handling -----------------------------------------------------

    def _complete_coded(self, ticket: JobTicket, state, dead):
        """Finish one re-admitted coded job from its replica snapshot:
        the sorted output (``coded_recover`` journaled, ``job_done``
        closing the job), or None after ``coded_budget_exceeded`` so the
        caller re-runs."""
        from dsort_tpu_torch.parallel.coded import journal_recovery

        m = ticket.metrics
        rec = journal_recovery(m, state, dead, tenant=ticket.tenant)
        if rec is None:
            log.warning(
                "coded completion over budget for tenant %s (positions %s at "
                "redundancy=%d); re-running", ticket.tenant, sorted(dead), state.redundancy,
            )
            return None
        out, info = rec
        m.event("job_done", n_keys=len(out), counters=dict(m.counters))
        log.warning(
            "job for tenant %s completed from replica slots after eviction: %d key(s) "
            "reconstructed, zero re-run", ticket.tenant, info["recovered_keys"],
        )
        return out

    def _should_readmit(self, ticket: JobTicket, e: BaseException) -> bool:
        faulty = isinstance(e, (WorkerFailure, ProgramWaitTimeout)) or (
            classify_runtime_error(e) is not None
        )
        return faulty and ticket.readmits < max(len(self._slices), 1)

    def _evict_and_readmit(self, ticket: JobTicket, alloc: tuple, e: BaseException) -> None:
        """Slice-job fault: evict (one flight bundle), re-admit, quarantine
        the slice behind a probe."""
        m = ticket.metrics
        ticket.readmits += 1
        state = getattr(e, "coded_state", None)
        if state is not None:
            ticket.coded_state = state
            ticket.coded_dead = list(getattr(e, "workers", None) or [e.worker])
        reason = (str(e).splitlines() or [repr(e)])[0][:120]
        m.event(
            "job_evicted", tenant=ticket.tenant, reason=reason,
            slice=alloc[0] if alloc else None, readmits=ticket.readmits,
        )
        m.bump("jobs_readmitted")
        m.event("job_readmitted", tenant=ticket.tenant, readmits=ticket.readmits)
        log.warning(
            "job evicted from slice %s (%s); re-admitting (attempt %d)",
            alloc, reason, ticket.readmits,
        )
        # Re-queue before releasing the in-flight slot: the drain exit is
        # "queue empty and nothing in flight", and the reverse order would
        # let an evicted job sit in neither.
        ticket.queued_mono = time.monotonic()
        with self._cv:
            self._policy.requeue(ticket.tenant, max(ticket.n_keys, 1), ticket)
            self._cv.notify_all()
        self._release(ticket, alloc, probe=True)
        self._publish_gauges()

    def _on_mesh_reform(self, dead_workers: list) -> None:
        """A full-mesh job's re-form reaped workers: retire the slices they
        lead (probe-gated: a transient failure whose probe passes keeps its
        slice).  A full-mesh job holds every slice while this fires, and
        `_release` skips ids retired here."""
        dead = set(dead_workers)
        with self._cv:
            suspects = [
                sid for sid, devs in self._slices.items() if devs and devs[0] in dead
            ]
        retired = []
        for sid in suspects:
            if self._probe_slice(sid):
                continue
            with self._cv:
                if sid in self._slices:
                    del self._slices[sid]
                    self._free.discard(sid)
                    retired.append(sid)
                self._cv.notify_all()
        for sid in retired:
            self._svc_metrics.event("slice_retired", slice=sid, reason="mesh_reform")
            log.warning(
                "slice %d retired after a full-mesh re-form; %d slices remain",
                sid, len(self._slices),
            )

    def _probe_slice(self, sid: int) -> bool:
        devs = self._slices.get(sid)
        if devs is None or self._sched is None:
            return True
        return self._sched._probe_device(devs[0])

    def _release(self, ticket: JobTicket, alloc: tuple, probe: bool = False) -> None:
        # Probes are bounded device calls: they run before the lock, never
        # under it.
        dead = [sid for sid in alloc if probe and not self._probe_slice(sid)]
        # One card, one context: when the card itself fails its probe, every
        # free slice on it is gone too (an allocated one retires through its
        # own job's failure and probe).
        card_lost = bool(dead) and self._sched is not None and not self._sched.probe_card()
        retired = []
        with self._cv:
            swept = sorted(self._free - set(alloc)) if card_lost else []
            self._inflight.pop(ticket, None)
            for sid in alloc:
                if sid not in self._slices:
                    continue
                if sid in dead:
                    del self._slices[sid]
                    self._free.discard(sid)
                    retired.append((sid, None))
                else:
                    self._free.add(sid)
            for sid in swept:
                if sid in self._slices:
                    del self._slices[sid]
                    self._free.discard(sid)
                    retired.append((sid, "card_probe"))
            self._cv.notify_all()
        for sid, why in retired:
            if why is None:
                self._svc_metrics.event("slice_retired", slice=sid)
            else:
                self._svc_metrics.event("slice_retired", slice=sid, reason=why)
            log.warning(
                "slice %d retired after a failed %s; %d slices remain",
                sid, "card probe" if why else "probe", len(self._slices),
            )

    # -- completion ---------------------------------------------------------

    def _finish_ok(self, ticket: JobTicket, out: np.ndarray, alloc: tuple) -> None:
        # The 'fetched' SLO boundary: the sorted keys are on the host here.
        ticket.metrics.event("result_fetch", n_keys=len(out))
        self._release(ticket, alloc)
        with self._cv:
            self._policy.finished(ticket.tenant)
            self._done_jobs += 1
        ticket.data = None  # a long session must not pin every input array
        ticket._result = out
        ticket._done.set()
        self._publish_gauges()
        self._flush_journal()

    def _finish_error(self, ticket: JobTicket, e: BaseException, alloc: tuple) -> None:
        # Close the job on the telemetry side even when the scheduler did
        # not reach its own job_failed: duplicates are no-ops for the taps.
        ticket.metrics.event(
            "job_failed", reason=(str(e).splitlines() or [repr(e)])[0][:120],
            counters=dict(ticket.metrics.counters),
        )
        self._release(ticket, alloc, probe=True)
        with self._cv:
            self._policy.finished(ticket.tenant)
            self._failed_jobs += 1
        ticket._error = e
        ticket._done.set()
        log.error("job for tenant %s failed: %s", ticket.tenant, e)
        self._publish_gauges()
        self._flush_journal()

    # -- variant prewarm ----------------------------------------------------

    def prewarm(self, sizes=None) -> int:
        """Run the fused variants once on every slice's stream before traffic.

        ``sizes`` (key counts; default: the ladder rungs in
        ``[serve.prewarm_min_keys, serve.prewarm_max_keys]``) map to their
        rungs; each (rung, dtype) variant is built once and run once on
        every slice's stream, the first call per stream that `obs.prof`
        records.  With ``serve.prewarm_policy == "auto"`` and no ``sizes``
        the set is the planner's prediction from the admission mix
        (``plan_decision``; the full ladder on a cold start); ``"all"`` is
        the exhaustive ladder.  Returns the number of fresh variants.
        """
        if self._runner is not None:
            return 0
        from dsort_tpu_torch.models.pipelines import _fused_small_fn, pad_rung
        from dsort_tpu_torch.obs.prof import LEDGER
        from dsort_tpu_torch.parallel.exchange import ladder_rungs

        dtype_str = self.job.key_dtype
        if sizes is None:
            ladder = ladder_rungs(self.serve.prewarm_max_keys, lo=self.serve.prewarm_min_keys)
            if self.serve.prewarm_policy == "auto":
                chosen = self.planner.decide(
                    "prewarm", self.planner.prewarm_inputs(ladder, dtype_str),
                    self._svc_metrics,
                )
                pairs = []
                for lbl in chosen:
                    r, _, dt = str(lbl).partition(":")
                    pairs.append((int(r), dt or dtype_str))
            else:
                pairs = [(int(r), dtype_str) for r in ladder]
        else:
            pairs = [(pad_rung(max(int(n), 1)), dtype_str) for n in sizes]
        pairs = sorted(set(pairs))
        kernel = self.job.local_kernel
        with self._cv:
            sids = sorted(self._slices)
        fresh = 0
        rungs = sorted({r for r, _ in pairs})
        for rung, dt in pairs:
            fn, built = self.variants.prewarm(
                fused_variant_key(rung, dt, kernel),
                lambda r=rung, d=dt: _fused_small_fn(r, d, kernel),
            )
            zero = np.zeros(rung, np.dtype(dt))
            for sid in sids:
                self._on_slice(sid, lambda: fn(
                    torch.from_numpy(zero).to(self.device), rung)[:1].cpu())()
            if built:
                fresh += 1
        LEDGER.drain_to(self._svc_metrics)
        if fresh:
            if self.telemetry is not None:
                self.telemetry.inc_counter("variant_cache_prewarms", fresh)
            self._svc_metrics.event(
                "variant_prewarm", n=fresh, rungs=[int(r) for r in rungs],
            )
            log.info("prewarmed %d variant rung(s) across %d slice(s)", fresh, len(sids))
        self._publish_gauges()
        return fresh

    # -- telemetry ----------------------------------------------------------

    def _publish_gauges(self) -> None:
        if self.telemetry is None:
            return
        stats = self.variants.stats()
        with self._cv:
            depth = self._policy.queue_depth
            free = len(self._free)
        self.telemetry.set_gauge("queue_depth", depth)
        self.telemetry.set_gauge("slices_free", free)
        self.telemetry.set_gauge("variant_cache_entries", stats["entries"])
        self.telemetry.set_gauge("variant_cache_hits", stats["hits"])
        self.telemetry.set_gauge("variant_cache_misses", stats["misses"])
        self.telemetry.set_gauge("variant_cache_prewarmed", stats["prewarmed"])

    def _flight_state(self) -> dict:
        return {
            "mode": "serve",
            "slices": {str(k): list(v) for k, v in self._slices.items() if v is not None},
            "free": sorted(self._free),
            "queued": self._policy.queue_depth,
            "in_flight": len(self._inflight),
        }

    def _flush_journal(self) -> None:
        if self.journal is not None and self.journal_path:
            with self._flush_lock:
                self.journal.flush_jsonl(self.journal_path)

    # -- introspection ------------------------------------------------------

    def queue_depth(self) -> int:
        with self._cv:
            return self._policy.queue_depth

    def stats(self) -> dict:
        with self._cv:
            return {
                "queued": self._policy.queue_depth,
                "in_flight": len(self._inflight),
                "done": self._done_jobs,
                "failed": self._failed_jobs,
                "slices": len(self._slices),
                "slices_free": len(self._free),
                "variant_cache": self.variants.stats(),
            }

    # -- shutdown -----------------------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> bool:
        """Stop admission and wind the service down.

        ``drain=True`` (what SIGINT / SIGTERM trigger in ``cli serve``)
        completes every queued and in-flight job first; ``drain=False``
        fails queued jobs with `ServiceClosed` and waits for the in-flight
        ones only.  Returns True when the service wound down inside
        ``timeout``.
        """
        dropped = []
        with self._cv:
            if self._closed:
                return True
            first = not self._shutdown
            self._shutdown = True
            queued, in_flight = self._policy.queued, len(self._inflight)
            if not drain:
                while True:
                    nxt = self._policy.pop()
                    if nxt is None:
                        break
                    dropped.append(nxt[1])
            self._cv.notify_all()
        if first:
            self._svc_metrics.event(
                "serve_drain", reason="shutdown", drain=bool(drain),
                queued=queued, in_flight=in_flight,
            )
        for ticket in dropped:
            self._finish_error(ticket, ServiceClosed("service shutting down"), ())
        if drain and not self._started:
            # A paused service still owes its queued jobs a drain.
            self.start()
        if self._started and self._dispatcher.is_alive():
            self._dispatcher.join(timeout=timeout)
            if self._dispatcher.is_alive():
                return False
        self._pool.shutdown(wait=True)
        with self._cv:
            self._closed = True
            done, failed = self._done_jobs, self._failed_jobs
        self._svc_metrics.event(
            "serve_stop", jobs_done=done, jobs_failed=failed,
            counters=dict(self._svc_metrics.counters),
        )
        self._publish_gauges()
        self._flush_journal()
        return True
