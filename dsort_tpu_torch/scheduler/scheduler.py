"""The two schedulers: the task pool and the whole-mesh SPMD sort.

Counterpart of ``dsort_tpu/scheduler/scheduler.py``.  Both run over the
same liveness machinery (`WorkerTable`, `FaultInjector`, the per-worker
attempt lanes) and journal under the reference's event and counter names
through ``Metrics.event``.

`Scheduler` (``--mode taskpool``) is the reference C system's own design:
one worker per shard, one handler thread per shard, with

- failure detected on the exchange itself (an injected `WorkerFailure` at
  ``send`` / ``sort`` / ``recv``, or a CUDA error that
  `fault.classify_runtime_error` names a device error), plus a bounded
  wait per attempt, so a *hung* worker is detected too
  (`WorkerWaitTimeout`);
- reassignment by a linear scan for the first live worker and a retry of
  the whole shard there, after ``settle_delay_s``;
- result-slot pinning (shard ``i`` lands in slot ``i`` whichever worker
  ran it) and a host k-way merge (`ops.merge.merge_sorted_host`);
- all workers dead => `JobFailedError`, the scheduler survives for the
  next job; per-job optimistic revival of dead workers.

`DeviceExecutor` runs one shard on one virtual worker: the workers are
rows of one card, as `VirtualMesh` has them, so every worker's upload,
sort and download reach ``executor.device``.

`SpmdScheduler` (``--mode spmd``) phrases recovery as *re-form the mesh
over the live workers and re-run*, since a compiled collective cannot lose
a participant mid-flight: on a failure the dead worker is excluded and the
job re-dispatched to a `VirtualMesh` of the survivors.  The reference's
semantics are kept:

- failure detected on the exchange itself (an injected `WorkerFailure`, or a
  CUDA error that `fault.classify_runtime_error` names a device error, then
  a probe of every live worker);
- a hang detected too: the whole attempt runs on a daemon lane thread under
  a bounded wait (`run_bounded`); a lapse probes every worker, reaps the
  ones that fail, and re-forms — or, with every probe healthy, retries a
  bounded number of times with a geometrically growing budget;
- all workers dead ⇒ `JobFailedError`, the scheduler survives for the next
  job; per-job optimistic revival of dead workers.

**One card.**  The workers are virtual: worker ``i`` is row ``i`` of the
mesh, and every worker's probe is a round trip to the same card
(``self.device``).  A real device error therefore fails every probe at
once, and the job ends in a clean `JobFailedError`, never in a hang; only
injected faults take out a single virtual worker.  Real per-device
survivors come with a ``torch.distributed`` group of several cards.

``SpmdScheduler.sort(keep_on_device=True)`` returns a
`parallel.device_result.DeviceSortResult` under the same discipline; every
re-form invalidates the handles the scheduler has returned, and each re-runs
on the live mesh at its next use.

With a coded exchange (``redundancy`` > 1, `parallel.coded`) a worker lost
mid-ring costs no re-run: the failed attempt's snapshot rebuilds the dead
ranges by a local merge of a survivor's replica or parity slots
(`_try_coded_recovery`), and only a loss past the plane's budget re-runs.
Under ``hier`` every re-form journals how the host grouping re-planned
(``hier_reform``).  A worker `FaultInjector.slow` names is raced by the
coded plane's straggler serve (`SampleSort.straggler_fn`).

With ``JobConfig.checkpoint_dir`` and a ``job_id`` both schedulers resume
(`checkpoint.ShardCheckpoint`, the reference's store): the task pool
persists each sorted shard and restores it on a re-run
(``shards_restored``); the SPMD scheduler persists its local-sort shards
(``spmd_phase_restores``) and each shuffle range as it is read back, so a
retry or a re-run restores the ranges on disk and re-sorts only the keys of
the missing ones (``shuffle_ranges_restored``, ``shuffle_resort_keys``),
or restores the whole shuffle (``shuffle_phase_restores``).  An attempt
abandoned by a lapsed wait checks its cancel event before every write.
Float keys of both schedulers ride as the reference's ordered uints, the
carrier their stores hold.

With ``JobConfig.flight_recorder_dir`` both schedulers keep a flight
recorder (`obs.flight.FlightRecorder`, attached to every job's `Metrics`)
that dumps a postmortem bundle whenever a recovery path fires: a re-form,
a reassignment, a capacity retry, a transient retry, a checkpoint
restore, a coded recovery.  `SpmdScheduler(telemetry=...)` taps every
job's `Metrics` into an `obs.Telemetry` (the live metrics endpoint).
"""

from __future__ import annotations

import functools
import threading
import time
import weakref

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.data.partition import partition
from dsort_tpu_torch.device import device_scope, resolve_device
from dsort_tpu_torch.ops.float_order import (
    from_signed_keys,
    sort_float_keys_via_uint,
    to_signed_keys,
)
from dsort_tpu_torch.ops.local_sort import sort_padded, sort_with_kernel
from dsort_tpu_torch.ops.merge import merge_sorted_host
from dsort_tpu_torch.parallel.exchange import resolve_hier_hosts
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.scheduler.fault import (
    AttemptCancelled,
    FaultInjector,
    JobFailedError,
    ProgramWaitTimeout,
    WorkerFailure,
    WorkerWaitTimeout,
    classify_runtime_error,
)
from dsort_tpu_torch.scheduler.liveness import WorkerTable
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

log = get_logger("scheduler")


class _AttemptLane:
    """One daemon thread + queue: serializes one worker's attempts.

    A hung device call cannot be killed; running every attempt touching a
    worker on that worker's single lane bounds abandoned threads at one per
    worker PROCESS-WIDE, and the daemon flag keeps a hung lane from
    blocking process exit.  Lanes live in a module-level registry keyed by
    (device, worker) so every scheduler instance shares them — the hung
    resource is the device, not the scheduler.
    """

    def __init__(self, name: str):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._busy_since = 0.0  # monotonic start of the RUNNING entry; 0=idle
        threading.Thread(target=self._loop, daemon=True, name=name).start()

    def _loop(self) -> None:
        while True:
            fn, box, done, abandoned = self._q.get()
            if abandoned.is_set():
                # The waiter gave up (timeout) before this entry started:
                # never execute it — stale work must not consume injector
                # one-shots, stamp heartbeats, or re-sort a job that was
                # long since re-run elsewhere.
                done.set()
                continue
            self._busy_since = time.monotonic()
            try:
                box["r"] = fn()
            except BaseException as e:  # surfaced by the waiter
                box["e"] = e
            finally:
                self._busy_since = 0.0
                done.set()

    def stuck_for(self) -> float:
        """Seconds the CURRENT entry has been executing (0.0 when idle).

        The wedge-vs-slow-build discriminator: a wedged device call never
        returns, so this grows without bound.  Single writer (the lane
        thread); racing readers see either 0.0 or a valid start stamp.
        """
        t0 = self._busy_since
        return time.monotonic() - t0 if t0 else 0.0

    def submit(self, fn):
        box: dict = {}
        done = threading.Event()
        abandoned = threading.Event()
        self._q.put((fn, box, done, abandoned))
        return box, done, abandoned


# Lanes are created on first use and NEVER reclaimed: one daemon thread per
# ever-seen (device, worker) for the process lifetime is the deliberate cost
# of hang containment (the thread may be wedged inside a device call that
# cannot be killed, so "reclaiming" it is impossible anyway).
_DEVICE_LANES: dict = {}
_DEVICE_LANES_LOCK = threading.Lock()


def _lane_for_device(device: torch.device, worker: int) -> _AttemptLane:
    key = (str(device), worker)
    with _DEVICE_LANES_LOCK:
        lane = _DEVICE_LANES.get(key)
        if lane is None:
            lane = _DEVICE_LANES[key] = _AttemptLane(f"attempt-{device}-w{worker}")
        return lane


def _size_bucket(n: int) -> int:
    """Power-of-two size class — the granularity of wait-budget warm-up."""
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def _make_flight_recorder(job: JobConfig, state_fn):
    """A `FlightRecorder` when the job configures one, else None — one
    builder for both schedulers, so the bundle contract (config snapshot,
    ring size, state callback) cannot drift between them."""
    if not job.flight_recorder_dir:
        return None
    from dsort_tpu_torch.obs.flight import FlightRecorder

    return FlightRecorder(
        job.flight_recorder_dir, ring_size=job.flight_ring_size, state_fn=state_fn,
        config=job,
    )


def _sort_kwargs(exchange, redundancy=None, redundancy_mode=None) -> dict:
    """Per-call knob kwargs, omitted when unset: `None` means "JobConfig
    decides" and needs no plumbing — wrappers around SampleSort.sort (fault
    drills monkeypatch it) keep their original signature working.  Built in
    one place, so no recovery path can drop a knob another threads through."""
    kw = {} if exchange is None else {"exchange": exchange}
    if redundancy is not None:
        kw["redundancy"] = redundancy
    if redundancy_mode is not None:
        kw["redundancy_mode"] = redundancy_mode
    return kw


class DeviceExecutor:
    """Runs one shard's sort on one virtual worker — the task pool's worker.

    ``num_workers`` virtual workers on ``device`` (``cuda`` unless ``cpu``
    is asked), as `VirtualMesh` has them.  `sort_shard` keeps the reference
    worker's three stages in order, each behind the injector's check:
    ``send`` then the upload (``server.c:342-398``), ``sort`` then
    `ops.local_sort.sort_with_kernel` (``client.c:140-173``), ``recv`` then
    the download (``server.c:412-452``), which is the completion barrier.
    """

    def __init__(
        self,
        num_workers: int = 8,
        device=None,
        injector: FaultInjector | None = None,
        table: WorkerTable | None = None,
        kernel: str = "auto",
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = int(num_workers)
        self.device = resolve_device(device)
        self.injector = injector
        self.table = table
        #: The local sort kernel (`ops.local_sort.sort_with_kernel`; ``auto``
        #: is the block kernels for shards of 2^16 keys and more on the card,
        #: ``torch.sort`` elsewhere).
        self.kernel = kernel

    def _check(self, worker: int, stage: str) -> None:
        if self.injector is not None:
            self.injector.check(worker, stage)
        if self.table is not None:
            self.table.heartbeat(worker)

    def sort_shard(self, worker: int, data: np.ndarray) -> np.ndarray:
        self._check(worker, "send")
        with device_scope(self.device):
            x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
            self._check(worker, "sort")
            y = from_signed_keys(sort_with_kernel(to_signed_keys(x), self.kernel), x.dtype)
            self._check(worker, "recv")
            return y.cpu().numpy()


class Scheduler:
    """Task-pool scheduler: shard dispatch, liveness, reassignment, merge."""

    def __init__(self, executor: DeviceExecutor, job: JobConfig | None = None):
        self.executor = executor
        self.job = job or JobConfig()
        self.table = WorkerTable(executor.num_workers, self.job.heartbeat_timeout_s)
        executor.table = self.table
        # The job's kernel choice wins over the executor's default.
        executor.kernel = self.job.local_kernel
        self.flight = _make_flight_recorder(
            self.job,
            lambda: {
                "mode": "taskpool",
                "workers": executor.num_workers,
                "live": self.table.live_workers(),
            },
        )
        # (worker, shape, dtype, kernel) combos that completed once on that
        # worker: each virtual worker keeps its own cold windows, as each of
        # the reference's devices compiles its own executable.  On the card
        # the cold cost is the first build of the kernels.
        self._warm_shapes: set = set()

    def _warm_key(self, worker: int, shard: np.ndarray) -> tuple:
        return (worker, shard.shape, str(shard.dtype), self.executor.kernel)

    def _attempt_timeout(self, worker: int, shard: np.ndarray) -> float:
        return self._timeout_for(self._warm_key(worker, shard))

    def _timeout_for(self, warm_key: tuple) -> float:
        return self.job.heartbeat_timeout_s + (
            0.0 if warm_key in self._warm_shapes else self.job.compile_grace_s
        )

    def _attempt(
        self, worker: int, shard: np.ndarray, metrics: Metrics | None = None
    ) -> np.ndarray:
        """One attempt of one shard on one worker, under a bounded wait.

        Runs on the worker's own daemon lane (`_AttemptLane`), so a hung
        attempt, which cannot be killed, is abandoned rather than blocking
        process exit, and abandoned threads stay bounded at one per worker.
        A later attempt on a hung worker queues behind the stuck call; its
        wait lapses too and the shard moves on.

        A lapsed wait on a cold key (this (worker, shape) never completed,
        so the budget held ``compile_grace_s``) may be a slow first build,
        not a hang: the wait extends on the same in-flight attempt with
        doubled windows (1x + 2x + 4x the budget in all) before the worker
        is declared hung — no resubmit, so the shard is never sorted twice.
        With ``compile_grace_s=0`` a cold lapse is a hang like any other.
        """
        lane = _lane_for_device(self.executor.device, worker)
        box, done, abandoned = lane.submit(
            functools.partial(self.executor.sort_shard, worker, shard)
        )
        key = self._warm_key(worker, shard)
        cold = key not in self._warm_shapes and self.job.compile_grace_s > 0
        budget = self._timeout_for(key)
        windows = [budget, 2 * budget, 4 * budget] if cold else [budget]
        ok = False
        for n, w in enumerate(windows):
            if done.wait(timeout=w):
                ok = True
                break
            if n < len(windows) - 1:
                if metrics is not None:
                    metrics.bump("cold_wait_retries")
                log.warning(
                    "cold-key wait lapsed on worker %d — extending to a "
                    "%dx window (likely a slow first build, not a hang)",
                    worker, 2 ** (n + 1),
                )
        if not ok:
            abandoned.set()  # if still queued, it will be skipped, not run
            raise WorkerWaitTimeout(f"worker {worker} heartbeat timeout")
        if "e" in box:
            raise box["e"]
        if "r" not in box:  # skipped as abandoned by a racing earlier waiter
            raise WorkerWaitTimeout(f"worker {worker} attempt abandoned")
        self._warm_shapes.add(key)
        return box["r"]

    def _handle_shard(
        self, i: int, shard: np.ndarray, results: list, metrics: Metrics,
        ckpt=None, errors: list | None = None,
    ) -> None:
        """One shard's lifecycle: the reference's ``worker_handler`` loop.
        With a store, a shard an earlier run of the job finished is restored
        instead of sorted, and a shard sorted now is persisted."""
        if ckpt is not None and ckpt.has(i):
            results[i] = ckpt.load(i)
            metrics.bump("shards_restored")
            metrics.event("checkpoint_restore", kind="shard", id=i)
            return
        worker = i if self.table.is_alive(i) else -1
        transient_left = self.job.max_transient_retries
        while True:
            if worker < 0 or not self.table.is_alive(worker):
                worker = self.table.first_live()
                if worker is None:
                    return  # clean abort; the job-level gate raises
            try:
                metrics.event("attempt_start", shard=i, worker=worker)
                results[i] = self._attempt(worker, shard, metrics)
                if ckpt is not None:
                    ckpt.save(i, results[i])
                return  # result pinned to slot i (server.c:415)
            except Exception as e:
                kind = classify_runtime_error(e)
                # Only the dedicated wait-timeout type means "worker hung";
                # a genuine TimeoutError from inside the attempt surfaces
                # through the ordinary error path below.
                if isinstance(e, (WorkerFailure, WorkerWaitTimeout)):
                    stage = getattr(e, "stage", "timeout")
                elif kind == "transient" and transient_left > 0:
                    # The device underneath is likely healthy: retry the
                    # SAME worker a bounded number of times first.
                    transient_left -= 1
                    metrics.bump("transient_retries")
                    metrics.event("transient_retry", shard=i, worker=worker)
                    log.warning(
                        "transient runtime error on worker %d shard %d "
                        "(retries left %d): %s",
                        worker, i, transient_left, str(e).splitlines()[0][:120],
                    )
                    time.sleep(self.job.settle_delay_s)
                    continue
                elif kind is not None:
                    # A real CUDA failure of the device, the send()/recv()
                    # <= 0 analogue (server.c:358,421-448), is handled like
                    # an injected one; program errors go to the caller.
                    stage = "device-runtime"
                    metrics.bump("device_runtime_errors")
                else:
                    if errors is not None:
                        errors[i] = e
                        return
                    raise
                log.warning(
                    "worker %d failed during %s of shard %d; reassigning",
                    worker, stage, i,
                )
                if isinstance(e, WorkerWaitTimeout):
                    metrics.bump("heartbeat_timeouts")
                    metrics.event("heartbeat_lapse", worker=worker, shard=i)
                self.table.mark_dead(worker)
                metrics.bump("reassignments")
                metrics.event("worker_dead", worker=worker, stage=stage)
                nxt = self.table.first_live()
                if nxt is None:
                    return
                log.warning("reassigning shard %d to worker %d", i, nxt)
                metrics.event("reassign", shard=i, frm=worker, to=nxt)
                time.sleep(self.job.settle_delay_s)  # server.c:304,391,446
                worker = nxt

    def run_job(
        self, data: np.ndarray, metrics: Metrics | None = None, job_id: str | None = None,
    ) -> np.ndarray:
        """One sort job: partition -> dispatch -> (reassign) -> merge.

        Raises `JobFailedError` if any shard could not complete (every
        worker dead); the scheduler stays usable for the next job.  A
        program error of a shard's attempt propagates once every shard's
        handler has ended.  With ``job.checkpoint_dir`` and a ``job_id``,
        finished shards persist across runs, so a re-run re-sorts only the
        shards that were lost; a store of other data or layout is cleared
        first (`ShardCheckpoint.sync_manifest`).
        """
        data = np.asarray(data)
        if data.dtype.kind == "f":
            # Workers, the store and the host merge see ordered uints only.
            return sort_float_keys_via_uint(self.run_job, data, metrics, job_id)
        metrics = metrics if metrics is not None else Metrics()
        if self.flight is not None:
            self.flight.attach(metrics)
        timer = PhaseTimer(metrics)
        w = self.executor.num_workers
        metrics.event(
            "job_start", mode="taskpool", n_keys=len(data), job_id=job_id,
            tenant=self.job.tenant,
        )
        self.table.revive_all()  # server.c:222,278
        ckpt = None
        if self.job.checkpoint_dir and job_id:
            from dsort_tpu_torch.checkpoint import ShardCheckpoint
            from dsort_tpu_torch.models.external_sort import _fingerprint

            ckpt = ShardCheckpoint(self.job.checkpoint_dir, job_id)
            ckpt.journal = metrics.journal
            # A re-run after the file's contents (or the worker count)
            # changed must not serve stale shards.
            if ckpt.sync_manifest(w, data.dtype, len(data), _fingerprint(data)):
                log.warning(
                    "job %r: checkpointed shards belong to different data or layout; "
                    "cleared", job_id,
                )
        with timer.phase("partition"):
            shards = partition(data, w)
        results: list[np.ndarray | None] = [None] * w
        errors: list[BaseException | None] = [None] * w
        with timer.phase("dispatch"):
            threads = [
                threading.Thread(
                    target=self._handle_shard,
                    args=(i, shards[i], results, metrics, ckpt, errors),
                )
                for i in range(w)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for e in errors:
            if e is not None:  # a genuine program error, not a worker death
                raise e
        if any(r is None for r in results):
            metrics.event(
                "job_failed", reason="no live workers remain",
                counters=dict(metrics.counters),
            )
            raise JobFailedError(
                "job failed: no live workers remain "
                f"(completed {sum(r is not None for r in results)}/{w} shards)"
            )
        with timer.phase("merge"):
            out = merge_sorted_host(results)
        metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
        return out


class SpmdScheduler:
    """Whole-mesh SPMD sort with re-form-and-re-run recovery.

    Wraps `parallel.sample_sort.SampleSort` over a `VirtualMesh` of
    ``num_workers`` rows on ``device`` (``cuda`` unless ``cpu`` is asked);
    on a worker failure (injected or surfaced as a classified CUDA error)
    the mesh is re-formed over the surviving workers and the job re-runs
    there — the reference's "reassign the dead worker's chunk to a live
    worker" generalized to losing a mesh participant.
    """

    def __init__(
        self,
        num_workers: int = 8,
        device=None,
        job: JobConfig | None = None,
        injector: FaultInjector | None = None,
        telemetry=None,
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        #: The virtual worker ids; `live` lists and lane keys name these.
        self.devices = list(range(num_workers))
        self.device = resolve_device(device)
        self.job = job or JobConfig()
        self.injector = injector
        #: Optional `obs.Telemetry`: every job's Metrics is tapped into it,
        #: so the live endpoint sees this scheduler's counters, phases and
        #: per-tenant SLO stages.
        self.telemetry = telemetry
        self.table = WorkerTable(len(self.devices), self.job.heartbeat_timeout_s)
        self.flight = _make_flight_recorder(
            self.job,
            lambda: {
                "mode": "spmd",
                "devices": list(self.devices),
                "live": self.table.live_workers(),
            },
        )
        self._sorters: dict[tuple, SampleSort] = {}  # live workers -> SampleSort
        # (lane key, size bucket) combos that completed once: their kernels
        # are built, so later waits drop the compile grace.
        self._warm_waits: set = set()
        # Whole-program lanes, keyed by (tag, live worker ids).  SEPARATE
        # from the per-worker probe lanes: after an in-flight timeout every
        # worker is probed, and a probe queued behind the hung whole-mesh
        # program on a shared lane would time out and falsely kill a healthy
        # worker.  Per-scheduler: a fresh scheduler must not queue behind an
        # abandoned program of a dead one.
        self._mesh_lanes: dict = {}
        self._mesh_lanes_lock = threading.Lock()
        # Outstanding device-resident handles (weakrefs): every re-form
        # invalidates them, and each re-runs on the live mesh at its next
        # use through the hook `sort` attaches.
        self._device_handles: list = []
        #: Callables invoked with the list of newly-dead worker INDEXES on
        #: every mesh re-form.  Listener errors are logged and swallowed:
        #: diagnostics must never break a recovery path.
        self.reform_listeners: list = []

    def _mesh_lane(self, key: tuple) -> _AttemptLane:
        with self._mesh_lanes_lock:
            lane = self._mesh_lanes.get(key)
            if lane is None:
                lane = self._mesh_lanes[key] = _AttemptLane(
                    f"prog-{key[0]}-{len(self._mesh_lanes)}"
                )
            return lane

    def _lane_key(self, tag: str) -> tuple:
        """The default mesh-lane key for ``tag`` — shared by `run_bounded`
        and `lane_stuck_for` so the two can never drift apart."""
        return (tag,) + tuple(self.devices)

    def lane_stuck_for(self, tag: str = "prog") -> float:
        """Seconds ``tag``'s full-mesh lane has been inside its CURRENT
        entry (0.0 when idle or never used): how long an abandoned attempt
        on the whole mesh (a zombie after a lapsed wait) is still running."""
        with self._mesh_lanes_lock:
            lane = self._mesh_lanes.get(self._lane_key(tag))
        return lane.stuck_for() if lane is not None else 0.0

    def _live_devices(self) -> list[int]:
        return [self.devices[i] for i in self.table.live_workers()]

    def _register_handle(self, handle) -> None:
        self._device_handles.append(weakref.ref(handle))

    def _invalidate_handles(self, reason: str, metrics: Metrics) -> None:
        """Invalidate every outstanding device-resident handle; called
        wherever the mesh re-forms.  On one card the buffer outlives a
        virtual worker, but the contract is the reference's: a handle of a
        re-formed mesh re-runs at its next use."""
        live = []
        for ref in self._device_handles:
            h = ref()
            if h is not None and h.valid:
                h.invalidate(reason)
                live.append(h)
        self._device_handles = [r for r in self._device_handles if r() is not None]
        if live:
            metrics.event("device_handle_invalidated", reason=reason, n=len(live))
            log.warning(
                "%d device-resident handle(s) invalidated (%s); they will re-run on "
                "the re-formed mesh at next use", len(live), reason,
            )

    def _notify_reform(self, dead: list[int]) -> None:
        """Tell subscribers which worker indexes a re-form just reaped."""
        for listener in list(self.reform_listeners):
            try:
                listener(list(dead))
            except Exception as e:  # a listener must never break recovery
                log.warning("reform listener failed: %s", e)

    def _probe_device(self, idx: int) -> bool:
        """Tiny bounded round trip for one worker — SPMD's liveness probe.

        The injector's ``"probe"`` point first (a drill's wedged worker),
        then 8 ints up to ``self.device`` and back, on that worker's shared
        `_AttemptLane`, bounded by the heartbeat timeout so a hung device
        counts as dead; stamps the worker table's heartbeat on success.  On
        one card every worker's round trip reaches the same device.
        """
        def probe():
            if self.injector is not None:
                self.injector.check(idx, "probe")
            return self._round_trip()

        box, done, abandoned = _lane_for_device(self.device, idx).submit(probe)
        if not done.wait(timeout=self.job.heartbeat_timeout_s):
            abandoned.set()
            return False
        if "e" in box or not box.get("r"):
            return False
        self.table.heartbeat(idx)
        return True

    def _round_trip(self) -> bool:
        """8 ints up to the card and back: the probes' device call."""
        with device_scope(self.device):
            y = torch.zeros(8, dtype=torch.int32).to(self.device)
            return int(y.cpu().sum()) == 0

    def probe_card(self) -> bool:
        """The card's own liveness: the probe's round trip without any
        worker's injection point, on a lane of its own, bounded by the
        heartbeat timeout.  Every virtual worker lives on this one card, so
        a failed card probe (a sticky CUDA error, a wedged device) means
        every worker is gone; an injected worker loss leaves it healthy."""
        box, done, abandoned = _lane_for_device(self.device, -1).submit(self._round_trip)
        if not done.wait(timeout=self.job.heartbeat_timeout_s):
            abandoned.set()
            return False
        return "e" not in box and bool(box.get("r"))

    def _reap_after_runtime_error(self, live: list[int], metrics: Metrics) -> list[int]:
        """Probe every live worker after a runtime error or a lapsed wait;
        mark the dead.  Returns the newly dead worker indexes (possibly
        empty: a transient fault with every worker healthy)."""
        dead = []
        for i in live:
            ok = self._probe_device(i)
            metrics.event("probe", worker=i, ok=bool(ok))
            if not ok:
                dead.append(i)
        for i in dead:
            self.table.mark_dead(i)
            metrics.event("worker_dead", worker=i, stage="probe")
        # Reap anything whose heartbeat (stamped by probes and successful
        # jobs) has lapsed — the wired-in consumer of the table's stamps.
        for i in self.table.check_heartbeats():
            if i not in dead:
                dead.append(i)
        if dead:
            metrics.bump("device_deaths", len(dead))
        return dead

    @staticmethod
    def _check_cancelled(cancelled: threading.Event | None) -> None:
        """Abandoned-attempt guard before every state-mutating step.

        A lapsed bounded wait abandons its attempt, but the attempt's lane
        thread may still be running (inside a device call that later
        returns).  Checking the cancel event just before each checkpoint
        write means a zombie can never interleave its stale layout (old mesh
        size, old ``n_ranges``) with the live attempt's.  A zombie already
        inside one atomic file write completes that write; the live attempt
        clears leftover ranges before writing its own.
        """
        if cancelled is not None and cancelled.is_set():
            raise AttemptCancelled("attempt abandoned by bounded wait")

    def _local_sort_phase(
        self, data: np.ndarray, ckpt, metrics: Metrics,
        cancelled: threading.Event | None = None,
    ) -> np.ndarray:
        """The local-sort phase, persisted at its boundary: one sorted shard
        per worker of the scheduler (``torch.sort``, `sort_padded`'s default
        kernel, as the reference's ``lax``), or all of them restored
        (``spmd_phase_restores``).  Returns the concatenated sorted shards:
        input for the shuffle, which is order-agnostic."""
        from dsort_tpu_torch.data.partition import pad_to_shards

        done = set(ckpt.completed_shards())
        w = max(len(self.devices), 1)
        shards, counts = pad_to_shards(data, w)
        if done != set(range(w)):
            with device_scope(self.device):
                x = torch.from_numpy(shards).to(self.device)
                c = torch.from_numpy(counts).to(self.device)
                y, _ = sort_padded(to_signed_keys(x), c)
                host = from_signed_keys(y, x.dtype).cpu().numpy()
            for i in range(w):
                if i not in done:
                    self._check_cancelled(cancelled)
                    ckpt.save(i, host[i, : counts[i]])
        else:
            metrics.bump("spmd_phase_restores")
            metrics.event("checkpoint_restore", kind="local_sort_phase", n=w)
        return np.concatenate([ckpt.load(i) for i in range(w)])

    def _shuffle_with_range_checkpoint(
        self, work: np.ndarray, ckpt, ss: SampleSort, metrics: Metrics, live: list[int],
        cancelled: threading.Event | None = None, **knobs,
    ) -> np.ndarray:
        """The shuffle phase with one persisted file per key range.

        Each range persists as soon as it is read back, so a loss while the
        ranges are assembled costs only the unfetched ones: the retry
        restores what is on disk and re-sorts just the missing keys
        (`_resume_missing_ranges`), and a re-run with every range on disk
        restores the whole phase (``shuffle_phase_restores``).
        """
        man = ckpt.manifest() or {}
        n_ranges = man.get("n_ranges")
        done = ckpt.completed_ranges()
        if n_ranges is not None and done:
            if len(done) == n_ranges:
                metrics.bump("shuffle_phase_restores")
                metrics.event("checkpoint_restore", kind="shuffle_phase", n=n_ranges)
                return np.concatenate([ckpt.load_range(i) for i in sorted(done)])
            return self._resume_missing_ranges(work, ckpt, ss, done, metrics, cancelled, **knobs)
        outs = ss.sort_ranges(work, metrics, **knobs)
        self._check_cancelled(cancelled)
        # A fresh sort's ranges are views of one buffer in global order:
        # return it rather than concatenating (wrappers around sort_ranges,
        # as the drills have, may return separate arrays).
        base = outs[0].base if outs else None
        if base is not None and all(o.base is base for o in outs) and len(base) == len(work):
            buf = base
        else:
            buf = np.concatenate(outs)
        # Leftover ranges of an abandoned attempt or a torn run may come from
        # another mesh size: drop them before recording this layout.
        ckpt.clear_ranges()
        ckpt.write_manifest(
            man.get("num_shards", len(self.devices)), work.dtype,
            man.get("total", len(work)), fingerprint=man.get("fingerprint"),
            n_ranges=len(outs),
        )
        for i, r in enumerate(outs):
            # Injection point: worker live[i] dies while its range is read
            # back; ranges 0..i-1 are already on disk.
            if self.injector is not None:
                self.injector.check(live[min(i, len(live) - 1)], "assemble")
            self._check_cancelled(cancelled)
            ckpt.save_range(i, r)
        return buf

    def _resume_missing_ranges(
        self, work: np.ndarray, ckpt, ss: SampleSort, done: list[int], metrics: Metrics,
        cancelled: threading.Event | None = None, **knobs,
    ) -> np.ndarray:
        """Re-sort only the keys of the ranges that were lost.

        The missing multiset is rebuilt by value: a key strictly inside a
        persisted range's [min, max] belongs to it; of a key equal to a
        persisted range's bound, (copies in the input) - (copies on disk)
        are missing.  The subset (any length) sorts on the live mesh and
        merges with the persisted ranges on the host; the result persists
        as one range, so the next run of the job restores it whole.  Timed
        as the phases ``resume_subset``, ``resume_sort``, ``resume_merge``
        and ``resume_rewrite``.
        """
        timer = PhaseTimer(metrics)
        with timer.phase("resume_subset"):
            present = [ckpt.load_range(i) for i in sorted(done)]
            nonempty = [r for r in present if len(r)]
            in_present = np.zeros(len(work), bool)
            boundary_vals = set()
            for r in nonempty:
                lo, hi = r[0], r[-1]
                in_present |= (work > lo) & (work < hi)
                boundary_vals.update((lo.item(), hi.item()))
            subset = work[~in_present & ~np.isin(work, list(boundary_vals))]
            parts = [subset]
            for v in boundary_vals:
                missing_v = int((work == v).sum()) - sum(int((r == v).sum()) for r in nonempty)
                if missing_v > 0:
                    parts.append(np.full(missing_v, v, dtype=work.dtype))
            subset = np.concatenate(parts)
        metrics.bump("shuffle_ranges_restored", len(done))
        metrics.bump("shuffle_resort_keys", len(subset))
        metrics.event(
            "checkpoint_restore", kind="shuffle_ranges", n=len(done), resort_keys=len(subset),
        )
        log.warning(
            "shuffle resume: %d/%d ranges restored; re-sorting %d of %d keys",
            len(done), (ckpt.manifest() or {}).get("n_ranges", -1), len(subset), len(work),
        )
        with timer.phase("resume_sort"):  # holds the subset sort's own phases
            sorted_subset = ss.sort(subset, metrics, **knobs)
        with timer.phase("resume_merge"):
            present_concat = np.concatenate(present) if present else subset[:0]
            out = merge_sorted_host([present_concat, sorted_subset])
        if len(out) != len(work):  # the reconstruction must be lossless
            raise JobFailedError(
                f"shuffle resume reconstructed {len(out)} of {len(work)} keys; clearing "
                "the checkpoint and re-running is required"
            )
        # Crash-safe order: a crash mid-rewrite leaves no ranges (a full
        # re-shuffle) or one all-covering range (an empty subset next time).
        self._check_cancelled(cancelled)
        with timer.phase("resume_rewrite"):
            man = ckpt.manifest() or {}
            ckpt.clear_ranges()
            ckpt.save_range(0, out)
            ckpt.write_manifest(
                man.get("num_shards", len(self.devices)), work.dtype,
                man.get("total", len(work)), fingerprint=man.get("fingerprint"), n_ranges=1,
            )
        return out

    def _wait_budget(self, n_keys: int, warm: bool) -> float:
        j = self.job
        b = (
            j.heartbeat_timeout_s
            + j.exec_allowance_floor_s
            + n_keys / j.exec_allowance_keys_per_s
        )
        return b if warm else b + j.compile_grace_s

    def run_bounded(
        self, fn, n_keys: int, tag: str = "prog", lane_key=None, boost: float = 1.0,
        cancel_event: threading.Event | None = None,
    ):
        """Run a whole device program under the bounded-wait discipline.

        ``fn`` runs on a dedicated mesh lane (daemon thread) and the caller
        waits at most `_wait_budget` (heartbeat + size-scaled execution
        allowance + compile grace while this (lane, size bucket) is cold —
        the first launch builds the kernels) times ``boost``.  On lapse the
        attempt is abandoned and `ProgramWaitTimeout` is raised (``.cold``
        says whether the bucket had never completed).  The abandoned
        attempt is not stopped: it runs on to its end on its lane (beside
        the next attempt, on the same card) and its result is dropped; a lapse
        sets ``cancel_event``, which the attempt checks before each write of
        shared state (`_check_cancelled`).  A genuine ``TimeoutError``
        raised *inside* ``fn`` re-raises as itself.
        """
        key = lane_key if lane_key is not None else self._lane_key(tag)
        warm = (key, _size_bucket(n_keys))
        budget = boost * self._wait_budget(n_keys, warm in self._warm_waits)
        box, done, abandoned = self._mesh_lane(key).submit(fn)
        if not done.wait(timeout=budget):
            abandoned.set()
            if cancel_event is not None:
                cancel_event.set()
            err = ProgramWaitTimeout(
                f"in-flight program wait exceeded {budget:.1f}s on {key[0]}"
            )
            err.cold = warm not in self._warm_waits
            raise err
        if "e" in box:
            raise box["e"]
        self._warm_waits.add(warm)
        return box["r"]

    def _try_coded_recovery(self, e: WorkerFailure, live: list[int], metrics: Metrics, data):
        """Coded reconstruction of a failed attempt (`parallel.coded`).

        Returns the full sorted output when the attempt's exchange carried
        a plane (``e.coded_state``) that covers the losses: a local merge of
        a survivor's slots, journaled ``coded_recover`` / ``parity_recover``
        with the ``coded_recoveries`` / ``coded_recovered_keys`` counters.
        Returns None — journaling ``coded_budget_exceeded`` where the
        losses exceed the budget — and the caller re-runs.
        """
        from dsort_tpu_torch.parallel.coded import dead_positions, journal_recovery

        state = getattr(e, "coded_state", None)
        if state is None:
            return None
        if state.n != len(data):
            # The snapshot covers part of the job only: a coded loss inside a
            # checkpoint resume's subset re-sort.  Completing from it would
            # return the subset as the job's output and drop every restored
            # range; the re-run's next attempt resumes correctly instead.
            log.warning(
                "coded snapshot covers %d of %d keys (a resume-subset dispatch); "
                "taking the re-run path", state.n, len(data),
            )
            return None
        positions = dead_positions(e, live)
        rec = journal_recovery(metrics, state, positions)
        if rec is None:
            log.warning(
                "coded recovery over budget (positions %s dead at redundancy=%d); "
                "degrading to the re-run path", sorted(positions), state.redundancy,
            )
            return None
        out, info = rec
        log.warning(
            "coded recovery: %d key(s) of %d dead range(s) reconstructed from the "
            "plane — zero keys re-sorted, zero re-dispatch",
            info["recovered_keys"], len(positions),
        )
        # 8- and 16-bit keys sorted as int32 (`sort_narrow_keys_via_int32`).
        return out.astype(data.dtype, copy=False)

    def sort(
        self,
        data: np.ndarray,
        metrics: Metrics | None = None,
        job_id: str | None = None,
        keep_on_device: bool = False,
        exchange: str | None = None,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ) -> np.ndarray:
        """Whole-mesh sort of a host array; returns the sorted host array.

        ``exchange`` (``alltoall`` | ``ring`` | ``fused`` | ``hier``, default
        `JobConfig.exchange`) selects the shuffle schedule with the SAME
        fault contract: a worker lost mid-ring (between the plan and the
        exchange, `SampleSort.fault_hook`) invalidates the exchange, the
        mesh re-forms over the survivors and the job re-runs there with a
        fresh plan; under ``hier`` the re-form journals the re-planned host
        grouping (``hier_reform``).  ``redundancy`` / ``redundancy_mode``
        (default `JobConfig`'s) run the coded ring: a loss the plane covers
        is recovered from the failed attempt's snapshot by a local merge,
        with one ``attempt_start`` and zero keys re-sorted.  ``job_id``
        labels the journal's ``job_start``.  With ``keep_on_device=True``
        the result is a `DeviceSortResult` (integer keys only) under the
        same fault discipline, recovered by re-run (a handle is no host
        snapshot); a later re-form invalidates it and it re-runs on the
        live mesh at its next use.

        With ``job.checkpoint_dir`` and a ``job_id`` the job resumes: its
        local-sort shards and its shuffle ranges persist
        (`checkpoint.ShardCheckpoint`; a store of other data is cleared), a
        retry after a loss re-sorts only the keys of the ranges not yet on
        disk, and a re-run with every range on disk restores them.  A
        device-resident job persists nothing (warned): its recovery is the
        re-run.  Float keys ride as the reference's ordered uints, the
        carrier the store holds.
        """
        data = np.asarray(data)
        if keep_on_device and data.dtype.kind == "f":
            raise TypeError("keep_on_device supports integer keys only; use sort() for floats")
        knobs = _sort_kwargs(exchange, redundancy, redundancy_mode)
        if data.dtype.kind == "f":
            return sort_float_keys_via_uint(self.sort, data, metrics, job_id, **knobs)
        metrics = metrics if metrics is not None else Metrics()
        if self.flight is not None:
            self.flight.attach(metrics)
        if self.telemetry is not None:
            self.telemetry.attach(metrics)
        metrics.event(
            "job_start", mode="spmd", n_keys=len(data), job_id=job_id,
            tenant=self.job.tenant,
        )
        self.table.revive_all()
        ckpt = None
        work = data
        if keep_on_device and self.job.checkpoint_dir and job_id:
            log.warning(
                "keep_on_device skips range checkpointing for job %r: the device-resident "
                "handle re-runs on failure instead of restoring persisted ranges", job_id,
            )
            job_id = None
        if self.job.checkpoint_dir and job_id and len(data):
            from dsort_tpu_torch.checkpoint import ShardCheckpoint
            from dsort_tpu_torch.models.external_sort import _fingerprint

            ckpt = ShardCheckpoint(self.job.checkpoint_dir, job_id)
            ckpt.journal = metrics.journal
            # A reused job_id with other same-length data must not serve stale
            # shards or ranges; a matching manifest keeps its n_ranges record.
            if ckpt.sync_manifest(len(self.devices), data.dtype, len(data), _fingerprint(data)):
                log.warning("job %r: checkpointed state belongs to different data; cleared",
                            job_id)
        transient_retries = 0
        # Counts only healthy-probe WAIT lapses (not generic transient
        # runtime errors): the budget boost grows only when the wait itself
        # proved too short.
        wait_lapses = 0
        while True:
            live = self.table.live_workers()
            if not live:
                metrics.event(
                    "job_failed", reason="no live devices remain",
                    counters=dict(metrics.counters),
                )
                raise JobFailedError("job failed: no live devices remain")
            metrics.event("attempt_start", live=list(live))
            cancelled = threading.Event()

            def attempt(live=live, cancelled=cancelled):
                # The WHOLE attempt — the checkpointed phases, dispatch and
                # the blocking device fetch inside SampleSort — runs on the
                # mesh lane, so a hang anywhere in flight is caught by the
                # bounded wait.  `live` and `cancelled` are bound per
                # attempt: an abandoned attempt that wakes later still runs
                # on its own mesh and writes no checkpoint.
                nonlocal work
                if ckpt is not None:
                    # A full restore (every shuffle range on disk) never
                    # reads `work`: skip the local-sort phase's restore.
                    man0 = ckpt.manifest() or {}
                    full_restore = (
                        man0.get("n_ranges") is not None
                        and len(ckpt.completed_ranges()) == man0["n_ranges"]
                    )
                    if not full_restore:
                        w = self._local_sort_phase(data, ckpt, metrics, cancelled)
                        self._check_cancelled(cancelled)
                        work = w
                # Injection point: a worker lost before dispatch (after the
                # checkpointed local-sort phase).
                if self.injector is not None:
                    for i in live:
                        self.injector.check(i, "spmd")
                key = tuple(live)
                ss = self._sorters.get(key)
                if ss is None:
                    ss = self._sorters[key] = SampleSort(
                        VirtualMesh(len(live), self.device), self.job
                    )
                # Mid-ring injection point: the hook runs between the ring
                # plan and the exchange (SampleSort.fault_hook; after the
                # exchange on a coded dispatch), so a drill can lose a
                # worker with the sorted shards on the device and the
                # schedule planned.
                if self.injector is not None:
                    def ring_hook():
                        # Sweep EVERY live worker and aggregate, so the
                        # raised failure carries every loss of the attempt
                        # (a range's owner and its replica holder both lost
                        # is the coded plane's over-budget case).
                        failed = []
                        for i in live:
                            try:
                                self.injector.check(i, "ring")
                            except WorkerFailure as f:
                                failed.append(f.worker)
                        if failed:
                            err = WorkerFailure(failed[0], "ring")
                            err.workers = failed
                            raise err

                    def straggler_pos():
                        # The injector names a WORKER; SampleSort thinks in
                        # mesh positions.
                        w = self.injector.straggler()
                        return live.index(w) if w in live else None

                    ss.fault_hook = ring_hook
                    ss.straggler_fn = straggler_pos
                    ss.fetch_delay_fn = lambda pos: (
                        self.injector.delay_for(live[pos]) if 0 <= pos < len(live) else 0.0
                    )
                else:
                    ss.fault_hook = ss.straggler_fn = ss.fetch_delay_fn = None
                with device_scope(self.device):
                    if keep_on_device:
                        return ss.sort(work, metrics, keep_on_device=True, **knobs)
                    if ckpt is None:
                        return ss.sort(work, metrics, **knobs)
                    return self._shuffle_with_range_checkpoint(
                        work, ckpt, ss, metrics, live, cancelled, **knobs
                    )

            try:
                out = self.run_bounded(
                    attempt, len(data), tag="spmd",
                    lane_key=("spmd",) + tuple(live),
                    boost=float(2 ** wait_lapses), cancel_event=cancelled,
                )
                for i in live:  # proof of life: the collective completed
                    self.table.heartbeat(i)
                if keep_on_device:
                    # A later re-form invalidates the handle; the hook
                    # re-sorts on whatever mesh is live then.
                    out._rerun = lambda: self.sort(
                        data, metrics=metrics, keep_on_device=True, **knobs
                    )
                    self._register_handle(out)
                metrics.event(
                    "job_done", n_keys=len(data),
                    counters=dict(metrics.counters),
                )
                return out
            except WorkerFailure as e:
                # A sweep (the ring hook) aggregates every tripped worker on
                # `e.workers`; a plain failure names one.
                dead_workers = list(getattr(e, "workers", None) or [e.worker])
                log.warning(
                    "device(s) %s lost; re-forming mesh over %d survivors",
                    dead_workers, len(live) - len(dead_workers),
                )
                for w in dead_workers:
                    self.table.mark_dead(w)
                    metrics.event("worker_dead", worker=w, stage=e.stage)
                metrics.bump("mesh_reforms")
                survivors = len(live) - len(dead_workers)
                metrics.event("mesh_reform", survivors=survivors)
                if (exchange or self.job.exchange) == "hier":
                    # The re-formed mesh re-resolves its host grouping: a
                    # lost worker re-forms within its host; a lost host
                    # re-plans the legs on the largest divisor the survivors
                    # support, or downgrades to the flat ring.  Journaled
                    # before the re-run, so the decision shows.
                    before = resolve_hier_hosts(self.job.hier_hosts, len(live))
                    after = resolve_hier_hosts(self.job.hier_hosts, survivors)
                    metrics.event(
                        "hier_reform", survivors=survivors, hosts_before=before,
                        hosts_after=after, downgraded=after < 2,
                    )
                self._invalidate_handles("mesh_reform", metrics)
                self._notify_reform(dead_workers)
                # A coded attempt's survivors already hold the dead ranges:
                # recover by a local merge instead of looping into the re-run.
                if not keep_on_device:
                    out = self._try_coded_recovery(e, live, metrics, data)
                    if out is not None:
                        metrics.event(
                            "job_done", n_keys=len(data), counters=dict(metrics.counters),
                        )
                        return out
                time.sleep(self.job.settle_delay_s)
            except ProgramWaitTimeout as e:
                # The in-flight wait lapsed: probe every worker to find the
                # wedged ones; with all healthy it was a host-side stall —
                # retry a bounded number of times with a doubled budget.
                metrics.bump("spmd_wait_timeouts")
                metrics.event("heartbeat_lapse", kind="spmd_wait")
                dead = self._reap_after_runtime_error(live, metrics)
                if dead:
                    log.warning(
                        "in-flight wait timed out (%s); devices %s dead, "
                        "re-forming mesh over %d survivors",
                        e, dead, len(live) - len(dead),
                    )
                    metrics.bump("mesh_reforms")
                    metrics.event("mesh_reform", survivors=len(live) - len(dead))
                    self._invalidate_handles("mesh_reform", metrics)
                    self._notify_reform(dead)
                elif transient_retries < self.job.max_transient_retries:
                    transient_retries += 1
                    wait_lapses += 1
                    metrics.bump("transient_retries")
                    metrics.event("transient_retry", kind="spmd_wait")
                    log.warning(
                        "in-flight wait timed out with all devices healthy "
                        "(retry %d/%d): %s",
                        transient_retries, self.job.max_transient_retries, e,
                    )
                else:
                    raise
                time.sleep(self.job.settle_delay_s)
            except Exception as e:
                # A *real* runtime failure (one exception for the whole
                # mesh).  Program errors propagate; device and transient
                # errors probe to find which worker died, and with every
                # worker healthy retry a bounded number of times.
                if classify_runtime_error(e) is None:
                    raise
                metrics.bump("device_runtime_errors")
                dead = self._reap_after_runtime_error(live, metrics)
                if dead:
                    log.warning(
                        "runtime error (%s); devices %s dead, re-forming "
                        "mesh over %d survivors",
                        str(e).splitlines()[0][:120], dead, len(live) - len(dead),
                    )
                    metrics.bump("mesh_reforms")
                    metrics.event("mesh_reform", survivors=len(live) - len(dead))
                    self._invalidate_handles("mesh_reform", metrics)
                    self._notify_reform(dead)
                elif transient_retries < self.job.max_transient_retries:
                    transient_retries += 1
                    metrics.bump("transient_retries")
                    metrics.event("transient_retry", kind="runtime_error")
                    log.warning(
                        "transient runtime error with all devices healthy "
                        "(retry %d/%d): %s",
                        transient_retries, self.job.max_transient_retries,
                        str(e).splitlines()[0][:120],
                    )
                else:
                    raise
                time.sleep(self.job.settle_delay_s)
