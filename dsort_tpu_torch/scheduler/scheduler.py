"""`SpmdScheduler`: the whole-mesh sort with re-form-and-re-run recovery.

Counterpart of ``dsort_tpu/scheduler/scheduler.py``'s `SpmdScheduler` (its
task-pool `Scheduler` / `DeviceExecutor` are not ported yet).  A compiled
collective cannot lose a participant mid-flight, so recovery is phrased as
*re-form the mesh over the live workers and re-run*: on a failure the dead
worker is excluded and the job re-dispatched to a `VirtualMesh` of the
survivors.  The reference's semantics are kept:

- failure detected on the exchange itself (an injected `WorkerFailure`, or a
  CUDA error that `fault.classify_runtime_error` names a device error, then
  a probe of every live worker);
- a hang detected too: the whole attempt runs on a daemon lane thread under
  a bounded wait (`run_bounded`); a lapse probes every worker, reaps the
  ones that fail, and re-forms — or, with every probe healthy, retries a
  bounded number of times with a geometrically growing budget;
- all workers dead ⇒ `JobFailedError`, the scheduler survives for the next
  job; per-job optimistic revival of dead workers;
- a journal of all of it through ``Metrics.event`` under the reference's
  event and counter names.

**One card.**  The workers are virtual: worker ``i`` is row ``i`` of the
mesh, and every worker's probe is a round trip to the same card
(``self.device``).  A real device error therefore fails every probe at
once, and the job ends in a clean `JobFailedError`, never in a hang; only
injected faults take out a single virtual worker.  Real per-device
survivors come with a ``torch.distributed`` group of several cards.

Not ported yet, each refused with a "not yet ported" error: device-resident
results (``keep_on_device``), the coded ``redundancy`` plane, the ``hier``
exchange (refused by `SampleSort`) and range checkpoints (``checkpoint_dir``
is refused by `JobConfig.from_dict`).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.device import resolve_device
from dsort_tpu_torch.ops.float_order import is_float_key_dtype, sort_float_keys_via_uint
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.scheduler.fault import (
    FaultInjector,
    JobFailedError,
    ProgramWaitTimeout,
    WorkerFailure,
    classify_runtime_error,
)
from dsort_tpu_torch.scheduler.liveness import WorkerTable
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics

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


def _sort_kwargs(exchange) -> dict:
    """Per-call knob kwargs, omitted when unset: `None` means "JobConfig
    decides" and needs no plumbing — wrappers around SampleSort.sort (fault
    drills monkeypatch it) keep their original signature working."""
    return {} if exchange is None else {"exchange": exchange}


def _device_scope(device: torch.device):
    """Make ``device`` current on the calling (lane) thread, so a kernel
    wrapper's ``current_stream`` never assumes which card is current."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


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
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        #: The virtual worker ids; `live` lists and lane keys name these.
        self.devices = list(range(num_workers))
        self.device = resolve_device(device)
        self.job = job or JobConfig()
        self.injector = injector
        self.table = WorkerTable(len(self.devices), self.job.heartbeat_timeout_s)
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
            with _device_scope(self.device):
                y = torch.zeros(8, dtype=torch.int32).to(self.device)
                return int(y.cpu().sum()) == 0

        box, done, abandoned = _lane_for_device(self.device, idx).submit(probe)
        if not done.wait(timeout=self.job.heartbeat_timeout_s):
            abandoned.set()
            return False
        if "e" in box or not box.get("r"):
            return False
        self.table.heartbeat(idx)
        return True

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
    ):
        """Run a whole device program under the bounded-wait discipline.

        ``fn`` runs on a dedicated mesh lane (daemon thread) and the caller
        waits at most `_wait_budget` (heartbeat + size-scaled execution
        allowance + compile grace while this (lane, size bucket) is cold —
        the first launch builds the kernels) times ``boost``.  On lapse the
        attempt is abandoned and `ProgramWaitTimeout` is raised (``.cold``
        says whether the bucket had never completed).  The abandoned
        attempt is not stopped: it runs on to its end on its lane (beside
        the next attempt, on the same card) and its result is dropped.  A
        genuine ``TimeoutError`` raised *inside* ``fn`` re-raises as itself.
        """
        key = lane_key if lane_key is not None else self._lane_key(tag)
        warm = (key, _size_bucket(n_keys))
        budget = boost * self._wait_budget(n_keys, warm in self._warm_waits)
        box, done, abandoned = self._mesh_lane(key).submit(fn)
        if not done.wait(timeout=budget):
            abandoned.set()
            err = ProgramWaitTimeout(
                f"in-flight program wait exceeded {budget:.1f}s on {key[0]}"
            )
            err.cold = warm not in self._warm_waits
            raise err
        if "e" in box:
            raise box["e"]
        self._warm_waits.add(warm)
        return box["r"]

    def sort(
        self,
        data: np.ndarray,
        metrics: Metrics | None = None,
        job_id: str | None = None,
        keep_on_device: bool = False,
        exchange: str | None = None,
        redundancy: int | None = None,
    ) -> np.ndarray:
        """Whole-mesh sort of a host array; returns the sorted host array.

        ``exchange`` (``alltoall`` | ``ring`` | ``fused``, default
        `JobConfig.exchange`) selects the shuffle schedule with the SAME
        fault contract: a worker lost mid-ring (between the plan and the
        exchange, `SampleSort.fault_hook`) invalidates the exchange, the
        mesh re-forms over the survivors and the job re-runs there with a
        fresh plan.  ``job_id`` labels the journal's ``job_start``.
        ``keep_on_device`` and ``redundancy`` above 1 are not ported yet.
        """
        if keep_on_device:
            raise NotImplementedError(
                "keep_on_device (device-resident results) is not yet ported "
                "to dsort_tpu_torch"
            )
        if redundancy is not None and redundancy != 1:
            raise NotImplementedError(
                "redundancy > 1 (the coded ring exchange) is not yet ported "
                "to dsort_tpu_torch"
            )
        data = np.asarray(data)
        if is_float_key_dtype(data.dtype):
            return sort_float_keys_via_uint(
                self.sort, data, metrics, job_id, exchange=exchange,
            )
        metrics = metrics if metrics is not None else Metrics()
        metrics.event("job_start", mode="spmd", n_keys=len(data), job_id=job_id)
        self.table.revive_all()
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

            def attempt(live=live):
                # The WHOLE attempt — dispatch and the blocking device
                # fetch inside SampleSort — runs on the mesh lane, so a hang
                # anywhere in flight is caught by the bounded wait.  `live`
                # is bound per attempt: an abandoned attempt that wakes
                # later still runs on its own mesh.
                # Injection point: a worker lost before dispatch.
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
                # plan and the exchange (SampleSort.fault_hook), so a drill
                # can lose a worker with the sorted shards on the device and
                # the schedule planned — the exchange is invalidated and the
                # job re-runs on the re-formed mesh.
                if self.injector is not None:
                    def ring_hook():
                        # Sweep EVERY live worker and aggregate, so the
                        # raised failure carries every loss of the attempt.
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

                    ss.fault_hook = ring_hook
                else:
                    ss.fault_hook = None
                with _device_scope(self.device):
                    return ss.sort(data, metrics, **_sort_kwargs(exchange))

            try:
                out = self.run_bounded(
                    attempt, len(data), tag="spmd",
                    lane_key=("spmd",) + tuple(live),
                    boost=float(2 ** wait_lapses),
                )
                for i in live:  # proof of life: the collective completed
                    self.table.heartbeat(i)
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
                metrics.event("mesh_reform", survivors=len(live) - len(dead_workers))
                self._notify_reform(dead_workers)
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
