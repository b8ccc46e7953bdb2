"""Failure types, CUDA error classification and fault injection.

Counterpart of ``dsort_tpu/scheduler/fault.py``: the failure types and
`FaultInjector` are the reference's own (host code); the classifier reads
CUDA errors where the reference reads XLA status prefixes.

The reference has no built-in fault injection — its fault tolerance was
evidently validated by externally ``kill -9``-ing a client process.  Here
injection is a first-class hook (BASELINE config #5): kill a worker
permanently, or trip a one-shot failure at a chosen point of the exchange
(before dispatch / during send / during recv — the reference's two detection
sites, ``server.c:358`` and ``server.c:421``).
"""

from __future__ import annotations

import threading

import torch

from dsort_tpu_torch.ops.errors import (
    KernelLaunchError,
    cuda_error_name,
    cuda_error_name_of_text,
)


class WorkerFailure(RuntimeError):
    """A worker died mid-exchange — the ``send()/recv() <= 0`` analogue."""

    def __init__(self, worker: int, stage: str = "exchange"):
        super().__init__(f"worker {worker} failed during {stage}")
        self.worker = worker
        self.stage = stage


class ProgramWaitTimeout(TimeoutError):
    """The bounded in-flight program wait lapsed (SPMD/fused hang detection).

    A dedicated subclass so recovery never conflates it with a genuine
    ``TimeoutError``/``socket.timeout`` raised *inside* the attempt (e.g.
    checkpoint IO on a network filesystem) — those propagate as ordinary
    errors instead of triggering device probes.
    """


class WorkerWaitTimeout(TimeoutError):
    """A per-shard attempt's heartbeat wait lapsed (taskpool hang detection).

    The taskpool counterpart of `ProgramWaitTimeout`: only THIS type means
    "the worker hung" and triggers reassignment; a genuine ``TimeoutError``
    raised inside the attempt surfaces through the ordinary error path.
    """


class AttemptCancelled(RuntimeError):
    """Raised inside an abandoned attempt at its next cancellation check.

    After a bounded wait lapses, the stale attempt may still be running on
    its lane; every state-mutating step (checkpoint writes, shared-variable
    assignment) first checks the cancel event so a late-waking zombie cannot
    interleave writes with the re-formed mesh's live attempt.
    """


class JobFailedError(RuntimeError):
    """No live workers remain; the job fails cleanly, the cluster survives.

    The reference's equivalent silently skips the merge and re-prompts
    (``server.c:265-268`` gate after ``pthread_exit`` at ``server.c:387-390``);
    we surface it as an exception instead of silence.
    """


#: What each CUDA status means for recovery: ``enum name -> (kind, reason)``.
#: Deliberately a conservative allowlist, as the reference's
#: ``_DEVICE_ERROR_PREFIXES`` is: only statuses that name the hardware or its
#: system software count as ``"device"``; a status this table does not list is a
#: program error, so a program bug never passes for device death.
#:
#: No CUDA status plays the role of XLA's ``CANCELLED`` (work cancelled
#: because a sibling failed): CUDA reports no secondary cancellation, and
#: after a failed kernel the context is poisoned, so every later call
#: returns the same sticky status.  ``"transient"`` therefore names no
#: status here; the classifier still returns it for any entry marked so, and
#: the scheduler's probe-then-decide path for it stays.
CUDA_ERROR_KINDS: dict[str, tuple[str | None, str]] = {
    # Program errors (None): the job's own fault, which a smaller mesh
    # would meet again.
    "cudaErrorMemoryAllocation": (
        None, "out of memory: a mesh of fewer workers holds more keys each and "
              "would only fail harder (the reference's RESOURCE_EXHAUSTED rule)"),
    "cudaErrorInvalidValue": (
        None, "an argument the entry refused, e.g. a shape outside a kernel's range"),
    "cudaErrorInvalidConfiguration": (
        None, "a launch shape the device cannot run: the program chose it"),
    "cudaErrorAssert": (
        None, "a device-side assert: the program's own check failed"),
    "cudaErrorIllegalAddress": (
        None, "an access outside an allocation: an indexing bug of the program"),
    "cudaErrorMisalignedAddress": (
        None, "a misaligned load or store: a layout bug of the program"),
    # Device errors: the hardware or its system software failed under the job.
    "cudaErrorECCUncorrectable": ("device", "an uncorrectable ECC error in device memory"),
    "cudaErrorNvlinkUncorrectable": ("device", "an uncorrectable NVLink error"),
    "cudaErrorNoDevice": ("device", "no device is visible: it left the bus"),
    "cudaErrorDevicesUnavailable": (
        "device", "the device is busy or unavailable to this process"),
    "cudaErrorSystemNotReady": ("device", "the system's CUDA services are not running"),
    "cudaErrorLaunchTimeout": ("device", "the watchdog killed a kernel that stopped returning"),
    "cudaErrorLaunchFailure": (
        "device", "an unspecified launch failure: the kernel was lost mid-run"),
}


def _cuda_error_name(exc: BaseException) -> str | None:
    """The CUDA status an exception carries: from the ``cudaError_t`` code
    where it has one (`KernelLaunchError`), else from the
    ``cudaGetErrorString`` text after a ``CUDA error:`` prefix (how
    ``torch.AcceleratorError`` and PyTorch's ``RuntimeError`` report it)."""
    if isinstance(exc, KernelLaunchError):
        return exc.name
    code = getattr(exc, "error_code", None)
    if isinstance(exc, torch.AcceleratorError) and isinstance(code, int):
        return cuda_error_name(code)
    msg = str(exc).lstrip()
    if not msg.startswith("CUDA error:"):
        return None
    return cuda_error_name_of_text(msg[len("CUDA error:"):].splitlines()[0])


def classify_runtime_error(exc: BaseException) -> str | None:
    """Classify a CUDA runtime error: ``"device"`` | ``"transient"`` | None.

    Used by the scheduler to route *real* runtime failures (not just the
    test injector's `WorkerFailure`) into recovery.  Recognised: a
    `KernelLaunchError` (by its ``.code``), ``torch.AcceleratorError`` and a
    ``RuntimeError`` whose message starts with ``CUDA error:``; the status
    is looked up in `CUDA_ERROR_KINDS`:

    - ``"device"``: the device/runtime itself died — mark dead and re-form
      the mesh;
    - ``"transient"``: retry after probing (no CUDA status is one; see
      `CUDA_ERROR_KINDS`);
    - ``None``: a genuine program error — propagates to the caller.
      ``torch.OutOfMemoryError`` and every other exception type are None.
    """
    if isinstance(exc, torch.OutOfMemoryError) or not isinstance(exc, RuntimeError):
        return None
    name = _cuda_error_name(exc)
    if name is None:
        return None
    return CUDA_ERROR_KINDS.get(name, (None, ""))[0]


def is_device_runtime_error(exc: BaseException) -> bool:
    """True iff ``exc`` is a runtime error that signals outright device loss."""
    return classify_runtime_error(exc) == "device"


class FaultInjector:
    """Programmable failure source, threaded through the executor.

    - `kill(worker)`: permanent — every subsequent exchange on that worker
      fails (the ``kill -9`` experiment from SURVEY.md §0).
    - `fail_once(worker, stage)`: one-shot — the next exchange at ``stage``
      ("send" | "sort" | "recv") on that worker fails, then the worker works
      again (models a transient drop; the reference would also re-detect a
      revived-then-dead worker this way via its per-job revival).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._killed: set[int] = set()
        self._one_shots: dict[tuple[int, str], int] = {}
        self._hangs: dict[tuple[int, str], float] = {}
        self._slow: dict[int, float] = {}
        self._sequence: list[tuple[int, str]] = []
        self.trips = 0

    def kill(self, worker: int) -> None:
        with self._lock:
            self._killed.add(worker)

    def revive(self, worker: int) -> None:
        with self._lock:
            self._killed.discard(worker)

    def fail_once(self, worker: int, stage: str = "send", times: int = 1) -> None:
        with self._lock:
            self._one_shots[(worker, stage)] = (
                self._one_shots.get((worker, stage), 0) + times
            )

    def fail_sequence(self, entries) -> None:
        """Ordered multi-trip injection: ``entries`` is a list of
        ``(worker, stage)`` pairs that trip strictly IN ORDER — a `check`
        matching the current head consumes it and raises; the next entry
        arms immediately, so one sweep of checks over the mesh (the coded
        ring hook) can trip several losses in a single attempt, and a later
        attempt's sweep continues from wherever the sequence stands
        (re-armed per attempt).  This is how a drill injects a SECOND loss
        in the same job — e.g. killing both a range's owner and its replica
        holder to drive the coded plane's over-budget fallback."""
        with self._lock:
            self._sequence.extend(
                (int(w), str(s)) for w, s in entries
            )

    def hang_once(self, worker: int, stage: str = "sort", seconds: float = 3600.0) -> None:
        """Next exchange at ``stage`` stalls for ``seconds`` — models the hung
        worker the reference can never detect (SURVEY.md §5.3)."""
        with self._lock:
            self._hangs[(worker, stage)] = seconds

    def slow(self, worker: int, seconds: float) -> None:
        """Mark ``worker`` live-but-slow: its owner-side fetches take
        ``seconds`` of extra latency (the straggler drill — no failure is
        injected; the coded plane's straggler-first serving races the
        delayed fetch against an off-device reconstruction).  Clear with
        ``slow(worker, 0)``."""
        with self._lock:
            if seconds > 0:
                self._slow[int(worker)] = float(seconds)
            else:
                self._slow.pop(int(worker), None)

    def delay_for(self, worker: int) -> float:
        """Extra fetch latency `slow` assigned to ``worker`` (0.0 when
        healthy) — `SampleSort.fetch_delay_fn`'s injector binding."""
        with self._lock:
            return self._slow.get(int(worker), 0.0)

    def straggler(self) -> int | None:
        """The slowest currently-marked worker, or None — the injector's
        `SampleSort.straggler_fn` binding (a real deployment binds the
        health plane's measured verdict instead, `obs.health`)."""
        with self._lock:
            if not self._slow:
                return None
            return max(self._slow, key=self._slow.get)

    def check(self, worker: int, stage: str) -> None:
        """Raise WorkerFailure (or stall) if an injected fault applies here."""
        with self._lock:
            hang = self._hangs.pop((worker, stage), None)
            if hang is not None:
                # Count the trip under the lock (`trips` is read by racing
                # drill assertions; int += is not atomic — DS201) but stall
                # OUTSIDE it: a hang injection must wedge only its own
                # worker, not every thread touching the injector (DS202).
                self.trips += 1
            elif worker in self._killed:
                self.trips += 1
                raise WorkerFailure(worker, stage)
            else:
                left = self._one_shots.get((worker, stage), 0)
                if left > 0:
                    self._one_shots[(worker, stage)] = left - 1
                    self.trips += 1
                    raise WorkerFailure(worker, stage)
                if self._sequence and self._sequence[0] == (worker, stage):
                    self._sequence.pop(0)
                    self.trips += 1
                    raise WorkerFailure(worker, stage)
        if hang is not None:
            import time

            time.sleep(hang)
