"""Job scheduling, liveness, and reassign-on-failure fault tolerance."""

from dsort_tpu_torch.scheduler.liveness import WorkerState, WorkerTable  # noqa: F401
from dsort_tpu_torch.scheduler.fault import (  # noqa: F401
    AttemptCancelled,
    FaultInjector,
    JobFailedError,
    ProgramWaitTimeout,
    WorkerWaitTimeout,
    WorkerFailure,
)
from dsort_tpu_torch.scheduler.scheduler import (  # noqa: F401
    DeviceExecutor,
    Scheduler,
    SpmdScheduler,
)
