"""Profiling hooks: a ``torch.profiler`` capture and named host ranges.

Counterpart of ``dsort_tpu/utils/tracing.py``, which wraps
``jax.profiler``.  `profile_trace` captures the host and CUDA activity of
a region (``cli run --profile-dir``) and writes it as one Chrome trace
(``trace.json``, readable by Perfetto or ``chrome://tracing``) into the
directory on exit; `annotate` labels a host range (``PhaseTimer`` wraps
every phase in ``dsort:<phase>``), so the phases line up against the
kernels in that trace.

A capture records every thread of the process while it runs, not only
the one that opened it: the jobs run on scheduler lane and slice threads,
which may have been started before the capture.  So a capture in a process
that runs other work meanwhile holds that work's ranges too.

Off-capture, `annotate` costs nothing: it records a range only while a
`profile_trace` capture is active in this process, and imports nothing.
A capture that cannot start is an error, never a silent no-op.
"""

from __future__ import annotations

import contextlib
import os
import threading

#: The trace file `profile_trace` writes into its directory.
TRACE_NAME = "trace.json"

_ACTIVE = 0  # captures running in this process
_ACTIVE_LOCK = threading.Lock()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace (CPU and, where a card is
    present, CUDA activity) into ``logdir/trace.json`` (None -> no-op)."""
    global _ACTIVE
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # The jobs run on scheduler lane and slice threads: record every thread
    # of the process, not only this one.
    from torch._C._profiler import _ExperimentalConfig

    prof = profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
        acc_events=True,  # one capture, one cycle: nothing to clear
    )
    prof.__enter__()
    with _ACTIVE_LOCK:
        _ACTIVE += 1
    try:
        yield
    finally:
        # A failed job's trace is written too: it shows where the time went.
        with _ACTIVE_LOCK:
            _ACTIVE -= 1
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


@contextlib.contextmanager
def annotate(name: str):
    """Label a host-side region in the trace of an active `profile_trace`.

    Only the range's setup is conditional — exceptions raised by the body
    propagate (a fault-tolerance path relies on ``JobFailedError``
    crossing phase boundaries), so nothing wraps the ``yield`` in a try.
    """
    if not _ACTIVE:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
