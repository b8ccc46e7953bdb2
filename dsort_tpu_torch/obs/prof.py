"""Performance introspection: the first-call ledger and the memwatch tap.

Counterpart of ``dsort_tpu/obs/prof.py``.  The reference times every jit
build (``lower().compile()``) and records XLA's cost and memory analysis
per variant.  On the card there is no compile to time: a variant is a
host function over kernels built once per process (`ops._build`).  What a
variant pays the first time it runs on a stream — the kernels' library
load, the launch attributes set on first use, the caching allocator's
growth — is what a prewarm moves ahead of traffic, so that first call is
what this ledger records:

- **`CompileLedger`** (`LEDGER`): a process-wide table keyed by the same
  variant labels as the reference's (`variant_label` of the variant
  cache's keys), fed one ``variant_compiled`` event per first call with
  the reference's field set (`LEDGER_EVENT_FIELDS`).  ``compile_s`` is
  the first call's wall time with its stream synchronized;
  ``argument_hbm_bytes`` / ``output_hbm_bytes`` are the bytes of the
  tensors it took and returned; ``bytes_accessed`` their sum (each input
  read once, each output written once); ``peak_hbm_bytes`` the arguments
  plus the allocator's peak growth over the call (`torch.cuda.
  max_memory_allocated` against `memory_allocated` before it) when the
  call raised the device's peak, else arguments plus output, a lower
  bound; ``temp_hbm_bytes`` the peak less arguments and output.  ``flops``
  is None: without a compiler's cost analysis the card reports no
  operation count.  Events drain into whichever job's `Metrics` comes by
  (`CompileLedger.drain_to`) and render as ``/metrics`` gauges.
- **`instrument_first_call`**: wraps a variant so its first call per
  (argument shapes and dtypes, device, current stream) is timed and
  recorded; later calls pay one dict lookup.  The instrument never fails
  a sort: a statistics error is logged and the call's result stands.
- **`MemWatch`**: an event tap (``hbm_watermark`` at every phase
  boundary) reading `torch.cuda.memory_stats` on the card and, on the
  CPU, the bytes of the live tensors (`device_memory_snapshot`).
"""

from __future__ import annotations

import gc
import re
import threading
import time
import warnings

import torch

from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("obs.prof")

#: Fields every ``variant_compiled`` event carries (the reference's schema).
LEDGER_EVENT_FIELDS = (
    "variant",
    "compile_s",
    "flops",
    "bytes_accessed",
    "peak_hbm_bytes",
    "temp_hbm_bytes",
    "output_hbm_bytes",
    "argument_hbm_bytes",
)

#: (metric name, ledger field) of each ``/metrics`` gauge the ledger
#: exports, as the reference's; a None field renders no sample.
LEDGER_GAUGES = (
    ("dsort_variant_compile_seconds", "compile_s"),
    ("dsort_variant_compiles", "compiles"),
    ("dsort_variant_flops", "flops"),
    ("dsort_variant_peak_hbm_bytes", "peak_hbm_bytes"),
)

_HBM_FIELDS = ("peak_hbm_bytes", "temp_hbm_bytes", "output_hbm_bytes", "argument_hbm_bytes")


def _new_entry(label: str) -> dict:
    return {
        "variant": label,
        "compiles": 0,
        "compile_s": 0.0,
        "flops": None,
        "bytes_accessed": 0.0,
        "peak_hbm_bytes": 0,
        "temp_hbm_bytes": 0,
        "output_hbm_bytes": 0,
        "argument_hbm_bytes": 0,
    }


def _fold(entry: dict, event: dict) -> None:
    """Fold one ``variant_compiled`` event into an aggregate entry — the
    one rule `CompileLedger.record` and `ledger_from_journal` share.
    Seconds accumulate; the byte and operation figures describe one call,
    so repeats take the max.  A None figure (not measurable) leaves the
    entry as it is."""
    entry["compiles"] += 1
    entry["compile_s"] = round(entry["compile_s"] + float(event.get("compile_s", 0.0)), 6)
    for f in ("flops", "bytes_accessed"):
        v = event.get(f)
        if v is not None:
            entry[f] = max(entry[f] or 0.0, float(v))
    for f in _HBM_FIELDS:
        v = event.get(f)
        if v is not None:
            entry[f] = max(entry[f], int(v))


_SAFE = re.compile(r"[^A-Za-z0-9._|-]")


def variant_label(key) -> str:
    """The ledger's string form of a variant key tuple, as the
    reference's: ``"fused|81920|int32|auto"`` (nested tuples flatten with
    ``-``; any character outside ``[A-Za-z0-9._|-]`` becomes ``_``, so the
    label is safe inside a Prometheus label value)."""
    if isinstance(key, str):
        return key

    def part(p):
        if isinstance(p, (tuple, list)):
            return "-".join(part(q) for q in p)
        return _SAFE.sub("_", str(p))

    return "|".join(part(p) for p in key)


class CompileLedger:
    """Process-wide ledger of first calls, keyed by variant label.

    `record` aggregates per variant (a prewarm runs a rung once per slice
    stream: calls count up, seconds sum, byte figures take the max) and
    queues one ``variant_compiled`` event per call; `drain_to` journals
    the queued events through the first recording `Metrics` that comes by.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._pending: list[dict] = []

    def record(self, key, compile_s: float, flops=None, bytes_accessed=None,
               argument: int = 0, output: int = 0, temp: int = 0, peak: int = 0) -> dict:
        label = variant_label(key)
        event = {
            "variant": label,
            "compile_s": round(float(compile_s), 6),
            "flops": flops,
            "bytes_accessed": None if bytes_accessed is None else float(bytes_accessed),
            "peak_hbm_bytes": int(peak),
            "temp_hbm_bytes": int(temp),
            "output_hbm_bytes": int(output),
            "argument_hbm_bytes": int(argument),
        }
        with self._lock:
            e = self._entries.get(label)
            if e is None:
                e = self._entries[label] = _new_entry(label)
            _fold(e, event)
            self._pending.append(event)
        return event

    def drain_to(self, metrics) -> int:
        """Journal queued calls through ``metrics`` (a no-op when it has
        neither a journal nor taps: the events stay queued for one that
        records)."""
        if metrics is None or (metrics.journal is None and not metrics.taps):
            return 0
        with self._lock:
            pending, self._pending = self._pending, []
        for ev in pending:
            metrics.bump("variant_compiles")
            metrics.event("variant_compiled", **ev)
        return len(pending)

    def snapshot(self) -> dict[str, dict]:
        """Aggregated per-variant rows (the ``/metrics`` gauge source)."""
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def reset(self) -> None:
        """Drop all state (tests; a process serves one trajectory)."""
        with self._lock:
            self._entries.clear()
            self._pending.clear()


#: The process-wide ledger every instrumented variant records into.
LEDGER = CompileLedger()


def ledger_from_journal(records: list[dict]) -> dict[str, dict]:
    """Replay ``variant_compiled`` events into `CompileLedger.snapshot`'s
    shape — the scrape == journal ground truth."""
    out: dict[str, dict] = {}
    for r in records:
        if r.get("type") != "variant_compiled":
            continue
        label = str(r.get("variant", "?"))
        e = out.get(label)
        if e is None:
            e = out[label] = _new_entry(label)
        _fold(e, r)
    return out


# -- the instrumented first call ----------------------------------------------


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _arg_spec(a):
    """One argument's specialization: shape, dtype, device for a tensor;
    the type alone for a scalar (a row's count varies per job and must not
    make each job a first call)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), str(a.device))
    return ("scalar", type(a).__name__)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class LedgeredCall:
    """A variant whose first call per (argument spec, current stream) is
    timed and recorded into the ledger under ``key_fn(*args)``."""

    def __init__(self, fn, key_fn, ledger: CompileLedger | None = None):
        self._fn = fn
        self._key_fn = key_fn
        self._ledger = ledger if ledger is not None else LEDGER
        self._lock = threading.Lock()
        self._seen: set = set()

    def __call__(self, *args):
        ts = _tensors(args)
        dev = ts[0].device if ts else torch.device("cpu")
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        spec = (tuple(_arg_spec(a) for a in args),
                None if stream is None else stream.cuda_stream)
        with self._lock:
            first = spec not in self._seen
        if not first:
            return self._fn(*args)
        a0 = p0 = 0
        if stream is not None:
            stream.synchronize()
            a0 = torch.cuda.memory_allocated(dev)
            p0 = torch.cuda.max_memory_allocated(dev)
        t0 = time.perf_counter()
        out = self._fn(*args)
        if stream is not None:
            stream.synchronize()
        dt = time.perf_counter() - t0
        try:
            arg_b, out_b = _nbytes(ts), _nbytes(_tensors(out))
            peak = arg_b + out_b
            if stream is not None:
                p1 = torch.cuda.max_memory_allocated(dev)
                if p1 > p0:
                    peak = max(peak, arg_b + p1 - a0)
            self._ledger.record(
                self._key_fn(*args), dt, None, arg_b + out_b, argument=arg_b,
                output=out_b, temp=max(peak - arg_b - out_b, 0), peak=peak,
            )
        except Exception as e:  # the instrument must never fail a sort
            log.warning("first-call instrumentation failed: %s", e)
        with self._lock:
            self._seen.add(spec)
        return out


def instrument_first_call(fn, key_fn) -> LedgeredCall:
    """Wrap a variant so its first call per argument spec and stream lands
    in the process ledger.  ``key_fn(*call_args) -> tuple`` builds the
    variant key (the variant cache's)."""
    return LedgeredCall(fn, key_fn, LEDGER)


# -- memwatch: device-memory watermarks at phase boundaries --------------------


def device_memory_snapshot(device=None) -> dict:
    """Bytes resident on the device now.

    On the card (``device`` None with CUDA present, or a CUDA device):
    `torch.cuda.memory_stats` — bytes allocated now and the allocator's
    peak.  On the CPU: the summed storage bytes of every live tensor (the
    reference's ``jax.live_arrays`` fallback), with no peak.
    """
    dev = torch.device(device) if device is not None else None
    if dev is None:
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        stats = torch.cuda.memory_stats(idx)
        used = int(stats.get("allocated_bytes.all.current", 0))
        return {
            "bytes_in_use": used,
            "max_device_bytes": used,
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "devices": 1,
            "source": "memory_stats",
        }
    seen, total = set(), 0
    with warnings.catch_warnings():  # deprecated module proxies warn on type checks
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
                    st = obj.untyped_storage()
                    if st.data_ptr() not in seen:
                        seen.add(st.data_ptr())
                        total += st.nbytes()
            except Exception:  # a tensor freed or opaque mid-iteration
                continue
    return {
        "bytes_in_use": int(total),
        "max_device_bytes": int(total),
        "peak_bytes": 0,
        "devices": 1,
        "source": "live_tensors",
    }


class MemWatch:
    """Event tap emitting ``hbm_watermark`` at every phase boundary
    (``phase_start`` / ``phase_end``).  The nested event re-enters the tap
    list with a type this tap ignores, so there is no recursion."""

    def __init__(self, snapshot_fn=None):
        self._snapshot = snapshot_fn or device_memory_snapshot

    def attach(self, metrics) -> None:
        if self not in metrics.taps:
            metrics.taps.append(self)

    def observe(self, etype: str, fields: dict, mono: float, metrics) -> None:
        if etype not in ("phase_start", "phase_end"):
            return
        try:
            snap = self._snapshot()
        except Exception as e:  # diagnostics must never fail the job
            log.warning("memwatch snapshot failed: %s", e)
            return
        metrics.bump("hbm_watermarks")
        metrics.event(
            "hbm_watermark",
            phase=fields.get("phase", "?"),
            edge="start" if etype == "phase_start" else "end",
            **snap,
        )
