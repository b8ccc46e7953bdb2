"""Fault flight recorder: a bounded event ring and postmortem bundles.

Counterpart of ``dsort_tpu/obs/flight.py``, bundle key for bundle key.  A
recorder keeps the last ``ring_size`` events of its owner in memory and,
whenever a recovery path fires (`RECOVERY_EVENTS`), dumps a self-contained
bundle to ``JobConfig.flight_recorder_dir``:

```json
{"schema": 1,
 "recovery_path": "mesh_reform",            // which path fired (+ kind)
 "detail":  {...},                          // the triggering event's fields
 "t": 1700000000.0, "mono": 12.5,           // when
 "counters": {"mesh_reforms": 1, ...},      // cumulative cost so far
 "config":  {...},                          // the job's JobConfig, JSON-able
 "state":   {"mode": "spmd", "live": [...]},// the owner's worker state
 "ring":    [{"mono": ..., "type": ..., ...}, ...]}  // the recent past
```

(`BUNDLE_SCHEMA_KEYS` is the schema.)  Wiring is one `attach` per job
`Metrics`: the recorder is an event tap.  On the card the "devices" of a
state are the virtual workers of the mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque

from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("obs.flight")

#: Event types that ARE a recovery path firing: each dump's
#: ``recovery_path`` starts with one of these (``checkpoint_restore``
#: qualifies with its ``kind`` — e.g. ``checkpoint_restore:multihost_partial``
#: is the multi-host crash-retry).
RECOVERY_EVENTS = frozenset(
    {
        "mesh_reform",               # SPMD re-form over survivors
        "device_handle_invalidated", # device-resident handles re-run
        "capacity_retry",            # bucket overflow re-dispatch
        "reassign",                  # taskpool shard moved off a dead worker
        "checkpoint_restore",        # resume instead of re-sort (incl. multihost)
        "fused_fallback",            # fused path failed over to the scheduler
        "transient_retry",           # in-place retry on a healthy mesh
        "job_evicted",               # serving layer evicted a job off a slice
        "coded_recover",             # dead range rebuilt from replica slots
        "parity_recover",            # dead range solved from XOR/P+Q parity
    }
)

#: Top-level keys every bundle carries — the test-enforced schema.
BUNDLE_SCHEMA_KEYS = (
    "schema",
    "recovery_path",
    "detail",
    "t",
    "mono",
    "counters",
    "config",
    "state",
    "ring",
)

BUNDLE_SCHEMA_VERSION = 1


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)


def config_snapshot(job) -> dict:
    """A JobConfig (or any dataclass) as JSON-able key/values."""
    if dataclasses.is_dataclass(job):
        return {
            f.name: _jsonable(getattr(job, f.name))
            for f in dataclasses.fields(job)
        }
    return {"repr": repr(job)}


def recovery_path_name(etype: str, fields: dict) -> str:
    """The bundle's ``recovery_path`` label for one triggering event."""
    kind = fields.get("kind") or fields.get("stage")
    if etype == "checkpoint_restore" and fields.get("kind"):
        return f"{etype}:{fields['kind']}"
    if etype == "mesh_reform" and kind:
        return f"{etype}:{kind}"
    if etype == "coded_recover":
        # The coded plane's bundle name (ARCHITECTURE §14): the recovery
        # was a local reconstruction from replica slots, not a re-run.
        return "coded_reconstruct"
    if etype == "parity_recover":
        # The v2 parity plane (§18): same local posture, but the lost
        # range was SOLVED from XOR/P+Q slots rather than merged from a
        # full replica — named apart so postmortems show which premium
        # actually paid for the recovery.
        return "parity_reconstruct"
    return etype


class FlightRecorder:
    """Bounded ring of recent events + postmortem dumps on recovery paths.

    One per scheduler (`SpmdScheduler`/`Scheduler` build one when
    ``JobConfig.flight_recorder_dir`` is set) and one per `SortService`.  ``state_fn`` supplies the owner's live state (mesh
    membership, mode) at dump time; ``config`` is snapshotted once.
    """

    def __init__(
        self,
        directory: str,
        ring_size: int = 256,
        state_fn=None,
        config=None,
        events: frozenset | None = None,
    ):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._state_fn = state_fn
        self._config = config_snapshot(config) if config is not None else {}
        # Which event types trigger a dump.  The serving layer narrows this
        # to its own eviction events so a job carrying BOTH a scheduler
        # recorder and a service recorder never dumps one recovery twice.
        self._events = RECOVERY_EVENTS if events is None else frozenset(events)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(ring_size), 1))
        self._seq = 0

    def attach(self, metrics) -> None:
        """Tap a job's `Metrics` (idempotent)."""
        if self not in metrics.taps:
            metrics.taps.append(self)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # -- tap protocol ------------------------------------------------------

    def observe(self, etype: str, fields: dict, mono: float, metrics) -> None:
        with self._lock:
            self._ring.append(
                {"mono": round(mono, 6), "type": etype, **fields}
            )
            if etype not in self._events:
                return
            self._seq += 1
            seq = self._seq
            ring = list(self._ring)
        # Dump OUTSIDE the lock: disk IO must never serialize against the
        # hot emit path of a concurrently-recovering scheduler.
        path = self._dump(seq, etype, fields, ring, mono, metrics)
        if path is not None:
            metrics.bump("flight_dumps")
            metrics.event(
                "flight_dump",
                path=os.path.basename(path),
                recovery_path=recovery_path_name(etype, fields),
            )

    # -- bundle IO ---------------------------------------------------------

    def _dump(
        self, seq: int, etype: str, fields: dict, ring: list, mono: float,
        metrics,
    ) -> str | None:
        bundle = {
            "schema": BUNDLE_SCHEMA_VERSION,
            "recovery_path": recovery_path_name(etype, fields),
            "detail": {k: _jsonable(v) for k, v in fields.items()},
            "t": round(time.time(), 6),
            "mono": round(mono, 6),
            "counters": dict(metrics.counters),
            "config": self._config,
            "state": self._state_fn() if self._state_fn is not None else {},
            "ring": ring,
        }
        name = f"flight_{os.getpid()}_{seq:04d}_{etype}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
                f.flush()
                # fsync before the atomic rename: a postmortem bundle
                # exists precisely because something is failing — it must
                # survive the host going down right after, and a reader
                # must never see a torn bundle.
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            # The recorder is a diagnostic surface: a full disk must not
            # take the recovering job down with it.
            log.warning("flight recorder dump failed (%s): %s", name, e)
            return None
        log.warning(
            "flight recorder: postmortem bundle %s (%s)",
            name, bundle["recovery_path"],
        )
        return path

    @staticmethod
    def read_bundles(directory: str) -> list[dict]:
        """All bundles in ``directory``, wall-clock dump order.

        Ordered by each bundle's own ``t`` stamp (filename as tiebreak):
        a shared directory holds bundles from several processes, and the
        pid embedded in the names would otherwise group by process
        instead of by when each recovery actually fired.
        """
        out = []
        for name in sorted(os.listdir(directory)):
            if name.startswith("flight_") and name.endswith(".json"):
                with open(os.path.join(directory, name), encoding="utf-8") as f:
                    rec = json.load(f)
                rec["_file"] = name
                out.append(rec)
        out.sort(key=lambda r: (r.get("t", 0.0), r["_file"]))
        return out
