"""Fleet wire protocol: length-prefixed JSON frames.

Counterpart of ``dsort_tpu/fleet/proto.py``, byte for byte on the wire:
the same header and payload make the same frame in either package, so a
controller of one package routes over agents of the other.  The
controller (pure control plane, no torch) and the execution agents (each
a `serve.SortService` on the card) speak over TCP in framed JSON:

    [4-byte big-endian header length][UTF-8 JSON header][payload bytes]

The header is a dict whose ``type`` must be registered in `FRAME_TYPES`
and whose ``payload_len`` names the raw byte tail.  Key arrays ride the
payload as raw bytes with dtype/shape in the header (`encode_array` /
`decode_array`), so a million-key job never round-trips through base64
or JSON numbers.

This module is pure (stdlib + numpy): both ends import it, and the
controller side never imports torch.  The capacity-ladder helpers
(`fused_rung`, `variant_label_of_key`) are torch-free twins of
`models.pipelines.pad_rung` and `obs.prof.variant_label`, equality pinned
in ``tests/test_torch_fleet.py``, so the controller computes a job's
variant-cache locality key without importing the sort path.
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np

#: Hard bound on one frame's payload: a corrupt length prefix must fail
#: loudly, not allocate gigabytes.
MAX_FRAME_BYTES = 1 << 31
#: Headers are small JSON — a stray client's random 4-byte prefix must
#: raise immediately, never buffer gigabytes waiting for a "header".
MAX_HEADER_BYTES = 1 << 20

#: Byte budget for one serialized ``telemetry`` frame header (the health
#: plane's delta stream).  A long-running agent accumulates waits, compile
#: events and variant keys without bound; the heartbeat plane must not —
#: `bounded_frame` evicts oldest-first until the frame fits.
TELEMETRY_BYTE_BUDGET = 6144
#: Bound on the variant/ledger keys an agent advertises per heartbeat —
#: eviction oldest-first (the advertisement keeps the MOST RECENTLY used
#: rungs, which is exactly what locality routing wants).
MAX_ADVERTISED_VARIANTS = 48

#: THE frame-type registry (controller <-> agent).  Direction noted C->A /
#: A->C; every frame carries ``type`` plus the fields listed.
FRAME_TYPES: dict[str, str] = {
    "hello": "C->A: controller (re)attaches (controller_id, known_jobs — "
             "journaled fleet job ids the controller believes live here)",
    "welcome": "A->C: registration reply (agent_id, capacity, big_jobs, "
               "variants — advertised ledger/variant-cache keys, draining, "
               "jobs: {job_id: running|done|failed|unknown} for known_jobs)",
    "ping": "C->A: heartbeat request",
    "heartbeat": "A->C: live state (queued, in_flight, draining, variants, "
                 "capacity)",
    "submit": "C->A: dispatch one job (job_id, tenant, label, dtype, shape "
              "+ the key payload bytes)",
    "accepted": "A->C: the agent's local admission accepted the job "
                "(job_id)",
    "rejected": "A->C: the agent's local admission refused the job "
                "(job_id, reason) — the controller re-routes it",
    "result": "A->C: one finished job (job_id, ok, dtype/shape + sorted "
              "payload bytes on ok; reason on failure); resent on "
              "re-attach until acked",
    "result_ack": "C->A: the result landed durably at the controller; the "
                  "agent may drop its copy (job_id)",
    "drain": "C->A: finish in-flight work, accept no more fleet jobs",
    "bye": "C->A: clean detach (the agent keeps running)",
    "telemetry": "A->C: bounded health-plane delta, piggybacked on the "
                 "heartbeat cadence and on each result (seq, wall, mono + "
                 "delta: phase seconds, queue waits, compile events, skew, "
                 "HBM watermark — the analyzer inputs, streamed live)",
}


class ProtocolError(RuntimeError):
    """A frame violated the wire contract (bad length, type, or JSON)."""


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise on a torn stream; b'' on clean
    EOF at a frame boundary (n read as the length prefix)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if not buf:
                return b""
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock, header: dict, payload: bytes = b"") -> None:
    """Send one frame; ``header['type']`` must be registered."""
    ftype = header.get("type")
    if ftype not in FRAME_TYPES:
        raise ProtocolError(
            f"unregistered frame type {ftype!r}; add it to "
            "dsort_tpu_torch.fleet.proto.FRAME_TYPES"
        )
    head = dict(header)
    head["payload_len"] = len(payload)
    raw = json.dumps(head).encode("utf-8")
    if len(raw) > MAX_HEADER_BYTES or len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError("frame exceeds the header/payload bounds")
    sock.sendall(struct.pack(">I", len(raw)) + raw + payload)


def recv_frame(sock):
    """``(header, payload)`` for the next frame, or ``None`` on clean EOF
    at a frame boundary.  Raises `ProtocolError` on a torn or malformed
    frame — a half-written dispatch must fail loudly, never parse."""
    prefix = _recv_exact(sock, 4)
    if not prefix:
        return None
    (hlen,) = struct.unpack(">I", prefix)
    if not 0 < hlen <= MAX_HEADER_BYTES:
        raise ProtocolError(f"implausible frame header length {hlen}")
    try:
        header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict) or header.get("type") not in FRAME_TYPES:
        raise ProtocolError(f"unregistered frame: {header!r}")
    try:
        plen = int(header.get("payload_len", 0))
    except (TypeError, ValueError, OverflowError) as e:
        # A flipped byte can keep the JSON valid while turning the
        # length into a list/string/inf — typed error, never a crash.
        raise ProtocolError(f"malformed payload_len: {e}") from e
    if not 0 <= plen <= MAX_FRAME_BYTES:
        raise ProtocolError(f"implausible payload length {plen}")
    payload = _recv_exact(sock, plen) if plen else b""
    if plen and len(payload) != plen:
        raise ProtocolError("connection closed mid-payload")
    return header, payload


# -- array payloads ----------------------------------------------------------


def encode_array(a: np.ndarray) -> tuple[dict, bytes]:
    """``(meta, payload)`` for one contiguous array: dtype/shape in the
    header, raw bytes in the payload."""
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def decode_array(meta: dict, payload: bytes) -> np.ndarray:
    try:
        dtype = np.dtype(meta["dtype"])
        shape = tuple(int(s) for s in meta["shape"])
    except (KeyError, TypeError, ValueError, OverflowError) as e:
        raise ProtocolError(f"malformed array meta: {e}") from e
    if any(s < 0 for s in shape):
        # reshape(-1) would INFER a dimension and happily accept a
        # payload of the wrong logical shape.
        raise ProtocolError(f"negative dimension in shape {shape}")
    # math.prod, not np.prod: a corrupt shape must not wrap at int64 and
    # alias a plausible element count.
    n = math.prod(shape) if shape else 1
    if n * dtype.itemsize != len(payload):
        raise ProtocolError(
            f"payload is {len(payload)} bytes but {shape} {dtype} needs "
            f"{n * dtype.itemsize}"
        )
    return np.frombuffer(payload, dtype=dtype).reshape(shape).copy()


# -- capacity-ladder locality keys (pure twins, test-pinned) -----------------

#: Jobs at/over this key count route as BIG (full-mesh/wave agents) — the
#: torch-free twin of ``models.pipelines.FUSED_SMALL_JOB_MAX``.
FLEET_SMALL_JOB_MAX = 1 << 20

#: Controller routing policies (`--routing` / conf ``FLEET_ROUTING``).
#: Lives here (pure constants) so config validation never has to import
#: the controller's socket/threading machinery.  ``health`` routes big
#: jobs around measured stragglers (live telemetry verdicts, obs.health)
#: while keeping locality stickiness for small jobs; ``random`` is the
#: A/B baseline.
ROUTING_POLICIES = ("locality", "random", "health")


def fused_rung(n: int) -> int:
    """The fused path's capacity-ladder rung for an ``n``-key job — the
    torch-free twin of `models.pipelines.pad_rung` (8-aligned
    1/8-power-of-two quantization), equality test-pinned so the controller
    can compute locality keys without importing the jitted pipeline."""
    n = max(int(n), 1)
    step = max(8, 1 << max((n - 1).bit_length() - 3, 0))
    return -(-n // step) * step


def variant_label_of_key(key: tuple) -> str:
    """One cache key tuple -> the flat label agents advertise — the SAME
    ``|``-joined flattening the first-call ledger uses for its journal/metrics
    variant labels (`obs.prof.variant_label`, equality test-pinned), so a
    cache key and its ledger entry advertise as one string."""
    def part(p):
        if isinstance(p, (tuple, list)):
            return "-".join(part(q) for q in p)
        return str(p)

    return "|".join(part(p) for p in key)


def fused_rung_prefix(n_keys: int, dtype_str: str) -> str:
    """The locality-match prefix for an ``n_keys`` job of ``dtype_str``:
    matches every advertised fused variant of the job's ladder rung
    regardless of the agent's local kernel choice."""
    return f"fused|{fused_rung(n_keys)}|{dtype_str}|"


# -- health-plane frame bounds (telemetry deltas + variant adverts) ----------


def clock_pair() -> dict:
    """One ``(wall, mono)`` pair for protocol-level clock sync: ``hello``/
    ``welcome``/``heartbeat``/``telemetry`` frames carry it so each side
    can journal a peer ``clock_sync`` blessing and `obs.merge` aligns
    controller+agent journals by MONOTONIC clocks — no shared journal
    file, no trust in the peers' wall clocks."""
    import time

    return {"wall": round(time.time(), 6), "mono": round(time.monotonic(), 6)}


#: ``(path, field)`` lists `bounded_frame` may evict from, CHEAPEST loss
#: first: recent-wait samples (the exact running sums ride as scalars and
#: are never evicted), then compile events, then advertised variant keys.
_EVICTABLE_LISTS = (
    (("delta", "waits"), "recent wait samples"),
    (("delta", "compiles"), "recent compile events"),
    (("variants",), "advertised variant keys"),
    (("delta", "variants"), "advertised variant keys"),
)


def frame_bytes(header: dict) -> int:
    return len(json.dumps(header).encode("utf-8"))


def bounded_frame(header: dict, budget: int = TELEMETRY_BYTE_BUDGET) -> dict:
    """Bound one telemetry/heartbeat header to ``budget`` serialized bytes.

    Evicts OLDEST-FIRST (list fronts) from the evictable list fields, then
    folds the smallest per-phase seconds into an ``other`` bucket (the
    TOTAL stays exact — only attribution coarsens, and the dominant phase
    is kept by construction).  The common case (already under budget, the
    telemetry hot path) returns the CALLER'S dict untouched after one
    size check; eviction works on a deep copy, so the caller's dict is
    never mutated.  A frame that cannot fit even after eviction is
    returned at its minimum size — `send_frame`'s hard header bound still
    applies.
    """
    if frame_bytes(header) <= budget:
        return header
    head = json.loads(json.dumps(header))

    def _list_at(path):
        node = head
        for p in path[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                return None, None
        lst = node.get(path[-1]) if isinstance(node, dict) else None
        return (node, path[-1]) if isinstance(lst, list) and lst else (None, None)

    for path, _what in _EVICTABLE_LISTS:
        while frame_bytes(head) > budget:
            node, key = _list_at(path)
            if node is None:
                break
            lst = node[key]
            # Oldest first, in chunks so a huge frame converges quickly.
            del lst[: max(1, len(lst) // 4)]
            if not lst:
                del node[key]
                break
        if frame_bytes(head) <= budget:
            return head
    phases = (head.get("delta") or {}).get("phases")
    while (
        frame_bytes(head) > budget
        and isinstance(phases, dict) and len(phases) > 2
    ):
        floor = min(
            (p for p in phases if p != "other"),
            key=lambda p: phases[p],
        )
        phases["other"] = phases.get("other", 0.0) + phases.pop(floor)
    return head


def parse_agent_addrs(spec) -> list[tuple[str, int]]:
    """``"host:port,host:port"`` (or an iterable of such) -> address list."""
    if isinstance(spec, str):
        items = [s for s in spec.split(",") if s.strip()]
    else:
        items = list(spec or ())
    out: list[tuple[str, int]] = []
    for item in items:
        if isinstance(item, (tuple, list)) and len(item) == 2:
            out.append((str(item[0]), int(item[1])))
            continue
        host, sep, port = str(item).strip().rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"agent address {item!r} must be HOST:PORT (e.g. "
                "127.0.0.1:9200)"
            )
        out.append((host, int(port)))
    if not out:
        raise ValueError("no agent addresses given")
    return out
