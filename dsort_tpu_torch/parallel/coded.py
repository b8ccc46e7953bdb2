"""Coded redundancy plane: survive a worker loss without re-running anything.

Counterpart of ``dsort_tpu/parallel/coded.py``, this package's own copy of
its host side (Coded TeraSort, arXiv:1702.04850).  During the ring exchange
every worker also ships redundancy for its out-buckets to its ring
successors (`exchange._coded_ring_exchange_shard`: full replicas;
`exchange._parity_ring_exchange_shard`: XOR / GF(256) parity), so when a
worker dies its successors already hold what rebuilds its key range.
Recovery is a **local merge** of sorted runs, zero keys re-sorted, zero
re-dispatch:

- `CodedExchangeState`: the post-exchange snapshot a coded dispatch attaches
  to the `WorkerFailure` it re-raises — the survivors' merged ranges plus the
  replica or parity plane, copied to the host (``fetch_s`` records that
  copy).  `reconstruct(dead)` rebuilds every dead position's range with the
  host k-way merge (`ops.merge.merge_sorted_host`); `assemble(dead)`
  concatenates the ranges into the full sorted output;
- `CodedBudgetExceeded`: a dead range's every holder is dead too — the
  caller journals ``coded_budget_exceeded`` and re-runs;
- `dead_positions`: the mesh positions a `WorkerFailure` names;
- `StragglerClaim`: the exactly-once claim of the straggler race.

Keys ride as the device holds them, in their signed carrier
(`ops.float_order.to_signed_keys`), so the parity planes folded on the card
and the host solve see the same bytes (little-endian on both sides);
`assemble` maps its output back to ``key_dtype``.

Simulation note, as in the reference: the plane's placement completes with
the exchange, so the drills inject the loss after the exchange dispatch.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

__all__ = [
    "CodedBudgetExceeded",
    "CodedExchangeState",
    "StragglerClaim",
    "dead_positions",
    "journal_recovery",
    "snapshot_state",
    "snapshot_parity_state",
    "snapshot_kv_state",
    "snapshot_parity_kv_state",
]


# -- GF(256) arithmetic (polynomial 0x11D, generator g = 2) -----------------
#
# The host half of the parity plane: the card folds out-bucket byte rows into
# XOR (RAID P) and Horner ``sum g^k d_k`` (RAID Q) slots
# (`exchange._parity_fold`); these tables solve the one- or two-erasure
# systems.  Exponents are 255-periodic, so two unknown bucket indices equal
# mod 255 (only past P = 255) degrade to the budget-exceeded path.

_GF_EXP = np.zeros(510, np.uint8)
_GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_GF_EXP[255:510] = _GF_EXP[:255]
del _x, _i


def _gf_scale(row: np.ndarray, c: int) -> np.ndarray:
    """Multiply a uint8 byte row by the GF(256) scalar ``c``."""
    if c == 0:
        return np.zeros_like(row)
    if c == 1:
        return row.copy()
    out = np.zeros_like(row)
    nz = row != 0
    out[nz] = _GF_EXP[_GF_LOG[row[nz]] + _GF_LOG[c]]
    return out


def _parity_solve(known_rows: dict, parity: list, unknowns: list) -> dict:
    """Solve one parity group's erasures in byte space.

    ``known_rows`` maps bucket index -> uint8 row, ``parity`` is the group's
    ``[P, Q?]`` planes, ``unknowns`` the (<= 2) missing bucket indices.  One
    unknown needs only the XOR fold; two eliminate through Q: with ``P' = P
    ^ xor(known)`` and ``Q' = Q ^ sum g^k known_k``, ``a = (Q' ^ g^j P') /
    (g^i ^ g^j)`` and ``b = P' ^ a``.
    """
    pprime = parity[0].copy()
    for r in known_rows.values():
        pprime ^= r
    if len(unknowns) == 1:
        return {unknowns[0]: pprime}
    i, j = unknowns
    qprime = parity[1].copy()
    for k, r in known_rows.items():
        qprime ^= _gf_scale(r, int(_GF_EXP[k % 255]))
    gi, gj = int(_GF_EXP[i % 255]), int(_GF_EXP[j % 255])
    inv = int(_GF_EXP[255 - _GF_LOG[gi ^ gj]])
    a = _gf_scale(qprime ^ _gf_scale(pprime, gj), inv)
    return {i: a, j: pprime ^ a}


def _host_sentinel(dtype):
    """Host twin of `ops.local_sort.sentinel_for` (numpy scalar)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return np.array(np.inf, dtype)
    return np.array(np.iinfo(dtype).max, dtype)


def _byte_row(run: np.ndarray, cap: int, pad) -> np.ndarray:
    """One bucket run extended to ``cap`` slots with ``pad``, as its raw
    byte vector — the host twin of `exchange._byte_plane`."""
    full = np.full((cap,) + run.shape[1:], pad, run.dtype)
    full[: len(run)] = run
    return np.ascontiguousarray(full).view(np.uint8).reshape(-1)


class StragglerClaim:
    """Exactly-once claim for one straggler-served range: the owner-fetch
    and reconstruction legs race, and whichever calls `claim` first owns
    the range (one compare-and-set under one lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._winner: str | None = None

    def claim(self, who: str) -> bool:
        with self._lock:
            if self._winner is None:
                self._winner = who
                return True
            return False

    @property
    def winner(self) -> str | None:
        with self._lock:
            return self._winner


class CodedBudgetExceeded(RuntimeError):
    """Losses exceed what the plane covers: some dead range's every holder
    is dead too.  The caller journals ``coded_budget_exceeded`` and re-runs —
    the same bits, at the re-run's cost."""

    def __init__(self, dead, redundancy: int):
        self.dead = sorted(int(d) for d in dead)
        self.redundancy = int(redundancy)
        super().__init__(
            f"coded redundancy budget exceeded: positions {self.dead} dead "
            f"at redundancy={self.redundancy} (a lost range's every ring "
            "successor holding its replica is dead too)"
        )


def dead_positions(exc, live=None) -> list[int]:
    """Mesh positions a `WorkerFailure` names: ``exc.workers`` (the list an
    aggregating ring hook attaches) wins over ``exc.worker``; with ``live``
    (the attempt's live-worker list) worker ids map to their positions."""
    workers = list(getattr(exc, "workers", None) or [exc.worker])
    if live is None:
        return [int(w) for w in workers]
    return [live.index(w) for w in workers if w in live]


def journal_recovery(metrics, state, dead, assemble: bool = True, **extra):
    """Run one reconstruction under the reference's journal contract.

    On success returns ``(result, info)`` — ``assemble=True`` the full
    sorted output, ``False`` the per-position ranges — after bumping
    ``coded_recoveries`` / ``coded_recovered_keys`` and emitting one
    ``coded_recover`` (replicate) or ``parity_recover`` (parity) event with
    the reference's fields, plus ``fetch_s``, the snapshot's device-to-host
    copy (``wall_s`` is the host merge alone).  On `CodedBudgetExceeded`
    journals ``coded_budget_exceeded`` and returns None.
    """
    t0 = time.monotonic()
    try:
        op = state.assemble if assemble else state.reconstruct
        result, info = op(dead)
    except CodedBudgetExceeded as b:
        metrics.event(
            "coded_budget_exceeded", dead=b.dead, redundancy=b.redundancy, **extra,
        )
        return None
    metrics.bump("coded_recoveries")
    metrics.bump("coded_recovered_keys", info["recovered_keys"])
    metrics.event(
        "parity_recover" if state.mode == "parity" else "coded_recover",
        dead=sorted(int(d) % state.num_workers for d in dead),
        holders=info["holders"],
        recovered_keys=info["recovered_keys"],
        replica_bytes=info["replica_bytes"],
        redundancy=state.redundancy,
        mode=state.mode,
        wall_s=round(time.monotonic() - t0, 6),
        fetch_s=round(state.fetch_s, 6),
        **extra,
    )
    return result, info


def _fetch(out_counts, overflow, rows: tuple, planes: tuple):
    """The snapshot's copy to the host: the counts and the overflow flags
    first (the completion barrier, and the invariant checked before any
    plane is read), then, timed, the valid prefix of every row of each of
    ``rows`` (trimmed and concatenated on the device) and the ``planes``.
    From a card the copies go to page-locked host memory (``non_blocking``
    copies, PyTorch's cached pinned allocator) and end in one stream
    synchronize.  Returns ``(c, host rows, host planes, seconds of the
    timed copy)``."""
    from dsort_tpu_torch.parallel.exchange import check_ring_overflow

    c = out_counts.long().cpu().numpy()
    check_ring_overflow(overflow.cpu().numpy())
    t0 = time.perf_counter()
    flats = [torch.cat([r[i, : int(c[i])] for i in range(len(c))]) for r in rows]
    host = [t.to("cpu", non_blocking=True) for t in flats + list(planes)]
    if out_counts.device.type == "cuda":
        torch.cuda.current_stream(out_counts.device).synchronize()
    host = [t.numpy() for t in host]
    return c, host[: len(rows)], host[len(rows) :], time.perf_counter() - t0


def _split(flat: np.ndarray, c: np.ndarray) -> list:
    """Per-position ranges of the rows' trimmed concatenation."""
    return np.split(flat, np.cumsum(c)[:-1])


def snapshot_state(
    num_workers: int, redundancy: int, caps, n: int,
    merged, out_counts, overflow, reps, rep_lens, key_dtype=None,
) -> "CodedExchangeState":
    """Host snapshot of one replicate-coded exchange (the outputs of
    `exchange._coded_ring_exchange_shard`): the survivors' ranges and the
    replica plane.  The overflow invariant is checked first: an overflowed
    exchange ran against another splitter plan and must raise."""
    p = int(num_workers)
    c, (flat,), (reps_h, lens_h), fetch_s = _fetch(
        out_counts, overflow, (merged,), (reps, rep_lens)
    )
    return CodedExchangeState(
        num_workers=p, redundancy=int(redundancy), caps=tuple(int(x) for x in caps),
        n=int(n), ranges=_split(flat, c),
        replicas=reps_h.reshape(p, int(redundancy) - 1, -1),
        replica_lens=lens_h.reshape(p, int(redundancy) - 1, p),
        key_dtype=key_dtype, fetch_s=fetch_s,
    )


def snapshot_parity_state(
    num_workers: int, redundancy: int, caps, n: int,
    merged, out_counts, overflow, sent, sent_lens, parity, key_dtype=None,
) -> "CodedExchangeState":
    """Host snapshot of one parity-coded exchange (the outputs of
    `exchange._parity_ring_exchange_shard`): the survivors' ranges, every
    worker's retained out-bucket plane and its lengths, and the received
    GF(256) parity plane.  A dead sender's out-bucket row is read only
    where its receiver lives (`CodedExchangeState._reconstruct_parity`)."""
    p = int(num_workers)
    c, (flat,), (sent_h, lens_h, par_h), fetch_s = _fetch(
        out_counts, overflow, (merged,), (sent, sent_lens, parity)
    )
    return CodedExchangeState(
        num_workers=p, redundancy=int(redundancy), caps=tuple(int(x) for x in caps),
        n=int(n), ranges=_split(flat, c), mode="parity",
        sent=sent_h.reshape(p, -1), sent_lens=lens_h.reshape(p, p),
        parity=par_h.reshape(p, -1, par_h.shape[-1]),
        key_dtype=key_dtype, fetch_s=fetch_s,
    )


def snapshot_kv_state(
    num_workers: int, redundancy: int, caps, n: int,
    merged_k, merged_v, out_counts, overflow, reps_k, reps_v, rep_lens, key_dtype=None,
) -> "CodedExchangeState":
    """Host snapshot of one replicate-coded record exchange
    (`exchange._coded_ring_exchange_kv_shard`): the keys' snapshot plus the
    payload ranges and the payload replica plane."""
    p, r1 = int(num_workers), int(redundancy) - 1
    c, (flat_k, flat_v), (rk, rv, lens_h), fetch_s = _fetch(
        out_counts, overflow, (merged_k, merged_v), (reps_k, reps_v, rep_lens)
    )
    return CodedExchangeState(
        num_workers=p, redundancy=int(redundancy), caps=tuple(int(x) for x in caps),
        n=int(n), ranges=_split(flat_k, c),
        replicas=rk.reshape(p, r1, -1), replica_lens=lens_h.reshape(p, r1, p),
        val_ranges=_split(flat_v, c), val_replicas=rv.reshape((p, r1) + rv.shape[2:]),
        key_dtype=key_dtype, fetch_s=fetch_s,
    )


def snapshot_parity_kv_state(
    num_workers: int, redundancy: int, caps, n: int,
    merged_k, merged_v, out_counts, overflow,
    sent_k, sent_v, sent_lens, parity_k, parity_v, key_dtype=None,
) -> "CodedExchangeState":
    """Host snapshot of one parity-coded record exchange
    (`exchange._parity_ring_exchange_kv_shard`): the keys' parity snapshot
    plus the retained payload plane and its parity twin."""
    p = int(num_workers)
    c, (flat_k, flat_v), (sk, sv, lens_h, pk, pv), fetch_s = _fetch(
        out_counts, overflow, (merged_k, merged_v),
        (sent_k, sent_v, sent_lens, parity_k, parity_v),
    )
    return CodedExchangeState(
        num_workers=p, redundancy=int(redundancy), caps=tuple(int(x) for x in caps),
        n=int(n), ranges=_split(flat_k, c), mode="parity",
        sent=sk.reshape(p, -1), sent_lens=lens_h.reshape(p, p),
        parity=pk.reshape(p, -1, pk.shape[-1]),
        val_ranges=_split(flat_v, c), sent_vals=sv.reshape((p, -1) + sv.shape[2:]),
        parity_vals=pv.reshape(p, -1, pv.shape[-1]),
        key_dtype=key_dtype, fetch_s=fetch_s,
    )


@dataclasses.dataclass
class CodedExchangeState:
    """Everything the survivors hold after one coded exchange.

    ``ranges[i]`` is mesh position ``i``'s merged key range (a trimmed host
    copy).  Replicate mode: ``replicas[h, j-1]`` is holder ``h``'s replica
    buffer of predecessor ``h-j``'s range — ``P`` sorted sentinel-padded
    runs at the caps-cumsum offsets — and ``replica_lens[h, j-1, k]`` slot
    ``k``'s valid length.  Parity mode: ``sent[s]`` is worker ``s``'s
    retained out-bucket plane (slot ``k`` its bucket for range ``(s+k) %
    P``), ``sent_lens`` the ``(P, P)`` valid lengths and ``parity[m, j]``
    parity slot ``j`` of group ``(m-1-j) % P``, which worker ``m``
    received.  Record jobs carry the payload twins (``val_ranges``,
    ``val_replicas``, ``sent_vals``, ``parity_vals``).  Keys are in their
    signed carrier; ``key_dtype`` (numpy) is the job's own key dtype, which
    `assemble` returns.  ``fetch_s`` is the seconds the snapshot's
    device-to-host copy of the ranges and the plane took.
    """

    num_workers: int
    redundancy: int
    caps: tuple
    n: int
    ranges: list
    replicas: np.ndarray | None = None       # (P, r-1, sum(caps))
    replica_lens: np.ndarray | None = None   # (P, r-1, P)
    mode: str = "replicate"
    sent: np.ndarray | None = None           # (P, sum(caps)) parity mode
    sent_lens: np.ndarray | None = None      # (P, P) parity mode
    parity: np.ndarray | None = None         # (P, npar, Lk) uint8
    val_ranges: list | None = None           # kv: per-position payload rows
    val_replicas: np.ndarray | None = None   # (P, r-1, sum(caps), *trailing)
    sent_vals: np.ndarray | None = None      # (P, sum(caps), *trailing)
    parity_vals: np.ndarray | None = None    # (P, npar, Lv) uint8
    key_dtype: np.dtype | None = None
    fetch_s: float = 0.0

    @property
    def kv(self) -> bool:
        """Whether this snapshot covers a key+payload exchange."""
        return self.val_ranges is not None

    def _offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(np.asarray(self.caps, np.int64))])

    def holder_of(self, d: int, dead: set) -> tuple[int, int] | None:
        """The first live ring successor holding range ``d``'s replica, as
        ``(holder, j)``; None when the budget is exceeded for ``d``."""
        for j in range(1, self.redundancy):
            h = (int(d) + j) % self.num_workers
            if h not in dead:
                return h, j
        return None

    def reconstruct(self, dead):
        """Rebuild every dead position's range locally.

        Returns ``(result, info)``: the per-position ranges (carrier keys)
        with the dead ones replaced by their reconstruction — for a record
        snapshot a ``(key_ranges, val_ranges)`` pair — and the accounting
        (``recovered_keys``, ``replica_bytes``, ``holders``).  Raises
        `CodedBudgetExceeded` past the plane's budget.  Both modes merge
        sorted runs: zero keys re-sorted.
        """
        dead_set = {int(d) % self.num_workers for d in dead}
        if self.mode == "parity":
            return self._reconstruct_parity(dead_set)
        return self._reconstruct_replicate(dead_set)

    def _reconstruct_replicate(self, dead_set: set):
        from dsort_tpu_torch.ops.merge import merge_sorted_host, merge_sorted_host_kv

        p = self.num_workers
        plan = {}
        for d in sorted(dead_set):
            hj = self.holder_of(d, dead_set)
            if hj is None:
                raise CodedBudgetExceeded(dead_set, self.redundancy)
            plan[d] = hj
        offsets = self._offsets()
        out = list(self.ranges)
        out_v = list(self.val_ranges) if self.kv else None
        recovered = replica_bytes = 0
        for d, (h, j) in plan.items():
            buf = self.replicas[h, j - 1]
            lens = self.replica_lens[h, j - 1]
            slots = [(int(offsets[k]), int(lens[k])) for k in range(p) if int(lens[k]) > 0]
            runs = [buf[o : o + ln] for o, ln in slots]
            replica_bytes += int(lens.sum()) * buf.dtype.itemsize
            if self.kv:
                vbuf = self.val_replicas[h, j - 1]
                vruns = [vbuf[o : o + ln] for o, ln in slots]
                if runs:
                    rng, out_v[d] = merge_sorted_host_kv(runs, vruns)
                else:
                    rng, out_v[d] = buf[:0].copy(), vbuf[:0].copy()
                row_b = int(np.prod(vbuf.shape[1:], dtype=np.int64)) * vbuf.dtype.itemsize
                replica_bytes += int(lens.sum()) * row_b
            else:
                rng = merge_sorted_host(runs) if runs else buf[:0].copy()
            out[d] = rng
            recovered += len(rng)
        info = {
            "recovered_keys": int(recovered),
            "replica_bytes": int(replica_bytes),
            "holders": {int(d): int(h) for d, (h, _) in plan.items()},
        }
        return ((out, out_v) if self.kv else out), info

    def _parity_of(self, s: int, j: int) -> np.ndarray:
        """Parity slot ``j`` of group ``s``, held by ring successor
        ``s+1+j`` (the shift the exchange shipped it at)."""
        return self.parity[(int(s) + 1 + j) % self.num_workers, j]

    def _parity_val_of(self, s: int, j: int) -> np.ndarray:
        return self.parity_vals[(int(s) + 1 + j) % self.num_workers, j]

    def _reconstruct_parity(self, dead_set: set):
        """The parity-plane solve.  Group ``s`` (dead sender ``s``'s
        out-bucket plane) has exactly ``|dead|`` unknown rows: row ``k`` is
        lost iff both its sender ``s`` and its receiver ``(s+k) % P`` are
        dead.  ``|dead| <= npar`` with every needed parity holder alive
        solves every group; anything beyond raises `CodedBudgetExceeded`."""
        from dsort_tpu_torch.ops.merge import merge_sorted_host, merge_sorted_host_kv

        p = self.num_workers
        nd = len(dead_set)
        if nd > int(self.parity.shape[1]):
            raise CodedBudgetExceeded(dead_set, self.redundancy)
        offsets = self._offsets()
        cap_max = int(max(self.caps))
        kdt = self.sent.dtype
        pad = _host_sentinel(kdt)
        holders, unknown = {}, {}
        for s in sorted(dead_set):
            ks = [k for k in range(p) if (s + k) % p in dead_set]
            hs = [(s + 1 + j) % p for j in range(nd)]
            if any(h in dead_set for h in hs):
                raise CodedBudgetExceeded(dead_set, self.redundancy)
            if len(ks) == 2 and (ks[1] - ks[0]) % 255 == 0:
                # g^i == g^j: the two-erasure system is singular (only past
                # P = 255) — degrade rather than divide by zero.
                raise CodedBudgetExceeded(dead_set, self.redundancy)
            unknown[s], holders[s] = ks, hs

        def rows_of(plane, s, k):
            o = int(offsets[k])
            return plane[s, o : o + int(self.sent_lens[s, k])]

        recovered_k: dict[tuple, np.ndarray] = {}
        recovered_v: dict[tuple, np.ndarray] = {}
        parity_bytes = 0
        for s, ks in unknown.items():
            known = {k: _byte_row(rows_of(self.sent, s, k), cap_max, pad)
                     for k in range(p) if k not in ks}
            planes = [self._parity_of(s, j) for j in range(len(ks))]
            parity_bytes += sum(pl.nbytes for pl in planes)
            for k, row in _parity_solve(known, planes, ks).items():
                recovered_k[(s, k)] = np.array(row.view(kdt)[: int(self.sent_lens[s, k])])
            if self.kv:
                vdt, trailing = self.sent_vals.dtype, self.sent_vals.shape[2:]
                vknown = {k: _byte_row(rows_of(self.sent_vals, s, k), cap_max, 0)
                          for k in range(p) if k not in ks}
                vplanes = [self._parity_val_of(s, j) for j in range(len(ks))]
                parity_bytes += sum(pl.nbytes for pl in vplanes)
                for k, row in _parity_solve(vknown, vplanes, ks).items():
                    recovered_v[(s, k)] = np.array(
                        row.view(vdt).reshape((cap_max,) + trailing)[: int(self.sent_lens[s, k])]
                    )
        out = list(self.ranges)
        out_v = list(self.val_ranges) if self.kv else None
        recovered = 0
        for d in sorted(dead_set):
            runs, vruns = [], []
            for s in range(p):
                k = (d - s) % p
                if int(self.sent_lens[s, k]) == 0:
                    continue
                if s in dead_set:
                    runs.append(recovered_k[(s, k)])
                    if self.kv:
                        vruns.append(recovered_v[(s, k)])
                else:
                    runs.append(rows_of(self.sent, s, k))
                    if self.kv:
                        vruns.append(rows_of(self.sent_vals, s, k))
            if self.kv:
                if runs:
                    rng, out_v[d] = merge_sorted_host_kv(runs, vruns)
                else:
                    rng, out_v[d] = self.sent[0, :0].copy(), self.sent_vals[0, :0].copy()
            else:
                rng = merge_sorted_host(runs) if runs else self.sent[0, :0].copy()
            out[d] = rng
            recovered += len(rng)
        info = {
            "recovered_keys": int(recovered),
            "replica_bytes": int(parity_bytes),
            "holders": {int(s): [int(h) for h in hs] for s, hs in holders.items()},
        }
        return ((out, out_v) if self.kv else out), info

    def to_key_dtype(self, keys: np.ndarray) -> np.ndarray:
        """Carrier keys -> the job's ``key_dtype`` (the identity for signed
        ints; the sign-bit flip for unsigned ones)."""
        if self.key_dtype is None or np.dtype(self.key_dtype) == keys.dtype:
            return keys
        from dsort_tpu_torch.ops.float_order import from_signed_keys

        kd = torch.from_numpy(np.empty(0, self.key_dtype)).dtype
        return from_signed_keys(torch.from_numpy(np.ascontiguousarray(keys)), kd).numpy()

    def assemble(self, dead):
        """The full sorted output, in ``key_dtype``, with the dead ranges
        reconstructed: the ranges concatenate in mesh-position order, which
        is the sorted order; a record snapshot returns ``(keys, payload)``.
        A count mismatch raises: reconstruction must be exact."""
        result, info = self.reconstruct(dead)
        ranges, vranges = result if self.kv else (result, None)
        out = np.concatenate(ranges) if ranges else np.zeros(0)
        if len(out) != self.n:
            raise RuntimeError(
                f"coded reconstruction assembled {len(out)} of {self.n} keys; "
                "the redundancy plane is inconsistent with the plan"
            )
        out = self.to_key_dtype(out)
        if self.kv:
            return (out, np.concatenate(vranges, axis=0)), info
        return out, info
