"""Ring-schedule bucket exchange: measured per-step capacities, P-1 shifts,
merge-as-you-receive.

Counterpart of ``dsort_tpu/parallel/exchange.py`` for the ``ring`` and
``fused`` exchanges (``hier`` and the coded plane are not ported yet).

- **Plan** (`_ring_plan_shard`): local sort, splitters, and the ``(P, P)``
  bucket histogram ``hist[src, dst]``.  Only the histogram goes to the
  host, which sizes every step's buffer from it (`ring_caps`) before the
  exchange runs — so a skewed job never pays the whole-job capacity retry
  of the ``alltoall`` path.  Caps sit on the same 8-aligned 1/8-octave
  ladder as the reference's, so the per-step caps, the wire-byte counters
  and the journal events equal the JAX package's.
- **Exchange** (`_ring_exchange_shard` / `_ring_exchange_kv_shard`): step
  ``k`` sends every shard's bucket for ``(me + k) % P``.  On the virtual
  mesh the reference's ``ppermute`` is ``torch.roll(blk, k, dims=0)`` of
  the ``(P, cap)`` step block.  Received runs fold into a binary-counter
  merge tower where the combine resolves to ``block_merge`` (the block
  kernels' run-merge entry); elsewhere the runs are collected and sorted
  once, the ``alltoall`` combine.  Every run is bit-identical to the
  ``alltoall`` output: both are the sorted multiset of each key range.

Every shard program here works on the P shards at once, as the rows of one
tensor.  The ``fused`` exchange (`ops.ring_kernel`) shares the plan and the
accounting.
"""

from __future__ import annotations

import numpy as np
import torch

from dsort_tpu_torch.ops.local_sort import sentinel_for, sort_pairs

__all__ = [
    "alltoall_wire_bytes",
    "check_ring_overflow",
    "dispatches_per_exchange",
    "ladder_rungs",
    "note_alltoall_attempt",
    "note_fused_plan",
    "note_ring_plan",
    "resolve_exchange",
    "ring_caps",
    "ring_step_quantum",
    "ring_wire_bytes",
    "skew_stats",
    "step_maxes",
]


def resolve_exchange(value: str | None, default: str, num_workers: int) -> str:
    """Per-call override > config default; a 1-worker mesh always takes the
    ``alltoall`` path (there is nothing to exchange)."""
    exch = value if value is not None else default
    if exch not in ("alltoall", "ring", "fused", "hier"):
        raise ValueError(
            f"exchange must be 'alltoall', 'ring', 'fused' or 'hier', got {exch!r}"
        )
    return "alltoall" if num_workers == 1 else exch


def dispatches_per_exchange(exchange: str, num_workers: int) -> int:
    """Transfer dispatches one exchange issues: the ring's P-1 shifts, one
    transpose for ``alltoall``, one exchange launch for ``fused``."""
    if exchange == "ring":
        return max(num_workers - 1, 1)
    return 1


def note_alltoall_attempt(
    metrics, cap_pair: int, bytes_per_slot: int, num_workers: int, jobs: int = 1
) -> None:
    """Charge one padded ``alltoall`` attempt's wire bytes, an overflowing
    one included (its bytes moved too)."""
    if num_workers > 1:
        metrics.bump(
            "exchange_bytes_on_wire",
            jobs * alltoall_wire_bytes(cap_pair, bytes_per_slot, num_workers),
        )


def check_ring_overflow(overflow) -> None:
    """Raise on a ring overflow: the buffers were sized from the measured
    histogram, so an overflow means the exchange ran against another
    splitter plan — an invariant violation, never a retry."""
    if bool(np.asarray(overflow).any()):
        raise RuntimeError(
            "ring exchange bucket overflow: the exchange ran against a "
            "different splitter plan than the one that sized its buffers"
        )


# -- adaptive per-step capacity (host side) ---------------------------------


def ladder_rungs(hi: int, lo: int = 8) -> list[int]:
    """Every 8-aligned 1/8-power-of-two capacity rung in ``[lo, hi]``."""
    lo = max(int(lo), 8)
    step = max(8, 1 << max((lo - 1).bit_length() - 3, 0))
    r = -(-lo // step) * step
    out: list[int] = []
    while r <= hi:
        out.append(r)
        r += max(8, 1 << max(r.bit_length() - 3, 0))
    return out


def ring_step_quantum(n_local: int, num_workers: int) -> int:
    """The cap grid: 8-aligned, stepped at 1/8 of the ideal bucket."""
    return max(-(-max(n_local // (8 * num_workers), 8) // 8) * 8, 8)


def _quantize_cap(max_len: int, n_local: int, num_workers: int) -> int:
    step = ring_step_quantum(n_local, num_workers)
    cap = -(-int(max_len) // step) * step if max_len > 0 else step
    cap = min(-(-cap // 8) * 8, max(-(-n_local // 8) * 8, 8))
    return max(cap, 8)


def step_maxes(hist: np.ndarray, num_workers: int) -> list[int]:
    """Measured max bucket of each step: step ``k`` moves every ``(src,
    (src + k) % P)`` bucket, so its buffer needs that diagonal's max.  A
    leading batch axis takes the max over jobs too."""
    p = num_workers
    hist = np.asarray(hist).reshape(-1, p, p)
    return [
        int(max(hist[:, src, (src + k) % p].max() for src in range(p)))
        for k in range(p)
    ]


def ring_caps(hist: np.ndarray, n_local: int, num_workers: int) -> tuple[int, ...]:
    """Per-step capacities: each step's measured diagonal max, quantized.
    Step 0 is the shard's own bucket (no transfer), sized the same way."""
    return tuple(
        _quantize_cap(m, n_local, num_workers) for m in step_maxes(hist, num_workers)
    )


def ring_wire_bytes(caps, bytes_per_slot: int, num_workers: int) -> int:
    """Bytes the ring moves between shards (step 0 stays local)."""
    return int(sum(caps[1:]) * bytes_per_slot * num_workers)


def alltoall_wire_bytes(cap_pair: int, bytes_per_slot: int, num_workers: int) -> int:
    """Bytes the padded ``alltoall`` moves: P-1 off-shard rows of
    ``cap_pair`` slots from every shard."""
    return int((num_workers - 1) * cap_pair * bytes_per_slot * num_workers)


def skew_stats(hist: np.ndarray, num_workers: int) -> dict:
    """The skew signal of the measured ``(P, P)`` histogram:
    ``max_mean_ratio`` (largest over mean bucket; 1.0 when uniform), the
    per-shard send and receive loads and their imbalance."""
    p = num_workers
    m = np.asarray(hist).reshape(-1, p, p).max(axis=0).astype(np.int64)
    mean = float(m.mean())
    send = m.sum(axis=1)
    recv = m.sum(axis=0)
    return {
        "max_bucket": int(m.max()),
        "mean_bucket": round(mean, 2),
        "max_mean_ratio": round(float(m.max()) / mean, 3) if mean > 0 else 1.0,
        "send_load": [int(v) for v in send],
        "recv_load": [int(v) for v in recv],
        "send_imbalance": round(
            float(send.max()) / max(float(send.mean()), 1e-9), 3
        ) if send.size else 1.0,
        "recv_imbalance": round(
            float(recv.max()) / max(float(recv.mean()), 1e-9), 3
        ) if recv.size else 1.0,
        "recv_argmax": int(recv.argmax()) if recv.size else 0,
    }


def note_ring_plan(
    metrics, caps, hist, n_local: int, num_workers: int, bytes_per_slot: int,
    capacity_factor: float, jobs: int = 1,
) -> None:
    """Journal one planned ring: ``skew_report``, one ``exchange_step`` per
    transfer step, ``exchange_resize`` where the measured max bucket exceeds
    the static ``alltoall`` capacity (exactly the steps where that path
    would have overflowed), and the wire-byte counters —
    ``exchange_bytes_saved`` against what the padded path would have
    shipped for this histogram, its overflow re-dispatch included."""
    from dsort_tpu_torch.parallel.sample_sort import cap_pair_policy, next_cap_pair

    p = num_workers
    maxes = step_maxes(hist, p)
    policy_cap = cap_pair_policy(n_local, capacity_factor, p)
    ring_b = ring_wire_bytes(caps, bytes_per_slot, p) * jobs
    padded_b = alltoall_wire_bytes(policy_cap, bytes_per_slot, p) * jobs
    max_pair = max(maxes)
    if max_pair > policy_cap:
        retry_cap = next_cap_pair(max_pair, policy_cap, n_local, p)
        padded_b += alltoall_wire_bytes(retry_cap, bytes_per_slot, p) * jobs
    metrics.bump("exchange_ring_steps", (p - 1) * jobs)
    metrics.bump("exchange_bytes_on_wire", ring_b)
    metrics.bump("exchange_bytes_saved", max(padded_b - ring_b, 0))
    metrics.event("skew_report", jobs=jobs, **skew_stats(hist, p))
    for k in range(1, p):
        metrics.event(
            "exchange_step", step=k, cap=int(caps[k]),
            bytes=int(caps[k]) * bytes_per_slot * p * jobs,
        )
        if maxes[k] > policy_cap:
            metrics.event(
                "exchange_resize", step=k, cap=int(caps[k]),
                observed=maxes[k], policy_cap=policy_cap,
            )


def note_fused_plan(
    metrics, caps, hist, n_local: int, num_workers: int, bytes_per_slot: int,
    capacity_factor: float, jobs: int = 1,
) -> None:
    """Journal one planned ``fused`` ring: the ring's accounting
    (`note_ring_plan`) plus ``fused_exchange_launches`` /
    ``fused_exchange_steps`` and their events — one exchange launch in
    place of the P-1 shifts."""
    from dsort_tpu_torch.ops.ring_kernel import DISPATCHES_PER_FUSED_EXCHANGE

    p = num_workers
    note_ring_plan(
        metrics, caps, hist, n_local, p, bytes_per_slot, capacity_factor, jobs=jobs
    )
    metrics.bump("fused_exchange_launches", jobs)
    metrics.bump("fused_exchange_steps", (p - 1) * jobs)
    metrics.event(
        "fused_exchange_launch",
        steps=p - 1,
        dispatches=DISPATCHES_PER_FUSED_EXCHANGE,
        dispatches_replaced=p - 1,
        total_cap=int(sum(caps)),
    )
    for k in range(1, p):
        metrics.event(
            "fused_exchange_step", step=k, cap=int(caps[k]),
            bytes=int(caps[k]) * bytes_per_slot * p * jobs,
        )


# -- shard-level building blocks (batched over the mesh's rows) -------------


def _bucket_bounds(xs_sorted: torch.Tensor, counts: torch.Tensor, splitters: torch.Tensor):
    """``(starts, lens)``, both ``(P_src, P_dst)`` int64: where each sorted
    shard's bucket for each destination begins, and its length.  Keys equal
    to a splitter go to its right bucket, so bucket ``d`` holds exactly
    ``[splitters[d-1], splitters[d])``."""
    p = xs_sorted.shape[0]
    cnt = counts.long().unsqueeze(1)
    bounds = torch.searchsorted(
        xs_sorted, splitters.unsqueeze(0).expand(p, -1).contiguous(), right=False
    )
    bounds = torch.minimum(bounds.clamp(min=0), cnt)
    zero = torch.zeros((p, 1), dtype=bounds.dtype, device=xs_sorted.device)
    starts = torch.cat([zero, bounds], dim=1)
    ends = torch.cat([bounds, cnt], dim=1)
    return starts, (ends - starts).clamp(min=0)


def _bucket_gather(xs_sorted, starts, lens, dst: torch.Tensor, cap: int):
    """Every source shard's bucket for destination ``dst[src]`` as a
    ``(P, cap)`` sentinel-padded run; also the gather index (the kv path
    lifts payload rows with it) and the true lengths."""
    p, n_local = xs_sorted.shape
    src = torch.arange(p, device=xs_sorted.device)
    st, ln = starts[src, dst], lens[src, dst]
    pos = torch.arange(cap, device=xs_sorted.device)
    idx = (st.unsqueeze(1) + pos).clamp(0, max(n_local - 1, 0))
    sent = torch.full((), sentinel_for(xs_sorted.dtype), dtype=xs_sorted.dtype,
                      device=xs_sorted.device)
    return torch.where(pos < ln.unsqueeze(1), xs_sorted.gather(1, idx), sent), idx, ln


def _pad_run(run: torch.Tensor, length: int, fill) -> torch.Tensor:
    """Pad ``(P, L)`` runs to ``(P, length)`` with ``fill``."""
    if run.shape[-1] == length:
        return run
    pad = torch.full(run.shape[:-1] + (length - run.shape[-1],), fill,
                     dtype=run.dtype, device=run.device)
    return torch.cat([run, pad], dim=-1)


def _merge2(a: torch.Tensor, b: torch.Tensor, merge_kernel: str, kernel: str):
    """Merge two batches of sorted sentinel-padded runs through the same
    combine as the barrier merge (`sample_sort._merge_received`), so the
    tower's folds and the one-shot path agree."""
    from dsort_tpu_torch.parallel.sample_sort import _merge_received

    length = -(-max(a.shape[-1], b.shape[-1]) // 8) * 8
    sent = sentinel_for(a.dtype)
    return _merge_received(
        torch.stack([_pad_run(a, length, sent), _pad_run(b, length, sent)], dim=1),
        merge_kernel, kernel,
    )


def _merge2_kv(a, b, total: int, merge_kernel: str, kernel: str):
    """kv tower merge of ``(keys, tag)`` run pairs ordered by ``(key,
    tag)``: the tag (flat receive position, ``+ total`` for pads) keeps
    real keys equal to the sentinel ahead of the padding and becomes the
    payload permutation after the last fold.  Pads added here carry tag
    ``2 * total``, above every real tag."""
    from dsort_tpu_torch.ops.block_sort import _ceil_pow2, block_merge_runs_kv
    from dsort_tpu_torch.parallel.sample_sort import _resolve_merge_kernel

    (ka, ta), (kb, tb) = a, b
    length = -(-max(ka.shape[-1], kb.shape[-1]) // 8) * 8
    sent, pad_tag = sentinel_for(ka.dtype), 2 * total
    resolved = _resolve_merge_kernel(merge_kernel, kernel, ka.dtype, 2 * length, ka.device)
    if resolved == "block_merge":
        # A power-of-two length, so block_merge_runs_kv pads nothing itself:
        # its own pad ranks scale with the local merge size and could sort
        # ahead of this tower's global tags at equal (sentinel) keys.
        length = _ceil_pow2(length)
    ka, ta = _pad_run(ka, length, sent), _pad_run(ta, length, pad_tag)
    kb, tb = _pad_run(kb, length, sent), _pad_run(tb, length, pad_tag)
    if resolved == "block_merge":
        return block_merge_runs_kv(torch.stack([ka, kb], 1), torch.stack([ta, tb], 1))
    return sort_pairs(torch.cat([ka, kb], -1), torch.cat([ta, tb], -1))


def _tower_push(tower: list, run, merge2) -> None:
    """Binary-counter merge tower: push the new run and merge equal-rank
    runs, so total merge work stays O(N log P)."""
    tower.append((run, 1))
    while len(tower) >= 2 and tower[-1][1] == tower[-2][1]:
        b, rb = tower.pop()
        a, ra = tower.pop()
        tower.append((merge2(a, b), ra + rb))


def _tower_fold(tower: list, merge2):
    """Collapse the remaining runs, smallest first, into the final run."""
    acc, _ = tower.pop()
    while tower:
        a, _ = tower.pop()
        acc = merge2(a, acc)
    return acc


# -- the shard programs -----------------------------------------------------


def _ring_plan_shard(xs, counts, *, mesh, oversample: int, kernel: str = "lax"):
    """Plan: local sort, splitters, and the bucket histogram ``hist[src,
    dst]`` (each shard's bucket lengths, all-gathered: on the virtual mesh
    the ``(P, P)`` matrix itself).  Returns ``(xs_sorted, splitters,
    hist)``; the sorted shards stay on the device for the exchange."""
    from dsort_tpu_torch.ops.local_sort import sort_padded
    from dsort_tpu_torch.parallel.sample_sort import _choose_splitters

    xs, _ = sort_padded(xs, counts, kernel)
    splitters = _choose_splitters(xs, counts, mesh, oversample)
    _, hist = _bucket_bounds(xs, counts, splitters)
    return xs, splitters, hist


def _ring_plan_kv_shard(keys, payload, counts, *, mesh, oversample: int):
    """kv plan: the payload rides the local sort, so the exchange's bucket
    gathers see key-aligned rows."""
    from dsort_tpu_torch.ops.local_sort import sort_kv_padded
    from dsort_tpu_torch.parallel.sample_sort import _choose_splitters

    keys, payload, _ = sort_kv_padded(keys, payload, counts)
    splitters = _choose_splitters(keys, counts, mesh, oversample)
    _, hist = _bucket_bounds(keys, counts, splitters)
    return keys, payload, splitters, hist


def _step_rows(p: int, k: int, device) -> torch.Tensor:
    """Destination of every source shard at step ``k``: ``(me + k) % P``."""
    return (torch.arange(p, device=device) + k) % p


def _ring_exchange_shard(
    xs, counts, splitters, *, caps: tuple,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Exchange, keys only: P-1 shifts and the tower merge.

    ``caps`` are the plan's per-step capacities.  Returns ``(merged (P,
    sum(caps)), out_count (P,), overflow (P,))``; ``overflow`` can only
    fire if the exchange ran against another splitter plan than the one
    that sized ``caps``."""
    from dsort_tpu_torch.ops.local_sort import sort_with_kernel
    from dsort_tpu_torch.parallel.sample_sort import _resolve_merge_kernel

    p, dev = xs.shape[0], xs.device
    me = torch.arange(p, device=dev)
    starts, lens = _bucket_bounds(xs, counts, splitters)
    total = int(sum(caps))
    # Fold as runs land only where a genuine run-merge entry exists: under
    # the flat re-sort an eager fold would re-sort the accumulated data once
    # per tower level, so the runs are collected and sorted once instead.
    eager = _resolve_merge_kernel(merge_kernel, kernel, xs.dtype, total, dev) != "sort"

    def merge2(a, b):
        return _merge2(a, b, merge_kernel, kernel)

    def fold(tower, run):
        if eager:
            _tower_push(tower, run, merge2)
        else:
            tower.append(run)

    own, _, own_len = _bucket_gather(xs, starts, lens, me, caps[0])
    overflow = own_len > caps[0]
    out_count = own_len.clone()
    tower: list = []
    prev = own
    for k in range(1, p):
        blk, _, ln = _bucket_gather(xs, starts, lens, _step_rows(p, k, dev), caps[k])
        overflow = overflow | (ln > caps[k])
        recv = torch.roll(blk, k, dims=0)  # shard i -> (i + k) % P
        out_count = out_count + torch.roll(ln, k, dims=0)
        fold(tower, prev)
        prev = recv
    fold(tower, prev)
    if eager:
        merged = _tower_fold(tower, merge2)[:, :total]
    else:
        merged = sort_with_kernel(torch.cat(tower, dim=1), kernel)
    return merged.contiguous(), out_count, overflow


def _ring_exchange_kv_shard(
    keys, payload, counts, splitters, *, caps: tuple,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Exchange, key + payload: keys ride the tower as ``(key, tag)`` pairs;
    payload rows ride only the shifts into a flat step-ordered buffer,
    permuted once by the merged tags.  Returns ``(keys (P, total), payload
    (P, total, ...), out_count (P,), overflow (P,))``."""
    from dsort_tpu_torch.ops.local_sort import _apply_perm
    from dsort_tpu_torch.parallel.sample_sort import _resolve_merge_kernel

    p, dev = keys.shape[0], keys.device
    me = torch.arange(p, device=dev)
    starts, lens = _bucket_bounds(keys, counts, splitters)
    total = int(sum(caps))
    offsets = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    # The kv tower's only run-merge entry is the block kernels'.
    eager = (
        _resolve_merge_kernel(merge_kernel, kernel, keys.dtype, total, dev)
        == "block_merge"
    )

    def merge2(a, b):
        return _merge2_kv(a, b, total, merge_kernel, kernel)

    def fold(tower, run):
        if eager:
            _tower_push(tower, run, merge2)
        else:
            tower.append(run)

    def tagged(run_k, run_len, step: int):
        pos = torch.arange(caps[step], dtype=torch.int32, device=dev)
        is_pad = (pos >= run_len.unsqueeze(1)).to(torch.int32)
        return run_k, int(offsets[step]) + pos + is_pad * total

    # Pad positions' payload rows are never gathered (their tags map to row
    # 0 and sit beyond the valid count): no masking needed.
    own_k, own_idx, own_len = _bucket_gather(keys, starts, lens, me, caps[0])
    vals = [_apply_perm(payload, own_idx)]
    overflow = own_len > caps[0]
    out_count = own_len.clone()
    tower: list = []
    prev = tagged(own_k, own_len, 0)
    for k in range(1, p):
        blk, idx, ln = _bucket_gather(keys, starts, lens, _step_rows(p, k, dev), caps[k])
        overflow = overflow | (ln > caps[k])
        recv_k = torch.roll(blk, k, dims=0)
        recv_v = torch.roll(_apply_perm(payload, idx), k, dims=0)
        recv_len = torch.roll(ln, k, dims=0)
        out_count = out_count + recv_len
        fold(tower, prev)
        prev = tagged(recv_k, recv_len, k)
        vals.append(recv_v)
    fold(tower, prev)
    if eager:
        merged_k, merged_t = _tower_fold(tower, merge2)
    else:
        merged_k, merged_t = sort_pairs(
            torch.cat([r[0] for r in tower], 1), torch.cat([r[1] for r in tower], 1)
        )
    merged_k, merged_t = merged_k[:, :total], merged_t[:, :total]
    flat_v = torch.cat(vals, dim=1)  # (P, total, ...) in step order
    gather = torch.where(merged_t < total, merged_t, 0)
    return merged_k.contiguous(), _apply_perm(flat_v, gather), out_count, overflow
