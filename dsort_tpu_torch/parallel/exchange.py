"""Ring-schedule bucket exchange: measured per-step capacities, P-1 shifts,
merge-as-you-receive; its coded and two-level variants.

Counterpart of ``dsort_tpu/parallel/exchange.py`` for the ``ring``,
``fused`` and ``hier`` exchanges and the coded redundancy plane.

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

- **Coded** (`_coded_ring_exchange_shard`, `_parity_ring_exchange_shard`
  and their record twins): the ring plus a replica or GF(256) parity plane
  shipped to ring successors, from which `parallel.coded` rebuilds a lost
  worker's range by a local merge (`resolve_redundancy`,
  `note_coded_plan`).
- **Hier** (`_hier_exchange_shard`): the two-level schedule over ``H``
  simulated hosts — intra-host aggregation, one transfer per (src-host,
  dst-host) pair, a local scatter — sized from the same histogram
  (`hier_plan`).  On one card every ``ppermute`` is a row move of one
  tensor (`_ppermute`), so the ``dcn_bytes_on_wire`` it journals is the
  plan's count, not a measured transfer.

Every shard program here works on the P shards at once, as the rows of one
tensor.  The ``fused`` exchange (`ops.ring_kernel`) shares the plan and the
accounting.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsort_tpu_torch.ops.local_sort import sentinel_for, sort_pairs

__all__ = [
    "HierPlan",
    "alltoall_wire_bytes",
    "check_ring_overflow",
    "dispatches_per_exchange",
    "hier_plan",
    "hier_wire_bytes",
    "host_matrix",
    "ladder_rungs",
    "note_alltoall_attempt",
    "note_coded_plan",
    "note_fused_plan",
    "note_hier_plan",
    "note_ring_plan",
    "parity_slots",
    "parity_wire_bytes",
    "replica_wire_bytes",
    "resolve_exchange",
    "resolve_hier_hosts",
    "resolve_redundancy",
    "resolve_redundancy_mode",
    "ring_caps",
    "ring_dcn_bytes",
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


def resolve_hier_hosts(value: int | None, num_workers: int) -> int:
    """The host grouping of the ``hier`` exchange: an ``H >= 2`` dividing
    ``num_workers`` (workers ``h*D .. (h+1)*D-1`` form host ``h``), or 0
    when none exists and the caller downgrades to the flat ring.

    ``value`` is the requested count (`JobConfig.hier_hosts`; 0 or None is
    auto: the world size of an initialised ``torch.distributed`` group of
    more than one process, else 2 simulated hosts).  A count that does not
    divide the workers resolves to the largest divisor below it — also the
    re-plan rule when a re-formed mesh no longer divides by the planned H.
    """
    p = int(num_workers)
    if p < 4:
        return 0
    want = int(value) if value else 0
    if want <= 0:
        procs = _process_count()
        want = procs if procs > 1 else 2
    if want >= 2 and p % want == 0:
        return want
    for h in range(min(want, p // 2), 1, -1):
        if p % h == 0:
            return h
    return 0


def _process_count() -> int:
    """Processes of the initialised ``torch.distributed`` group (1 without
    one): the real host topology, where there is one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def resolve_redundancy(value: int | None, default: int, num_workers: int) -> int:
    """Per-call override > config default, clamped to the mesh size (``r``
    copies of a bucket need ``r`` distinct workers).  1 is uncoded; a
    1-worker mesh is always uncoded."""
    red = value if value is not None else default
    if int(red) != red or red < 1:
        raise ValueError(f"redundancy must be an integer >= 1, got {red!r}")
    return min(int(red), max(int(num_workers), 1))


def resolve_redundancy_mode(value: str | None, default: str) -> str:
    """Per-call override > config default: ``replicate`` (r - 1 full bucket
    copies on ring successors) or ``parity`` (XOR at r = 2, GF(256) P+Q at
    r >= 3, about 1/P of the replicas' wire premium, the same budget)."""
    mode = value if value is not None else default
    if mode not in ("replicate", "parity"):
        raise ValueError(f"redundancy_mode must be 'replicate' or 'parity', got {mode!r}")
    return mode


def parity_slots(redundancy: int) -> int:
    """Parity slots a worker ships: one XOR slot at r = 2; r >= 3 caps at
    the RAID-6 pair (P+Q), the deepest solve this plane implements."""
    return min(max(int(redundancy) - 1, 0), 2)


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


def replica_wire_bytes(caps, bytes_per_slot: int, num_workers: int, redundancy: int) -> int:
    """Bytes the replica plane adds to the wire (whole mesh): for each
    successor shift ``j`` every worker re-ships its step-``k`` bucket at
    ring shift ``k + j``; a slot whose shift is 0 mod P stays on its
    sender."""
    p = num_workers
    total = 0
    for j in range(1, redundancy):
        total += sum(int(caps[k]) for k in range(p) if (k + j) % p != 0)
    return int(total * bytes_per_slot * p)


def parity_wire_bytes(caps, bytes_per_slot: int, num_workers: int, redundancy: int) -> int:
    """Bytes the parity plane adds to the wire (whole mesh): every worker
    ships ``parity_slots(r)`` slots of the group's largest bucket."""
    return int(parity_slots(redundancy) * max(caps) * bytes_per_slot * num_workers)


def note_coded_plan(
    metrics, caps, hist, n_local: int, num_workers: int, bytes_per_slot: int,
    capacity_factor: float, redundancy: int, jobs: int = 1, mode: str = "replicate",
) -> None:
    """Journal one planned coded ring: the ring's accounting
    (`note_ring_plan`) plus the redundancy plane, charged to both
    ``exchange_bytes_on_wire`` and ``coded_replica_bytes``, and one
    ``coded_replica_ship`` event with the plane's shape."""
    p = num_workers
    note_ring_plan(
        metrics, caps, hist, n_local, p, bytes_per_slot, capacity_factor, jobs=jobs
    )
    if mode == "parity":
        rb = parity_wire_bytes(caps, bytes_per_slot, p, redundancy) * jobs
        slots = parity_slots(redundancy) * p
    else:
        rb = replica_wire_bytes(caps, bytes_per_slot, p, redundancy) * jobs
        slots = (redundancy - 1) * p
    metrics.bump("exchange_bytes_on_wire", rb)
    metrics.bump("coded_replica_bytes", rb)
    metrics.event(
        "coded_replica_ship", redundancy=redundancy, mode=mode, slots=slots, bytes=rb,
    )


# -- the hierarchical (two-level) schedule: host side ------------------------


class HierPlan(NamedTuple):
    """Static capacities of one planned two-level exchange, all on the
    `ring_caps` ladder.

    - ``agg_cap``: phase one's cap per (src worker, dst host) bucket;
    - ``leg_caps[s]``: phase two's cap of the host-shift-``s`` leg (the max
      (src-host, dst-host) aggregate on that shift's diagonal; 0 for the
      self leg, which never leaves its host);
    - ``scatter_cap``: phase three's cap per (src host, dst worker) slice.
    """

    hosts: int
    dev_per_host: int
    slots: int  # aggregation slots per worker: ceil(H / D)
    agg_cap: int
    leg_caps: tuple
    scatter_cap: int


def host_matrix(hist: np.ndarray, hosts: int) -> np.ndarray:
    """The measured ``(P, P)`` histogram reduced to the ``(H, H)`` host
    matrix: entry ``(g, h)`` is what host ``g``'s workers hold for host
    ``h``'s ranges.  A batched histogram takes the max over jobs first."""
    h = int(hosts)
    m = np.asarray(hist)
    p = m.shape[-1]
    d = p // h
    m = m.reshape(-1, p, p).max(axis=0)
    return m.reshape(h, d, h, d).sum(axis=(1, 3))


def hier_plan(hist: np.ndarray, n_local: int, num_workers: int, hosts: int) -> HierPlan:
    """Size the three phases from the same measured histogram the flat ring
    plans from: (P, H) for the aggregation, the `host_matrix` for the legs,
    (H, P) for the scatter."""
    p, h = int(num_workers), int(hosts)
    d = p // h
    s = -(-h // d)
    m = np.asarray(hist).reshape(-1, p, p).max(axis=0)
    dev_host = m.reshape(p, h, d).sum(axis=2)  # (P, H): src worker, dst host
    host_dev = m.reshape(h, d, p).sum(axis=1)  # (H, P): src host, dst worker
    mat = host_matrix(m, h)
    agg_cap = _quantize_cap(int(dev_host.max()), n_local, p)
    agg_total = d * agg_cap
    legs = [0]
    for shift in range(1, h):
        mx = int(max(mat[g, (g + shift) % h] for g in range(h)))
        legs.append(min(_quantize_cap(mx, n_local * d, h), agg_total))
    # A received aggregate holds a whole host's keys for my ranges, so the
    # clamp bound is the host's population, not one worker's.
    scatter_cap = _quantize_cap(int(host_dev.max()), n_local * d, p)
    return HierPlan(h, d, s, agg_cap, tuple(legs), scatter_cap)


def hier_wire_bytes(plan: HierPlan, bytes_per_slot: int) -> tuple[int, int]:
    """``(dcn_bytes, intra_bytes)`` of one two-level exchange: ``H`` leg
    transfers of ``leg_caps[s]`` slots per host shift; every worker's
    ``slots x (agg_cap + scatter_cap)`` buffers on each of the ``D-1``
    steps of phases one and three.  On one card these are the plan's
    counts, not measured transfers."""
    p = plan.hosts * plan.dev_per_host
    dcn = int(sum(plan.leg_caps[1:])) * plan.hosts * bytes_per_slot
    per_step = plan.slots * (plan.agg_cap + plan.scatter_cap)
    intra = (plan.dev_per_host - 1) * per_step * p * bytes_per_slot
    return int(dcn), int(intra)


def ring_dcn_bytes(caps, bytes_per_slot: int, num_workers: int, hosts: int) -> int:
    """Bytes of the flat ring that cross a host boundary under the
    ``H``-host grouping: the baseline ``dcn_bytes_saved`` prices against."""
    p, h = int(num_workers), int(hosts)
    d = p // h
    total = 0
    for k in range(1, p):
        cross = sum(1 for i in range(p) if i // d != ((i + k) % p) // d)
        total += int(caps[k]) * cross
    return total * bytes_per_slot


def note_hier_plan(
    metrics, plan: HierPlan, caps, hist, n_local: int, num_workers: int,
    bytes_per_slot: int, capacity_factor: float, jobs: int = 1,
) -> None:
    """Journal one planned two-level exchange: ``hier_exchanges``, the
    ``dcn_bytes_on_wire`` / ``intra_host_bytes_on_wire`` split (both also
    charged to ``exchange_bytes_on_wire``), ``dcn_bytes_saved`` against the
    flat ring's cross-host bytes for the same histogram (``caps`` are its
    `ring_caps`), ``skew_report``, one ``hier_exchange_plan`` and one
    ``hier_exchange_leg`` per host shift."""
    p = num_workers
    dcn, intra = hier_wire_bytes(plan, bytes_per_slot)
    dcn, intra = dcn * jobs, intra * jobs
    flat_dcn = ring_dcn_bytes(caps, bytes_per_slot, p, plan.hosts) * jobs
    metrics.bump("hier_exchanges", jobs)
    metrics.bump("dcn_bytes_on_wire", dcn)
    metrics.bump("intra_host_bytes_on_wire", intra)
    metrics.bump("exchange_bytes_on_wire", dcn + intra)
    metrics.bump("dcn_bytes_saved", max(flat_dcn - dcn, 0))
    metrics.event("skew_report", jobs=jobs, **skew_stats(hist, p))
    metrics.event(
        "hier_exchange_plan", hosts=plan.hosts, dev_per_host=plan.dev_per_host,
        legs=plan.hosts * (plan.hosts - 1), agg_cap=int(plan.agg_cap),
        scatter_cap=int(plan.scatter_cap), dcn_bytes=dcn, intra_bytes=intra,
        flat_ring_dcn_bytes=flat_dcn,
    )
    for shift in range(1, plan.hosts):
        metrics.event(
            "hier_exchange_leg", shift=shift, cap=int(plan.leg_caps[shift]),
            bytes=int(plan.leg_caps[shift]) * bytes_per_slot * plan.hosts * jobs,
        )


# -- shard-level building blocks (batched over the mesh's rows) -------------


def _bucket_bounds(xs_sorted: torch.Tensor, counts: torch.Tensor, splitters: torch.Tensor):
    """``(starts, lens)``, both ``(P_src, P_dst)`` int64: where each sorted
    shard's bucket for each destination begins, and its length.  Keys equal
    to a splitter go to its right bucket, so bucket ``d`` holds exactly
    ``[splitters[d-1], splitters[d])``.  ``splitters`` is one ``(B-1,)``
    vector for every row, or ``(P, B-1)``, one per row (the ``hier``
    scatter's per-host cuts)."""
    p = xs_sorted.shape[0]
    cnt = counts.long().unsqueeze(1)
    if splitters.dim() == 1:
        splitters = splitters.unsqueeze(0).expand(p, -1)
    bounds = torch.searchsorted(xs_sorted, splitters.contiguous(), right=False)
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


def _wave_plan_shard(xs, counts, splitters, *, kernel: str = "lax"):
    """Plan of one wave of the out-of-core wave pipeline (`models.
    wave_sort`): the local sort (``kernel``) and the bucket histogram
    against FIXED splitters — `_ring_plan_shard` without the per-job
    splitter choice, since the pipeline samples its splitters once so every
    wave's buckets land on the same owners.  Returns ``(xs_sorted,
    hist)``; the sorted shards stay on the device for the exchange, which
    takes the same splitters."""
    from dsort_tpu_torch.ops.local_sort import sort_padded

    xs, _ = sort_padded(xs, counts, kernel)
    _, hist = _bucket_bounds(xs, counts, splitters)
    return xs, hist


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


# -- the coded ring (replica and parity planes) -----------------------------


def _out_buckets(xs, starts, lens, caps: tuple):
    """Every worker's out-bucket for ``(me + k) % P`` at each ring step
    ``k``: ``(run (P, caps[k]), gather index, length (P,))`` a step."""
    p, dev = xs.shape[0], xs.device
    return [_bucket_gather(xs, starts, lens, _step_rows(p, k, dev), caps[k]) for k in range(p)]


def _coded_ring_exchange_shard(
    xs, counts, splitters, *, caps: tuple, redundancy: int,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Coded exchange, keys only: `_ring_exchange_shard` plus the replica
    plane.  Every bucket also ships to its destination's ``r-1`` ring
    successors, so worker ``m`` ends up holding, for each predecessor ``m-j``
    (j = 1..r-1), the very runs ``m-j``'s own merge consumed: slot ``k`` is
    source ``(m-j-k) % P``'s bucket for range ``m-j``.  A slot at shift 0 mod
    P stays on its sender.

    Returns ``(merged, out_count, overflow, replicas (P, r-1, sum(caps)),
    replica_lens (P, r-1, P))``; the replicas reuse the plan's caps (the
    same buckets the ring moves), so its overflow check covers them."""
    p = xs.shape[0]
    merged, out_count, overflow = _ring_exchange_shard(
        xs, counts, splitters, caps=caps, merge_kernel=merge_kernel, kernel=kernel
    )
    starts, lens = _bucket_bounds(xs, counts, splitters)
    out = _out_buckets(xs, starts, lens, caps)
    reps, rep_lens = [], []
    for j in range(1, redundancy):
        # torch.roll by (k + j) % P: shift 0 is the holder keeping its own.
        reps.append(torch.cat([torch.roll(blk, (k + j) % p, dims=0)
                               for k, (blk, _, _) in enumerate(out)], dim=1))
        rep_lens.append(torch.stack([torch.roll(ln, (k + j) % p, dims=0)
                                     for k, (_, _, ln) in enumerate(out)], dim=1))
    return merged, out_count, overflow, torch.stack(reps, 1), torch.stack(rep_lens, 1)


def _gf2mul_u8(x: torch.Tensor) -> torch.Tensor:
    """GF(256) multiply by the generator (g = 2, polynomial 0x11D) of a
    uint8 tensor: shift left, fold the carried-out bit back through 0x1D —
    the card's half of the RAID-6 Q fold.  Python ints keep uint8."""
    return ((x << 1) & 0xFF) ^ (0x1D * (x >> 7))


def _byte_plane(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x (P, ...)`` as its raw little-endian bytes ``(P, L)``,
    the host twin of ``np.ascontiguousarray(a).view(np.uint8)``
    (`coded._byte_row`): parity folds in byte space, whatever the dtype."""
    return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def _parity_fold(rows_bytes: list, npar: int) -> list:
    """The parity slots of one out-bucket group: slot 0 the XOR fold (RAID
    P), slot 1 the GF(256) Horner fold ``sum g^k d_k`` (RAID Q)."""
    xor = rows_bytes[0]
    for r in rows_bytes[1:]:
        xor = xor ^ r
    slots = [xor]
    if npar >= 2:
        q = torch.zeros_like(rows_bytes[0])
        for r in reversed(rows_bytes):
            q = _gf2mul_u8(q) ^ r
        slots.append(q)
    return slots


def _parity_ring_exchange_shard(
    xs, counts, splitters, *, caps: tuple, redundancy: int,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Parity-coded exchange, keys only: `_ring_exchange_shard` plus the
    parity plane.  Worker ``m`` retains its own out-bucket plane (slot
    ``k``: its sentinel-padded bucket for range ``(m+k) % P``, no wire; the
    receiver holds the delivered copy too) and folds those ``P`` buckets,
    each padded to the largest cap, into ``parity_slots(r)`` byte-space
    slots shipped to successors ``m+1 .. m+npar``: the plane's only wire
    traffic.  A dead worker's group then has exactly ``|dead|`` unknown
    buckets, solvable while ``|dead| <= npar`` and the parity holders live.

    Returns ``(merged, out_count, overflow, sent (P, sum(caps)), sent_lens
    (P, P), parity (P, npar, max(caps) * itemsize))``: ``parity[m, j]`` is
    parity slot ``j`` of predecessor ``(m-1-j) % P``."""
    p = xs.shape[0]
    npar = parity_slots(redundancy)
    merged, out_count, overflow = _ring_exchange_shard(
        xs, counts, splitters, caps=caps, merge_kernel=merge_kernel, kernel=kernel
    )
    starts, lens = _bucket_bounds(xs, counts, splitters)
    out = _out_buckets(xs, starts, lens, caps)
    cap_max, sent = int(max(caps)), sentinel_for(xs.dtype)
    rows_bytes = [_byte_plane(_pad_run(blk, cap_max, sent)) for blk, _, _ in out]
    recvs = [torch.roll(slot, j + 1, dims=0) for j, slot in enumerate(_parity_fold(rows_bytes, npar))]
    return (
        merged, out_count, overflow,
        torch.cat([blk for blk, _, _ in out], dim=1),
        torch.stack([ln for _, _, ln in out], dim=1),
        torch.stack(recvs, 1),
    )


def _coded_ring_exchange_kv_shard(
    keys, payload, counts, splitters, *, caps: tuple, redundancy: int,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Coded record exchange: `_ring_exchange_kv_shard` plus the replica
    plane over both planes — every replica shift re-ships a bucket's keys
    and its payload rows, in `_coded_ring_exchange_shard`'s slot layout.

    Returns ``(keys, payload, out_count, overflow, reps_k (P, r-1,
    sum(caps)), reps_v (P, r-1, sum(caps), ...), rep_lens (P, r-1, P))``;
    payload rows beyond a slot's length are gather residue, trimmed by
    ``rep_lens`` at reconstruction."""
    from dsort_tpu_torch.ops.local_sort import _apply_perm

    p = keys.shape[0]
    out_k, out_v, out_count, overflow = _ring_exchange_kv_shard(
        keys, payload, counts, splitters, caps=caps, merge_kernel=merge_kernel, kernel=kernel
    )
    starts, lens = _bucket_bounds(keys, counts, splitters)
    out = [(blk, _apply_perm(payload, idx), ln)
           for blk, idx, ln in _out_buckets(keys, starts, lens, caps)]
    reps_k, reps_v, rep_lens = [], [], []
    for j in range(1, redundancy):
        reps_k.append(torch.cat([torch.roll(blk, (k + j) % p, dims=0)
                                 for k, (blk, _, _) in enumerate(out)], dim=1))
        reps_v.append(torch.cat([torch.roll(pv, (k + j) % p, dims=0)
                                 for k, (_, pv, _) in enumerate(out)], dim=1))
        rep_lens.append(torch.stack([torch.roll(ln, (k + j) % p, dims=0)
                                     for k, (_, _, ln) in enumerate(out)], dim=1))
    return (
        out_k, out_v, out_count, overflow,
        torch.stack(reps_k, 1), torch.stack(reps_v, 1), torch.stack(rep_lens, 1),
    )


def _parity_ring_exchange_kv_shard(
    keys, payload, counts, splitters, *, caps: tuple, redundancy: int,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Parity-coded record exchange: `_parity_ring_exchange_shard`'s
    retained plane and parity fold over both planes.  Payload rows beyond a
    bucket's length are zeroed before the fold (no sentinel exists for
    them, and the fold must see fixed bytes).

    Returns ``(keys, payload, out_count, overflow, sent_k, sent_v,
    sent_lens, parity_k, parity_v)``: ``sent_v`` is ``(P, sum(caps), ...)``,
    ``parity_v`` ``(P, npar, max(caps) * row_bytes)``."""
    from dsort_tpu_torch.ops.local_sort import _apply_perm

    npar = parity_slots(redundancy)
    out_k, out_v, out_count, overflow = _ring_exchange_kv_shard(
        keys, payload, counts, splitters, caps=caps, merge_kernel=merge_kernel, kernel=kernel
    )
    starts, lens = _bucket_bounds(keys, counts, splitters)
    cap_max, sent = int(max(caps)), sentinel_for(keys.dtype)
    sent_k, sent_v, sent_lens, krows, vrows = [], [], [], [], []
    for k, (blk, idx, ln) in enumerate(_out_buckets(keys, starts, lens, caps)):
        valid = torch.arange(caps[k], device=keys.device) < ln.unsqueeze(1)
        pv = _apply_perm(payload, idx)
        pv = torch.where(valid.view(valid.shape + (1,) * (pv.dim() - 2)), pv, 0)
        sent_k.append(blk)
        sent_v.append(pv)
        sent_lens.append(ln)
        krows.append(_byte_plane(_pad_run(blk, cap_max, sent)))
        vrows.append(_byte_plane(torch.cat(
            [pv, pv.new_zeros((pv.shape[0], cap_max - caps[k]) + pv.shape[2:])], 1
        )))
    parity_k = [torch.roll(s, j + 1, dims=0) for j, s in enumerate(_parity_fold(krows, npar))]
    parity_v = [torch.roll(s, j + 1, dims=0) for j, s in enumerate(_parity_fold(vrows, npar))]
    return (
        out_k, out_v, out_count, overflow,
        torch.cat(sent_k, dim=1), torch.cat(sent_v, dim=1), torch.stack(sent_lens, dim=1),
        torch.stack(parity_k, 1), torch.stack(parity_v, 1),
    )


# -- the hierarchical (two-level) schedule: shard program --------------------


def _hier_perm_intra(num_workers: int, dev_per_host: int, k: int):
    """Intra-host ring permutation: every host's ``D`` workers rotate by
    ``k`` within the host, so no pair crosses a host boundary."""
    d = dev_per_host
    return [(i, (i // d) * d + ((i % d + k) % d)) for i in range(num_workers)]


def _hier_perm_leg(num_workers: int, hosts: int, shift: int):
    """The host-``shift`` leg: one transfer per (src-host, dst-host) pair,
    from the aggregate's owner in the source host (local rank ``dst %
    D``) to local rank ``src_host % D`` of the destination host, so
    concurrent legs into one host land on distinct workers.  A partial
    permutation: other workers neither send nor receive."""
    d = num_workers // hosts
    return [(g * d + ((g + shift) % hosts) % d, ((g + shift) % hosts) * d + g % d)
            for g in range(hosts)]


def _ppermute(x: torch.Tensor, pairs) -> torch.Tensor:
    """``ppermute`` on the virtual mesh: row ``dst`` of the result is row
    ``src`` of ``x`` for every ``(src, dst)`` pair, zeros on rows no pair
    reaches (as a collective permute leaves them)."""
    out = torch.zeros_like(x)
    src = torch.tensor([a for a, _ in pairs], device=x.device)
    dst = torch.tensor([b for _, b in pairs], device=x.device)
    out[dst] = x[src]
    return out


def _hier_exchange_shard(
    xs, counts, splitters, *, hosts: int, agg_cap: int, leg_caps: tuple,
    scatter_cap: int, merge_kernel: str = "auto", kernel: str = "lax",
):
    """Two-level exchange, keys only: intra-host aggregation, one transfer
    per (src-host, dst-host) pair, local scatter and merge.  Same contract
    as `_ring_exchange_shard`: returns ``(merged, out_count, overflow)``,
    and an overflow is an invariant violation (the caps were measured).

    The P workers group as ``H`` hosts of ``D`` (worker ``i`` is host ``i //
    D``, local rank ``i % D``); destination host ``h'`` is aggregated on
    local rank ``h' % D`` of every source host, ``ceil(H/D)`` slots a
    worker:

    - phase one (``D-1`` intra-host steps): step ``k`` ships each worker's
      per-destination-host buckets (contiguous: a host's ranges are
      consecutive) to local owner ``(rank + k) % D``, which merges the
      ``D`` contributions of each slot into one aggregate;
    - phase two (``H-1`` legs): shift ``s`` ships host ``g``'s aggregate
      for host ``(g+s) % H``, sized at ``leg_caps[s]``; the self aggregate
      stays put;
    - phase three (``D-1`` intra-host steps): each received aggregate
      splits at its host's internal splitters and the slices scatter to
      their owners, which fold them as the flat ring does (`_merge2`,
      eagerly only where a run-merge entry exists).

    Every ``ppermute`` is a row move on the leading axis (`_ppermute`).
    """
    from dsort_tpu_torch.ops.local_sort import sort_with_kernel
    from dsort_tpu_torch.parallel.sample_sort import _resolve_merge_kernel

    p, dev = xs.shape[0], xs.device
    h_n = int(hosts)
    d_n = p // h_n
    s_n = -(-h_n // d_n)
    agg_total = d_n * agg_cap
    rows = torch.arange(p, device=dev)
    my_host, my_dev = rows // d_n, rows % d_n
    sent = sentinel_for(xs.dtype)

    starts, lens = _bucket_bounds(xs, counts, splitters)
    host_starts = starts[:, ::d_n]  # (P, H): host buckets are contiguous
    host_lens = lens.view(p, h_n, d_n).sum(2)  # (P, H)
    eager = _resolve_merge_kernel(merge_kernel, kernel, xs.dtype, agg_total, dev) != "sort"

    def merge2(a, b):
        return _merge2(a, b, merge_kernel, kernel)

    def host_run(host, cap):
        # host may exceed H-1 on ragged slot grids (slots * D > H): clip the
        # gather and zero the length, so the slot rides as pure sentinels.
        ok = host < h_n
        r = torch.clamp(host, max=h_n - 1)
        run, _, _ = _bucket_gather(xs, host_starts, host_lens, r, cap)
        n = torch.where(ok, host_lens[rows, r], 0)
        return torch.where(torch.arange(cap, device=dev) < n.unsqueeze(1), run, sent), n

    # -- phase one: aggregate per-destination-host buckets onto owners ------
    overflow = torch.zeros(p, dtype=torch.bool, device=dev)
    slot_runs, slot_lens = [], []
    for j in range(s_n):
        run, n = host_run(j * d_n + my_dev, agg_cap)
        overflow = overflow | (n > agg_cap)
        slot_runs.append([run])
        slot_lens.append(n)
    for k in range(1, d_n):
        peer = (my_dev + k) % d_n
        bufs, ls = [], []
        for j in range(s_n):
            run, n = host_run(j * d_n + peer, agg_cap)
            overflow = overflow | (n > agg_cap)
            bufs.append(run)
            ls.append(n)
        perm = _hier_perm_intra(p, d_n, k)
        rbuf = _ppermute(torch.stack(bufs, 1), perm)
        rlen = _ppermute(torch.stack(ls, 1), perm)
        for j in range(s_n):
            slot_runs[j].append(rbuf[:, j])
            slot_lens[j] = slot_lens[j] + rlen[:, j]
    agg_rows = []
    for runs_j in slot_runs:
        if d_n == 1:
            acc = _pad_run(runs_j[0], agg_total, sent)
        elif eager:
            acc = runs_j[0]
            for i, run in enumerate(runs_j[1:], start=2):
                # Each fold holds at most i * agg_cap keys: slicing the padded
                # merge back keeps the buffer growth linear.
                acc = merge2(acc, run)[:, : i * agg_cap]
            acc = _pad_run(acc, agg_total, sent)
        else:
            acc = sort_with_kernel(torch.cat(runs_j, 1), kernel)[:, :agg_total]
        agg_rows.append(acc)
    agg = torch.stack(agg_rows, 1)  # (P, S, agg_total), merged per dst host
    agg_len = torch.stack(slot_lens, 1)  # (P, S)

    # -- phase two: one transfer per (src, dst) host pair --------------------
    # Canvas slot j holds the aggregate from source host j * D + rank, for my
    # host; my own host's aggregate seeds it where I own it.
    self_row = (torch.arange(s_n, device=dev) == (my_host // d_n).unsqueeze(1)) & (
        (my_host % d_n) == my_dev
    ).unsqueeze(1)
    rcv = torch.where(self_row.unsqueeze(2), agg, sent)
    rcv_len = torch.where(self_row, agg_len, 0)
    for shift in range(1, h_n):
        cap_s = int(leg_caps[shift])
        dst_host = (my_host + shift) % h_n
        i_send = (dst_host % d_n) == my_dev
        sbuf = torch.where(i_send.unsqueeze(1), agg[rows, dst_host // d_n, :cap_s], sent)
        slen = torch.where(i_send, agg_len[rows, dst_host // d_n], 0)
        overflow = overflow | (slen > cap_s)
        perm = _hier_perm_leg(p, h_n, shift)
        rbuf, rlen = _ppermute(sbuf, perm), _ppermute(slen, perm)
        src_host = (my_host + h_n - shift) % h_n
        i_recv = (src_host % d_n) == my_dev
        slot = src_host // d_n
        rcv[rows, slot] = torch.where(
            i_recv.unsqueeze(1), _pad_run(rbuf, agg_total, sent), rcv[rows, slot]
        )
        rcv_len[rows, slot] = torch.where(i_recv, rlen, rcv_len[rows, slot])

    # -- phase three: scatter received aggregates to their owners ------------
    if d_n > 1:
        # Global splitter i separates worker buckets i and i+1, so host h's
        # internal cuts are splitters[h*D : h*D + D-1].
        local_spl = splitters[(my_host * d_n).unsqueeze(1) + torch.arange(d_n - 1, device=dev)]
    runs, sc = [], []
    out_count = torch.zeros(p, dtype=torch.long, device=dev)
    rcv = [rcv[:, j].contiguous() for j in range(s_n)]
    for j in range(s_n):
        if d_n > 1:
            st, ln = _bucket_bounds(rcv[j], rcv_len[:, j], local_spl)
        else:
            st = torch.zeros((p, 1), dtype=torch.long, device=dev)
            ln = rcv_len[:, j : j + 1]
        sc.append((st, ln))
        run, _, own = _bucket_gather(rcv[j], st, ln, my_dev, scatter_cap)
        overflow = overflow | (own > scatter_cap)
        runs.append(run)
        out_count = out_count + own
    for k in range(1, d_n):
        peer = (my_dev + k) % d_n
        bufs, ls = [], []
        for j, (st, ln) in enumerate(sc):
            run, _, n = _bucket_gather(rcv[j], st, ln, peer, scatter_cap)
            overflow = overflow | (n > scatter_cap)
            bufs.append(run)
            ls.append(n)
        perm = _hier_perm_intra(p, d_n, k)
        rbuf = _ppermute(torch.stack(bufs, 1), perm)
        rlen = _ppermute(torch.stack(ls, 1), perm)
        for j in range(s_n):
            runs.append(rbuf[:, j])
            out_count = out_count + rlen[:, j]
    total = d_n * s_n * scatter_cap
    if eager:
        tower: list = []
        for r in runs:
            _tower_push(tower, r, merge2)
        merged = _tower_fold(tower, merge2)[:, :total]
    else:
        merged = sort_with_kernel(torch.cat(runs, 1), kernel)[:, :total]
    return merged.contiguous(), out_count, overflow
