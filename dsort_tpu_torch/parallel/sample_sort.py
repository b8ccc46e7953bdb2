"""Distributed sample sort over a `VirtualMesh`: splitters, exchange, merge.

Counterpart of ``dsort_tpu/parallel/sample_sort.py``'s `SampleSort` for
keys (`sort`, `sort_ranges`) and key+payload records (`sort_kv`, with an
optional secondary key — TeraSort's 10-byte order).  The reference runs one
program per device under ``shard_map``; here the P shards are the rows of
one tensor, so each phase is one batched call:

  1. local sort of every shard (`ops.local_sort.sort_padded`; ``auto`` picks
     the block-bitonic CUDA kernels for integer keys >= 2^16 on a GPU;
     records sort with ``torch.sort``, as the reference's ``lax.sort``);
  2. ``oversample`` samples per shard, all_gather, P-1 splitters — with the
     reference's float32 index arithmetic, so per-shard counts match it;
  3. the exchange, chosen by ``exchange=`` / `JobConfig.exchange`:
     ``alltoall`` slices every shard into a ``(P_src, P_dst, cap_pair)``
     buffer and transposes it (a bucket larger than ``cap_pair`` overflows
     and the host retries with a capacity sized from the measured largest
     bucket, `next_cap_pair`); ``ring`` and ``fused`` first measure the
     ``(P, P)`` bucket histogram and size each ring step's buffer from it
     (`parallel.exchange`, `ops.ring_kernel`), so they never retry; ``hier``
     sizes its two-level schedule from the same histogram; a coded job
     (``redundancy > 1``) runs ``ring`` with a replica or parity plane
     (`parallel.coded`), from which a lost worker's range is rebuilt and a
     straggler's range raced;
  4. merge of each destination's P received runs (`ops.block_sort.
     block_merge_runs` / ``block_merge_runs_kv`` under ``merge_kernel=
     "auto"`` on a GPU; the bitonic merge tree under ``"bitonic"``; a flat
     re-sort through the local kernel under ``"sort"``, which is where
     ``local_kernel="pallas"`` runs its tile kernel a second time).

Keys ride as signed ints: unsigned keys through the sign-bit flip and float
keys through `ops.float_order`, both order-preserving, so splitters, bucket
bounds and per-shard counts are those of the reference.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.data.partition import pad_kv_to_shards, pad_to_layout, pad_to_shards
from dsort_tpu_torch.ops.float_order import (
    from_signed_keys,
    is_narrow_int_dtype,
    narrow_from_int32,
    sort_float_keys_via_uint,
    sort_narrow_keys_via_int32,
    to_signed_keys,
)
from dsort_tpu_torch.ops.local_sort import (
    _apply_perm,
    _stable_order,
    resolve_kernel,
    sentinel_for,
    sort_keys,
    sort_kv2_padded,
    sort_kv_padded,
    sort_padded,
    sort_with_kernel,
)
from dsort_tpu_torch.parallel.device_result import DeviceSortResult
from dsort_tpu_torch.parallel.exchange import (
    _bucket_bounds,
    _coded_ring_exchange_kv_shard,
    _coded_ring_exchange_shard,
    _hier_exchange_shard,
    _parity_ring_exchange_kv_shard,
    _parity_ring_exchange_shard,
    _ring_exchange_kv_shard,
    _ring_exchange_shard,
    _ring_plan_kv_shard,
    _ring_plan_shard,
    check_ring_overflow,
    hier_plan,
    note_alltoall_attempt,
    note_coded_plan,
    note_fused_plan,
    note_hier_plan,
    note_ring_plan,
    resolve_exchange,
    resolve_hier_hosts,
    resolve_redundancy,
    resolve_redundancy_mode,
    ring_caps,
)
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

log = get_logger("sample_sort")


def cap_pair_policy(n_local: int, factor: float, num_workers: int) -> int:
    """Static per-(src, dst) bucket capacity: ceil'd, 8-aligned, clamped to
    ``[8, max(n_local, 8)]``."""
    cap = int(np.ceil(factor * n_local / num_workers))
    cap = min(-(-cap // 8) * 8, max(n_local, 8))
    return max(cap, 8)


def cap_from_observed(max_len: int, n_local: int, num_workers: int) -> int:
    """Retry capacity from a measured max bucket length (+5%), quantized up
    to 1/8 of the ideal bucket size."""
    step = max(n_local // (8 * num_workers), 8)
    cap = -(-int(max_len * 1.05 + 1) // step) * step
    cap = min(-(-cap // 8) * 8, max(n_local, 8))
    return max(cap, 8)


def next_cap_pair(
    observed: int, cap_pair: int, n_local: int, num_workers: int
) -> int:
    """The overflow-retry resize rule: the measured size, and always growth."""
    return max(cap_from_observed(observed, n_local, num_workers), cap_pair + 8)


def _choose_splitters(xs_sorted, counts, mesh: VirtualMesh, oversample: int):
    """Per-shard samples -> all_gather -> P-1 global splitters.

    The sample index is computed in float32, exactly as the reference does
    (``((j + 0.5) * count / s)`` truncated): any other rounding picks other
    samples and changes the per-shard counts.
    """
    s = oversample
    p, n_local = xs_sorted.shape
    dev = xs_sorted.device
    j = torch.arange(s, dtype=torch.float32, device=dev)
    idx = ((j + 0.5) * counts.to(torch.float32).unsqueeze(1) / s).to(torch.int32)
    idx = idx.clamp(0, max(n_local - 1, 0)).long()
    samples = torch.gather(xs_sorted, 1, idx)
    sent = torch.full((), sentinel_for(xs_sorted.dtype), dtype=xs_sorted.dtype, device=dev)
    samples = torch.where(counts.unsqueeze(1) > 0, samples, sent)
    all_samples = sort_keys(mesh.all_gather(samples))
    return all_samples[s * torch.arange(1, p, device=dev)]


def _bucket_slices(xs_sorted, counts, splitters, cap_pair: int):
    """Contiguous per-destination slices of every sorted shard.

    Returns ``(gather_index, valid_mask, lens, overflow)``: index and mask
    ``(P_src, P_dst, cap_pair)``, ``lens`` the true ``(P_src, P_dst)``
    bucket sizes (`exchange._bucket_bounds`), ``overflow`` per source shard.
    """
    n_local = xs_sorted.shape[1]
    starts, lens = _bucket_bounds(xs_sorted, counts, splitters)
    overflow = (lens > cap_pair).any(dim=1)
    ar = torch.arange(cap_pair, device=xs_sorted.device)
    gidx = (starts.unsqueeze(2) + ar).clamp(0, max(n_local - 1, 0))
    valid = ar < lens.unsqueeze(2)
    return gidx, valid, lens, overflow


def _resolve_merge_kernel(
    merge_kernel: str, kernel: str, dtype, total: int, device
) -> str:
    """``auto``: block_merge wherever the block kernel would carry the flat
    sort, the plain re-sort otherwise."""
    if merge_kernel != "auto":
        return merge_kernel
    return (
        "block_merge"
        if resolve_kernel(kernel, dtype, total, device) == "block"
        else "sort"
    )


def _merge_received(recv: torch.Tensor, merge_kernel: str, kernel: str = "lax"):
    """Combine each destination's received ``(P_src, cap)`` runs into one
    sorted ``(P_src*cap,)`` row; ``recv`` is ``(P_dst, P_src, cap)``.

    Rows arrive sorted with sentinel pads at their tails, so they are
    sorted runs: ``block_merge`` enters the bitonic network at the run
    level, ``bitonic`` merges them with the bitonic merge tree
    (`ops.bitonic.merge_sorted_runs`), ``sort`` re-sorts flat through the
    job's local kernel.
    """
    p_dst, p_src, cap = recv.shape
    merge_kernel = _resolve_merge_kernel(
        merge_kernel, kernel, recv.dtype, p_src * cap, recv.device
    )
    if merge_kernel == "block_merge":
        from dsort_tpu_torch.ops.block_sort import block_merge_runs

        return block_merge_runs(recv)
    if merge_kernel == "bitonic":
        from dsort_tpu_torch.ops.bitonic import _ceil_pow2, merge_sorted_runs

        # The tree needs power-of-two run lengths and counts: pad the run
        # length (cap is only 8-aligned) and the run count (a mesh of 7)
        # with the sentinel; padded runs stay sorted and every valid key
        # sorts ahead of the pads, so the trim keeps them all.
        buf = torch.full(
            (p_dst, _ceil_pow2(p_src), _ceil_pow2(cap)), sentinel_for(recv.dtype),
            dtype=recv.dtype, device=recv.device,
        )
        buf[:, :p_src, :cap] = recv
        return merge_sorted_runs(buf)[:, : p_src * cap]
    return sort_with_kernel(recv.reshape(p_dst, p_src * cap), kernel)


def _sample_sort_shard(
    xs, counts, *, mesh: VirtualMesh, oversample: int, cap_pair: int,
    kernel: str = "lax", merge_kernel: str = "sort",
):
    """Every shard's view of the whole sort, batched over the mesh's rows.

    ``xs``: ``(P, n_local)`` sentinel-padded signed keys; ``counts``: ``(P,)``
    valid lengths.  Returns ``(merged (P, P*cap), out_count (P,),
    overflow (P,), max_len (P,))``; ``max_len`` is each source's largest
    bucket, what the host's capacity retry sizes the next buffer from.  One
    worker short-circuits after the local sort.
    """
    p = mesh.num_workers
    xs, _ = sort_padded(xs, counts, kernel)                              # 1
    if p == 1:
        no = torch.zeros(1, dtype=torch.bool, device=xs.device)
        return xs, counts.long(), no, counts.long()
    splitters = _choose_splitters(xs, counts, mesh, oversample)          # 2
    gidx, valid, lens, overflow = _bucket_slices(xs, counts, splitters, cap_pair)  # 3
    picked = torch.gather(xs, 1, gidx.view(p, -1)).view(p, p, cap_pair)
    sent = torch.full((), sentinel_for(xs.dtype), dtype=xs.dtype, device=xs.device)
    send = torch.where(valid, picked, sent)
    recv = mesh.all_to_all(send)                                         # 4
    lens_recv = mesh.all_to_all(lens)
    merged = _merge_received(recv, merge_kernel, kernel)                 # 5
    return merged, lens_recv.sum(dim=1), overflow, lens.max(dim=1).values


def _merge_received_kv(
    flat_k: torch.Tensor, is_pad: torch.Tensor, cap_pair: int, merge_kernel: str,
    kernel: str = "lax",
):
    """Sorted keys and payload permutation of every destination's received
    kv buffer ``(P_dst, P_src * cap_pair)``.

    The order is ``(key, is_pad, position)``, so real keys equal to the
    sentinel keep their payloads.  ``block_merge`` merges the received runs
    through `ops.block_sort.block_merge_runs_kv` with the tiebreak
    ``is_pad * total + position`` as its rank plane, which comes back as the
    permutation; ``bitonic`` merges them with the key+value merge tree
    (`ops.bitonic.merge_sorted_runs_kv`) carrying the same tiebreak;
    ``sort`` re-sorts flat — through ``block_sort_pairs`` where the local
    kernel resolves to ``block``, by stable ``torch.sort`` passes otherwise.
    """
    p, total = flat_k.shape
    dev = flat_k.device
    merge_kernel = _resolve_merge_kernel(merge_kernel, kernel, flat_k.dtype, total, dev)
    tieb = is_pad.to(torch.int32) * total + torch.arange(total, dtype=torch.int32, device=dev)
    runs = (p, total // cap_pair, cap_pair)
    if merge_kernel == "block_merge":
        from dsort_tpu_torch.ops.block_sort import block_merge_runs_kv

        out_k, t = block_merge_runs_kv(flat_k.view(runs), tieb.view(runs))
        return out_k, torch.where(t < total, t, 0)
    if merge_kernel == "bitonic":
        from dsort_tpu_torch.ops.bitonic import _ceil_pow2, merge_sorted_runs_kv

        # Pad the run length and count to powers of two with (sentinel,
        # ascending tag): column pads take 2 * total + j, row pads
        # 3 * total + j, so every padded run stays (key, tag)-sorted and
        # the pads trim off the tail.
        r2, cap2 = _ceil_pow2(runs[1]), _ceil_pow2(cap_pair)
        col = torch.arange(cap2, dtype=torch.int32, device=dev)
        kb = torch.full((p, r2, cap2), sentinel_for(flat_k.dtype), dtype=flat_k.dtype, device=dev)
        tb = torch.empty((p, r2, cap2), dtype=torch.int32, device=dev)
        tb[:, : runs[1]] = 2 * total + col - cap_pair
        tb[:, runs[1] :] = 3 * total + col
        kb[:, : runs[1], :cap_pair] = flat_k.view(runs)
        tb[:, : runs[1], :cap_pair] = tieb.view(runs)
        out_k, t = merge_sorted_runs_kv(kb, tb)
        out_k, t = out_k[:, :total], t[:, :total]
        return out_k, torch.where(t < total, t % total, 0)
    if resolve_kernel(kernel, flat_k.dtype, total, dev) == "block":
        from dsort_tpu_torch.ops.block_sort import block_sort_pairs

        out_k, t = block_sort_pairs(flat_k, tieb)
        return out_k, torch.where(t < total, t, 0)
    perm = _stable_order(flat_k, _stable_order(is_pad))
    return flat_k.gather(1, perm), perm


def _kv_shard_body(
    keys, payload, sec, counts, *, mesh: VirtualMesh, oversample: int, cap_pair: int,
    merge_kernel: str = "sort", kernel: str = "lax",
):
    """Every shard's view of the record sort, batched over the mesh's rows.

    With ``sec=None`` the order is the key; with a secondary it is ``(key,
    sec)``, the secondary rides the exchange beside the payload and the
    combine is the stable-sort one (the run merge carries one tiebreak
    plane).  Returns ``(keys (P, P*cap), payload (P, P*cap, ...),
    out_count (P,), overflow (P,), max_len (P,))``.  One worker
    short-circuits after the local sort.
    """
    p = mesh.num_workers
    if sec is None:
        keys, payload, _ = sort_kv_padded(keys, payload, counts)
    else:
        keys, sec, payload, _ = sort_kv2_padded(keys, sec, payload, counts)
    if p == 1:
        cnt = counts.long()
        return keys, payload, cnt, torch.zeros(1, dtype=torch.bool, device=keys.device), cnt
    splitters = _choose_splitters(keys, counts, mesh, oversample)
    gidx, valid, lens, overflow = _bucket_slices(keys, counts, splitters, cap_pair)
    flat_idx = gidx.view(p, -1)
    sent = torch.full((), sentinel_for(keys.dtype), dtype=keys.dtype, device=keys.device)
    send_k = torch.where(valid, keys.gather(1, flat_idx).view(p, p, cap_pair), sent)
    send_v = _apply_perm(payload, flat_idx).view((p, p, cap_pair) + payload.shape[2:])
    recv_k = mesh.all_to_all(send_k)
    recv_v = mesh.all_to_all(send_v)
    lens_recv = mesh.all_to_all(lens)
    # Validity re-derived after the exchange: real keys equal to the
    # sentinel keep their payloads (no reserved key value).
    pos = torch.arange(cap_pair, device=keys.device)
    is_pad = (pos >= lens_recv.unsqueeze(2)).view(p, -1)
    flat_k = torch.where(is_pad, sent, recv_k.view(p, -1))
    flat_v = recv_v.view((p, p * cap_pair) + payload.shape[2:])
    if sec is None:
        out_k, perm = _merge_received_kv(flat_k, is_pad, cap_pair, merge_kernel, kernel)
    else:
        recv_s = mesh.all_to_all(sec.gather(1, flat_idx).view(p, p, cap_pair)).view(p, -1)
        perm = _stable_order(flat_k, _stable_order(is_pad, _stable_order(recv_s)))
        out_k = flat_k.gather(1, perm)
    return out_k, _apply_perm(flat_v, perm), lens_recv.sum(dim=1), overflow, lens.max(dim=1).values


class SampleSort:
    """Host-facing driver of the sample sort over a `VirtualMesh`.

    Handles the padded layout, the upload, the exchange plan (the
    measured-capacity retries of ``alltoall``, the measured ring caps of
    ``ring`` / ``fused``) and the assembly of the sorted output.
    """

    def __init__(self, mesh: VirtualMesh, job: JobConfig | None = None):
        self.mesh = mesh
        self.job = job or JobConfig()
        self.num_workers = mesh.num_workers
        #: Called between the ring plan and the exchange (``ring``, ``fused``
        #: and ``hier``, keys and records; after the exchange on a coded
        #: dispatch, whose plane is then placed): the scheduler's mid-ring
        #: injection point, where a lost worker invalidates the exchange.
        self.fault_hook = None
        #: Optional ``() -> int | None``: the mesh position of the current
        #: measured straggler.  On a coded dispatch its range is raced —
        #: owner fetch against reconstruction from the plane, first to
        #: claim serves (`_serve_straggler_ring`).  No failure is involved.
        self.straggler_fn = None
        #: Optional ``(position) -> seconds``: extra latency the owner leg
        #: of the race sleeps first (a slow worker's fetch;
        #: `FaultInjector.delay_for` in the drills).
        self.fetch_delay_fn = None
        #: Owner-fetch threads that lost their race, left to finish in the
        #: background; `join_stragglers` drains them.
        self._straggler_threads: list = []

    def _resolve_exchange(self, exchange: str | None) -> str:
        return resolve_exchange(exchange, self.job.exchange, self.num_workers)

    def _resolve_redundancy(self, redundancy: int | None) -> int:
        return resolve_redundancy(redundancy, self.job.redundancy, self.num_workers)

    def _resolve_redundancy_mode(self, mode: str | None) -> str:
        return resolve_redundancy_mode(mode, self.job.redundancy_mode)

    def join_stragglers(self) -> None:
        """Drain the owner-fetch threads that lost a straggler race: call
        before reading the journal (their late ``coded_owner_fetch`` lands
        when the fetch completes)."""
        while self._straggler_threads:
            self._straggler_threads.pop().join()

    def _cap_pair(self, n_local: int, factor: float) -> int:
        return cap_pair_policy(n_local, factor, self.num_workers)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.mesh.device)

    def _upload_keys(self, data: np.ndarray, timer: PhaseTimer):
        """The ``(P, n_local)`` padded layout on the device as signed keys,
        the per-shard counts, and ``n_local``."""
        with timer.phase("partition"):
            shards, counts = pad_to_shards(data, self.num_workers)
            return to_signed_keys(self._upload(shards)), self._upload(counts), shards.shape[1]

    def sort(
        self, data: np.ndarray, metrics: Metrics | None = None,
        keep_on_device: bool = False, exchange: str | None = None,
        redundancy: int | None = None, redundancy_mode: str | None = None,
    ) -> np.ndarray:
        """Sort a host array; returns the globally sorted host array.

        Float keys (with NaN, ±0.0, ±inf) ride as order-preserving signed
        ints (`ops.float_order`): NaNs sort last like ``np.sort`` and come
        back canonical, never trimmed as pads.  8- and 16-bit keys sort
        as int32 (`ops.float_order.sort_narrow_keys_via_int32`): the kernels
        and the fused ring take 32- and 64-bit keys.  ``exchange``
        (``alltoall``, ``ring``, ``fused`` or ``hier``) overrides
        `JobConfig.exchange` for this call; every choice gives the same
        bits.  ``redundancy`` / ``redundancy_mode`` override the coded
        plane's settings (`parallel.coded`): r > 1 runs the ``ring``
        schedule with the replica or parity plane.

        ``keep_on_device=True`` returns a `parallel.device_result.
        DeviceSortResult` instead: the merged rows stay on the device (the
        one small stats copy is the completion barrier; no ``assemble``),
        with lazy ``to_host()``, ``consume(fn)`` and
        ``validate_on_device()``.  Integer keys only: a float job's rows
        would hold the ordered-int carrier, which a next stage would
        misread as values.  The straggler race is off there (it serves host
        ranges); the coded fault plane still applies.
        """
        data = np.asarray(data)
        kw = dict(exchange=exchange, redundancy=redundancy, redundancy_mode=redundancy_mode)
        if keep_on_device:
            if data.dtype.kind == "f":
                raise TypeError(
                    "keep_on_device supports integer keys only (float keys ride as "
                    "mapped ordered ints the consumer would misread); use sort() for floats"
                )
            return self._sort_device_impl(data, metrics, **kw)
        if data.dtype.kind == "f":
            return sort_float_keys_via_uint(self.sort, data, metrics, **kw)
        if is_narrow_int_dtype(data.dtype):
            return sort_narrow_keys_via_int32(self.sort, data, metrics, **kw)
        if len(data) == 0:
            return data.copy()
        return self._sort_ranges_impl(data, metrics, **kw)[0]

    def _sort_device_impl(
        self, data: np.ndarray, metrics: Metrics | None, exchange: str | None,
        redundancy: int | None = None, redundancy_mode: str | None = None,
    ):
        """`keep_on_device` core: dispatch, then wrap the merged rows.

        The rows come back from their signed carrier into the caller's
        dtype (8- and 16-bit keys from int32, pads clamped to the dtype's
        maximum) on the device, once.
        """
        metrics = metrics if metrics is not None else Metrics()
        key_dtype = torch.from_numpy(np.empty(0, data.dtype)).dtype
        if len(data) == 0:
            empty = torch.empty(0, dtype=key_dtype, device=self.mesh.device)
            return DeviceSortResult(empty, np.zeros(1, np.int64), 0, metrics)
        narrow = is_narrow_int_dtype(data.dtype)
        merged, c = self._dispatch_keys(
            data.astype(np.int32) if narrow else data, PhaseTimer(metrics), metrics,
            exchange, redundancy, redundancy_mode, allow_straggler=False,
        )
        keys = narrow_from_int32(merged, key_dtype) if narrow else from_signed_keys(merged, key_dtype)
        return DeviceSortResult(keys, c, len(data), metrics)

    def sort_ranges(
        self, data: np.ndarray, metrics: Metrics | None = None,
        exchange: str | None = None, redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ) -> list[np.ndarray]:
        """Like `sort`, but returns the per-shard key ranges: range ``i`` is
        the ``i``-th interval of the key space, a view into one buffer laid
        out in global order.  Float keys are the caller's to map."""
        return self._sort_ranges_impl(data, metrics, exchange, redundancy, redundancy_mode)[1]

    def _sort_ranges_impl(
        self, data: np.ndarray, metrics: Metrics | None = None,
        exchange: str | None = None, redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        data = np.asarray(data)
        if np.issubdtype(data.dtype, np.floating):
            raise TypeError("sort_ranges takes integer keys; use sort() for floats")
        if len(data) == 0:
            return data.copy(), [data.copy()]
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        merged, c = self._dispatch_keys(data, timer, metrics, exchange, redundancy, redundancy_mode)
        with timer.phase("assemble"):
            return self._assemble_ranges(merged, c, len(data), data.dtype)

    def _dispatch_keys(
        self, data: np.ndarray, timer: PhaseTimer, metrics: Metrics,
        exchange: str | None = None, redundancy: int | None = None,
        redundancy_mode: str | None = None, allow_straggler: bool = True,
    ) -> tuple[torch.Tensor | list, np.ndarray]:
        """Upload and run the shard program; ``alltoall`` with
        measured-capacity retries, ``ring`` / ``fused`` through
        `_dispatch_keys_ring`, ``hier`` through `_dispatch_keys_hier`.

        A resolved ``redundancy > 1`` forces ``ring`` (warned): the padded
        transpose has no per-step seam for the plane and the exchange
        kernel carries no plane slots.  ``hier`` downgrades to ``ring``
        (warned) when no grouping of at least 2 hosts divides the mesh.

        Returns ``(merged, c)``: the ``(P, width)`` device rows and the host
        copy of the per-shard counts — fetched together with the retry
        scalars in one small device-to-host copy, which is also the
        completion barrier — or, after a straggler serve, the host ranges
        (signed carrier) in place of the rows.
        """
        red = self._resolve_redundancy(redundancy)
        mode = self._resolve_redundancy_mode(redundancy_mode)
        exch = self._resolve_exchange(exchange)
        if red > 1 and exch != "ring":
            log.warning(
                "redundancy=%d needs the ring schedule; overriding exchange=%r to "
                "'ring' for this dispatch", red, exch,
            )
            exch = "ring"
        if exch == "hier":
            hosts = resolve_hier_hosts(self.job.hier_hosts, self.num_workers)
            if hosts >= 2:
                return self._dispatch_keys_hier(data, timer, metrics, hosts)
            log.warning(
                "exchange='hier' needs >= 4 workers grouped into >= 2 hosts (have %d); "
                "downgrading to the flat ring schedule", self.num_workers,
            )
            exch = "ring"
        if exch in ("ring", "fused"):
            return self._dispatch_keys_ring(
                data, timer, metrics, fused=exch == "fused", redundancy=red, mode=mode,
                allow_straggler=allow_straggler,
            )
        p = self.num_workers
        xs, cj, n_local = self._upload_keys(data, timer)
        cap_pair = self._cap_pair(n_local, self.job.capacity_factor)
        for attempt in range(self.job.max_capacity_retries + 1):
            with timer.phase("spmd_sort"):
                merged, out_counts, overflow, max_len = _sample_sort_shard(
                    xs, cj, mesh=self.mesh, oversample=self.job.oversample,
                    cap_pair=cap_pair, kernel=self.job.local_kernel,
                    merge_kernel=self.job.merge_kernel,
                )
                stats = torch.cat(
                    [out_counts.long(), overflow.long(), max_len.long()]
                ).cpu().numpy()
            note_alltoall_attempt(metrics, cap_pair, data.dtype.itemsize, p)
            c, ov, ml = stats[:p], stats[p : 2 * p], stats[2 * p :]
            if not ov.any():
                return merged, c
            cap_pair = self._note_retry(metrics, attempt, int(ml.max()), cap_pair, n_local)
        raise RuntimeError("sample sort bucket overflow after max retries")

    def _note_retry(
        self, metrics: Metrics, attempt: int, observed: int, cap_pair: int, n_local: int
    ) -> int:
        """Count one capacity retry; returns the capacity to retry with."""
        metrics.bump("capacity_retries")
        cap_pair = next_cap_pair(observed, cap_pair, n_local, self.num_workers)
        metrics.event("capacity_retry", observed=observed, cap_pair=cap_pair)
        log.warning(
            "bucket overflow (attempt %d, max bucket %d): retrying with "
            "cap_pair=%d", attempt + 1, observed, cap_pair,
        )
        return cap_pair

    def _plan_caps(
        self, hist: torch.Tensor, n_local: int, bytes_per_slot: int, metrics: Metrics,
        fused: bool, redundancy: int = 1, mode: str = "replicate",
    ) -> tuple[int, ...]:
        """Size the ring's steps from the measured histogram (the one extra
        ``(P, P)`` device-to-host copy the ring costs) and journal the plan
        (the coded plan where ``redundancy > 1``)."""
        hist_h = hist.cpu().numpy()
        caps = ring_caps(hist_h, n_local, self.num_workers)
        args = (metrics, caps, hist_h, n_local, self.num_workers, bytes_per_slot,
                self.job.capacity_factor)
        if redundancy > 1:
            note_coded_plan(*args, redundancy, mode=mode)
        else:
            (note_fused_plan if fused else note_ring_plan)(*args)
        return caps

    def _coded_hook(self, snapshot) -> None:
        """The fault hook of a coded dispatch, after its exchange: a loss
        surfacing here leaves the plane placed, so the raised
        `WorkerFailure` carries the snapshot (``snapshot()``) the caller
        recovers from by a local merge instead of a re-run."""
        from dsort_tpu_torch.scheduler.fault import WorkerFailure

        try:
            self.fault_hook()
        except WorkerFailure as e:
            e.coded_state = snapshot()
            raise

    def _dispatch_keys_ring(
        self, data: np.ndarray, timer: PhaseTimer, metrics: Metrics, fused: bool,
        redundancy: int = 1, mode: str = "replicate", allow_straggler: bool = True,
    ) -> tuple[torch.Tensor | list, np.ndarray]:
        """Ring counterpart of `_dispatch_keys`: plan, size, exchange.  No
        retry exists: every step's buffer is sized from the measured
        histogram before the exchange runs, and an overflow is raised as an
        invariant violation.

        ``redundancy > 1`` runs the coded schedule: the same plan and caps
        plus the replica (``mode="replicate"``) or parity plane; the fault
        hook then fires after the exchange (`_coded_hook`).  When
        `straggler_fn` names a position, its range is raced against a
        reconstruction from the plane (`_serve_straggler_ring`) and the
        dispatch returns host ranges in place of the rows.
        """
        from dsort_tpu_torch.ops.ring_kernel import fused_ring_exchange_shard

        p = self.num_workers
        coded = redundancy > 1
        xs, cj, n_local = self._upload_keys(data, timer)
        with timer.phase("spmd_sort"):
            xs_sorted, splitters, hist = _ring_plan_shard(
                xs, cj, mesh=self.mesh, oversample=self.job.oversample,
                kernel=self.job.local_kernel,
            )
            caps = self._plan_caps(
                hist, n_local, data.dtype.itemsize, metrics, fused, redundancy, mode
            )
        if not coded and self.fault_hook is not None:
            self.fault_hook()
        kw = dict(caps=caps, merge_kernel=self.job.merge_kernel, kernel=self.job.local_kernel)
        with timer.phase("spmd_sort"):
            if coded:
                shard = _parity_ring_exchange_shard if mode == "parity" else _coded_ring_exchange_shard
                outs = shard(xs_sorted, cj, splitters, redundancy=redundancy, **kw)
                merged, out_counts, overflow = outs[:3]
            elif fused:
                merged, out_counts, overflow = fused_ring_exchange_shard(
                    xs_sorted, cj, splitters, hist, **kw
                )
            else:
                merged, out_counts, overflow = _ring_exchange_shard(
                    xs_sorted, cj, splitters, **kw
                )
        if coded:
            def snapshot():
                return self._snapshot_coded(caps, redundancy, len(data), mode, outs, data.dtype)

            if self.fault_hook is not None:
                self._coded_hook(snapshot)
            s = self.straggler_fn() if allow_straggler and self.straggler_fn is not None else None
            if s is not None and 0 <= int(s) < p:
                with timer.phase("spmd_sort"):
                    return self._serve_straggler_ring(int(s), outs[0], snapshot, metrics)
        with timer.phase("spmd_sort"):
            stats = torch.cat([out_counts.long(), overflow.long()]).cpu().numpy()
        check_ring_overflow(stats[p:])
        return merged, stats[:p]

    def _dispatch_keys_hier(
        self, data: np.ndarray, timer: PhaseTimer, metrics: Metrics, hosts: int
    ) -> tuple[torch.Tensor, np.ndarray]:
        """``hier`` counterpart of `_dispatch_keys_ring`: plan once, reduce
        the measured histogram to the host matrix, run the three phases.
        No retry: every phase's buffer is sized from the histogram before
        the exchange, so an overflow is an invariant violation.  The flat
        ring's caps for the same histogram price ``dcn_bytes_saved``."""
        p = self.num_workers
        xs, cj, n_local = self._upload_keys(data, timer)
        with timer.phase("spmd_sort"):
            xs_sorted, splitters, hist = _ring_plan_shard(
                xs, cj, mesh=self.mesh, oversample=self.job.oversample,
                kernel=self.job.local_kernel,
            )
            hist_h = hist.cpu().numpy()
        caps = ring_caps(hist_h, n_local, p)
        plan = hier_plan(hist_h, n_local, p, hosts)
        note_hier_plan(
            metrics, plan, caps, hist_h, n_local, p, data.dtype.itemsize,
            self.job.capacity_factor,
        )
        if self.fault_hook is not None:
            self.fault_hook()
        with timer.phase("spmd_sort"):
            merged, out_counts, overflow = _hier_exchange_shard(
                xs_sorted, cj, splitters, hosts=plan.hosts, agg_cap=plan.agg_cap,
                leg_caps=plan.leg_caps, scatter_cap=plan.scatter_cap,
                merge_kernel=self.job.merge_kernel, kernel=self.job.local_kernel,
            )
            stats = torch.cat([out_counts.long(), overflow.long()]).cpu().numpy()
        check_ring_overflow(stats[p:])
        return merged, stats[:p]

    def _snapshot_coded(
        self, caps: tuple, redundancy: int, n: int, mode: str, outs, key_dtype,
        kv: bool = False,
    ):
        """Host snapshot of one coded exchange (`parallel.coded`): the
        survivors' trimmed ranges and the plane, the overflow invariant
        checked first.  ``outs`` is the coded shard program's whole output."""
        from dsort_tpu_torch.parallel import coded

        snap = {
            (False, "replicate"): coded.snapshot_state,
            (False, "parity"): coded.snapshot_parity_state,
            (True, "replicate"): coded.snapshot_kv_state,
            (True, "parity"): coded.snapshot_parity_kv_state,
        }[(kv, mode)]
        return snap(self.num_workers, redundancy, caps, n, *outs, key_dtype=np.dtype(key_dtype))

    def _serve_straggler_ring(self, s: int, merged: torch.Tensor, snapshot, metrics: Metrics):
        """Serve the straggler's range from whichever source finishes first:
        the owner's fetch or a reconstruction from the plane.

        Two legs race under one `parallel.coded.StragglerClaim`
        (exactly-once).  OWNER: a thread fetches row ``s`` after the extra
        latency `fetch_delay_fn` gives it, and always journals
        ``coded_owner_fetch`` (won or lost), possibly after the sort
        returned (`join_stragglers` drains it).  HOLDER: inline, takes the
        snapshot (every other range comes from it anyway) and rebuilds
        range ``s`` as if ``s`` were lost.  Only a holder win journals
        ``coded_straggler_serve``; both copies have the same bits.
        Returns ``(host ranges in the signed carrier, c)``.
        """
        from dsort_tpu_torch.device import device_scope
        from dsort_tpu_torch.parallel.coded import CodedBudgetExceeded, StragglerClaim

        claim = StragglerClaim()
        owner_box = {}

        def owner_leg():
            t0 = time.perf_counter()
            delay = self.fetch_delay_fn(s) if self.fetch_delay_fn is not None else None
            if delay:
                time.sleep(float(delay))
            with device_scope(merged.device):
                row = merged[s].cpu().numpy()
            won = claim.claim("owner")
            if won:
                owner_box["row"] = row
            metrics.event(
                "coded_owner_fetch", range=int(s), won=bool(won),
                wall_s=round(time.perf_counter() - t0, 6),
            )

        t = threading.Thread(target=owner_leg, daemon=True)
        t.start()
        t0 = time.perf_counter()
        state = snapshot()
        try:
            ranges, info = state.reconstruct([s])
        except CodedBudgetExceeded:
            # The plane cannot cover s (a degenerate tiny mesh): the owner's
            # fetch is authoritative.
            t.join()
            ranges = list(state.ranges)
            ranges[s] = owner_box["row"][: len(state.ranges[s])]
            return ranges, np.array([len(r) for r in ranges], np.int64)
        if claim.claim("holder"):
            metrics.bump("coded_straggler_serves")
            metrics.event(
                "coded_straggler_serve", range=int(s), mode=state.mode,
                holders=info.get("holders", {}).get(s),
                recovered_keys=int(len(ranges[s])),
                wall_s=round(time.perf_counter() - t0, 6),
            )
            # The owner's late response is dropped on arrival.
            self._straggler_threads.append(t)
        else:
            t.join()
            ranges[s] = owner_box["row"][: len(ranges[s])]
        return ranges, np.array([len(r) for r in ranges], np.int64)

    def _assemble_ranges(
        self, merged, c: np.ndarray, n: int, dtype
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Trim each row to its count on the device, copy the ``n`` keys to
        the host once, and hand out per-shard views of that buffer.  After a
        straggler serve ``merged`` is the list of host ranges already."""
        key_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        if isinstance(merged, list):
            if int(c.sum()) != n:
                raise RuntimeError(f"range counts sum to {int(c.sum())}, expected {n} keys")
            flat = torch.from_numpy(np.concatenate(merged))
        else:
            flat = _trim_rows(merged, c, n, "keys")
        out = from_signed_keys(flat, key_dtype).cpu().numpy()
        ranges, off = [], 0
        for ci in c:
            ranges.append(out[off : off + int(ci)])
            off += int(ci)
        return out, ranges

    def sort_kv(
        self,
        keys: np.ndarray,
        payload: np.ndarray,
        metrics: Metrics | None = None,
        secondary: np.ndarray | None = None,
        exchange: str | None = None,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """TeraSort-style key+payload sort; payload rows (``payload[i]`` of
        any trailing shape) follow their keys.

        ``secondary`` (same length as ``keys``) breaks primary-key ties —
        TeraSort's 10-byte key as the 8-byte packed prefix plus key bytes
        8-9 (`data.ingest.terasort_secondary`).  The order of records with
        equal keys (and secondaries) is not specified.  ``exchange``
        overrides `JobConfig.exchange`; a secondary needs the ``alltoall``
        combine and ``hier`` runs as ``ring`` (both warned).  ``redundancy
        > 1`` runs the coded ring with the payload in the plane too; a
        secondary key has no coded channel, so that job runs uncoded
        (warned).
        """
        keys = np.asarray(keys)
        payload = np.asarray(payload)
        kw = dict(exchange=exchange, redundancy=redundancy, redundancy_mode=redundancy_mode)
        if keys.dtype.kind == "f":
            return sort_float_keys_via_uint(self.sort_kv, keys, payload, metrics, secondary, **kw)
        if is_narrow_int_dtype(keys.dtype):
            return sort_narrow_keys_via_int32(self.sort_kv, keys, payload, metrics, secondary, **kw)
        exch = self._resolve_exchange(exchange)
        red = self._resolve_redundancy(redundancy)
        mode = self._resolve_redundancy_mode(redundancy_mode)
        if red > 1 and secondary is not None:
            log.warning(
                "redundancy=%d needs the ring schedule, which has no secondary-key "
                "channel; this two-level-key sort runs uncoded (re-run recovery)", red,
            )
            red = 1
        if red > 1 and exch != "ring":
            log.warning(
                "redundancy=%d needs the ring schedule; overriding exchange=%r to "
                "'ring' for this kv dispatch", red, exch,
            )
            exch = "ring"
        if exch == "hier":
            log.warning("exchange='hier' is keys-only; this kv sort uses the ring schedule")
            exch = "ring"
        if exch in ("ring", "fused") and secondary is not None:
            log.warning(
                "exchange=%r does not support a secondary key; using the "
                "all_to_all exchange", exch,
            )
            exch = "alltoall"
        if secondary is not None and self.job.merge_kernel not in ("sort", "auto"):
            log.warning(
                "merge_kernel=%r is not available with a secondary key; using "
                "the sort combine", self.job.merge_kernel,
            )
        if len(keys) == 0:
            return keys.copy(), payload.copy()
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        p = self.num_workers
        with timer.phase("partition"):
            sk, sv, counts = pad_kv_to_shards(keys, payload, p)
            xs = to_signed_keys(self._upload(sk))
            vs = self._upload(sv)
            cj = self._upload(counts)
            sj = None
            if secondary is not None:
                sj = to_signed_keys(self._upload(pad_to_layout(np.asarray(secondary), counts, sk.shape[1])))
        n_local = sk.shape[1]
        slot_bytes = keys.dtype.itemsize + int(np.prod(sv.shape[2:], dtype=np.int64)) * sv.dtype.itemsize
        if exch in ("ring", "fused"):
            out_k, out_v, c = self._dispatch_kv_ring(
                xs, vs, cj, n_local, slot_bytes, timer, metrics, fused=exch == "fused",
                redundancy=red, mode=mode, n=len(keys), key_dtype=keys.dtype,
            )
        else:
            cap_pair = self._cap_pair(n_local, self.job.capacity_factor)
            for attempt in range(self.job.max_capacity_retries + 1):
                with timer.phase("spmd_sort"):
                    out_k, out_v, out_counts, overflow, max_len = _kv_shard_body(
                        xs, vs, sj, cj, mesh=self.mesh, oversample=self.job.oversample,
                        cap_pair=cap_pair, merge_kernel=self.job.merge_kernel,
                        kernel=self.job.local_kernel,
                    )
                    stats = torch.cat(
                        [out_counts.long(), overflow.long(), max_len.long()]
                    ).cpu().numpy()
                note_alltoall_attempt(metrics, cap_pair, slot_bytes, p)
                c, ov, ml = stats[:p], stats[p : 2 * p], stats[2 * p :]
                if not ov.any():
                    break
                cap_pair = self._note_retry(metrics, attempt, int(ml.max()), cap_pair, n_local)
            else:
                raise RuntimeError("sample sort bucket overflow after max retries")
        with timer.phase("assemble"):
            n = len(keys)
            key_dtype = torch.from_numpy(np.empty(0, keys.dtype)).dtype
            keys_out = from_signed_keys(_trim_rows(out_k, c, n, "records"), key_dtype)
            vals_out = _trim_rows(out_v, c, n, "records")
            return keys_out.cpu().numpy(), vals_out.cpu().numpy()

    def _dispatch_kv_ring(
        self, xs, vs, cj, n_local: int, slot_bytes: int, timer: PhaseTimer,
        metrics: Metrics, fused: bool, redundancy: int = 1, mode: str = "replicate",
        n: int = 0, key_dtype=None,
    ):
        """kv ring dispatch: plan (record local sort + histogram), size,
        exchange.  ``slot_bytes`` (key + payload row) prices the wire bytes:
        each payload row moves once per step on both schedules.
        ``redundancy > 1`` runs the coded record schedule, the payload rows
        covered by the plane like their keys; its fault hook fires after the
        exchange with the record snapshot attached (`_coded_hook`)."""
        from dsort_tpu_torch.ops.ring_kernel import fused_ring_exchange_kv_shard

        p = self.num_workers
        coded = redundancy > 1
        with timer.phase("spmd_sort"):
            ks, vsort, splitters, hist = _ring_plan_kv_shard(
                xs, vs, cj, mesh=self.mesh, oversample=self.job.oversample
            )
            caps = self._plan_caps(hist, n_local, slot_bytes, metrics, fused, redundancy, mode)
        if not coded and self.fault_hook is not None:
            self.fault_hook()
        kw = dict(caps=caps, merge_kernel=self.job.merge_kernel, kernel=self.job.local_kernel)
        with timer.phase("spmd_sort"):
            if coded:
                shard = (_parity_ring_exchange_kv_shard if mode == "parity"
                         else _coded_ring_exchange_kv_shard)
                outs = shard(ks, vsort, cj, splitters, redundancy=redundancy, **kw)
                out_k, out_v, out_counts, overflow = outs[:4]
            elif fused:
                out_k, out_v, out_counts, overflow = fused_ring_exchange_kv_shard(
                    ks, vsort, cj, splitters, hist, **kw
                )
            else:
                out_k, out_v, out_counts, overflow = _ring_exchange_kv_shard(
                    ks, vsort, cj, splitters, **kw
                )
        if coded and self.fault_hook is not None:
            self._coded_hook(lambda: self._snapshot_coded(
                caps, redundancy, n, mode, outs, key_dtype, kv=True))
        with timer.phase("spmd_sort"):
            stats = torch.cat([out_counts.long(), overflow.long()]).cpu().numpy()
        check_ring_overflow(stats[p:])
        return out_k, out_v, stats[:p]


def _trim_rows(rows: torch.Tensor, c: np.ndarray, n: int, what: str) -> torch.Tensor:
    """Concatenate the first ``c[i]`` entries of every row, on the device."""
    if int(c.sum()) != n:  # a short buffer was detectable; a torn one is not
        raise RuntimeError(f"device range counts sum to {int(c.sum())}, expected {n} {what}")
    return torch.cat([rows[i, : int(c[i])] for i in range(len(c))])
