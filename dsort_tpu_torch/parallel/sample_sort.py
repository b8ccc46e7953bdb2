"""Distributed sample sort over a `VirtualMesh`: splitters, all_to_all, merge.

Counterpart of ``dsort_tpu/parallel/sample_sort.py``'s keys path with the
``alltoall`` exchange.  The reference runs one program per device under
``shard_map``; here the P shards are the rows of one tensor, so each phase
is one batched call:

  1. local sort of every shard (`ops.local_sort.sort_padded`; ``auto`` picks
     the block-bitonic CUDA kernels for integer keys >= 2^16 on a GPU);
  2. ``oversample`` samples per shard, all_gather, P-1 splitters — with the
     reference's float32 index arithmetic, so per-shard counts match it;
  3. contiguous bucket slices into a ``(P_src, P_dst, cap_pair)`` buffer;
  4. all_to_all, a transpose on the virtual mesh;
  5. merge of each destination's P received runs (`ops.block_sort.
     block_merge_runs` under ``merge_kernel="auto"`` on a GPU).

A bucket larger than ``cap_pair`` overflows; the host then retries with a
capacity sized from the measured largest bucket (`next_cap_pair`).

Keys ride as signed ints: unsigned keys through the sign-bit flip and float
keys through `ops.float_order`, both order-preserving, so splitters, bucket
bounds and per-shard counts are those of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.data.partition import pad_to_shards
from dsort_tpu_torch.ops.float_order import (
    float_to_ordered_int,
    from_signed_keys,
    is_float_key_dtype,
    ordered_int_to_float,
    to_signed_keys,
)
from dsort_tpu_torch.ops.local_sort import (
    resolve_kernel,
    sentinel_for,
    sort_keys,
    sort_padded,
    sort_with_kernel,
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
    bucket sizes, ``overflow`` per source shard.  Keys equal to a splitter
    go to its right bucket (``right=False``), so bucket d holds exactly
    ``[splitters[d-1], splitters[d])``.
    """
    p, n_local = xs_sorted.shape
    dev = xs_sorted.device
    cnt = counts.long().unsqueeze(1)
    bounds = torch.searchsorted(
        xs_sorted, splitters.unsqueeze(0).expand(p, -1).contiguous(), right=False
    )
    bounds = torch.minimum(bounds.clamp(min=0), cnt)
    zero = torch.zeros((p, 1), dtype=bounds.dtype, device=dev)
    starts = torch.cat([zero, bounds], dim=1)
    ends = torch.cat([bounds, cnt], dim=1)
    lens = (ends - starts).clamp(min=0)
    overflow = (lens > cap_pair).any(dim=1)
    ar = torch.arange(cap_pair, device=dev)
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
    level, ``sort`` re-sorts flat through the job's local kernel.
    """
    p_dst, p_src, cap = recv.shape
    merge_kernel = _resolve_merge_kernel(
        merge_kernel, kernel, recv.dtype, p_src * cap, recv.device
    )
    if merge_kernel == "block_merge":
        from dsort_tpu_torch.ops.block_sort import block_merge_runs

        return block_merge_runs(recv)
    if merge_kernel == "sort":
        return sort_with_kernel(recv.reshape(p_dst, p_src * cap), kernel)
    raise NotImplementedError(
        f"merge kernel {merge_kernel!r} is not yet ported to dsort_tpu_torch"
    )


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


class SampleSort:
    """Host-facing driver of the sample sort over a `VirtualMesh`.

    Handles the padded layout, the upload, the measured-capacity retries and
    the assembly of the sorted output.
    """

    def __init__(self, mesh: VirtualMesh, job: JobConfig | None = None):
        self.mesh = mesh
        self.job = job or JobConfig()
        self.num_workers = mesh.num_workers

    def _resolve_exchange(self, exchange: str | None) -> str:
        exch = exchange if exchange is not None else self.job.exchange
        if exch not in ("alltoall", "ring", "fused", "hier"):
            raise ValueError(
                "exchange must be 'alltoall', 'ring', 'fused' or 'hier', "
                f"got {exch!r}"
            )
        if self.num_workers == 1 or exch == "alltoall":
            return "alltoall"
        raise NotImplementedError(
            f"exchange={exch!r} is not yet ported to dsort_tpu_torch"
        )

    def _cap_pair(self, n_local: int, factor: float) -> int:
        return cap_pair_policy(n_local, factor, self.num_workers)

    def sort(
        self, data: np.ndarray, metrics: Metrics | None = None,
        exchange: str | None = None,
    ) -> np.ndarray:
        """Sort a host array; returns the globally sorted host array.

        Float keys (with NaN, ±0.0, ±inf) ride as order-preserving signed
        ints (`ops.float_order`): NaNs sort last like ``np.sort`` and come
        back canonical, never trimmed as pads.
        """
        data = np.asarray(data)
        if len(data) == 0:
            return data.copy()
        t = torch.from_numpy(np.ascontiguousarray(data))
        if is_float_key_dtype(t.dtype):
            mapped = float_to_ordered_int(t).numpy()
            out = self._sort_ranges_impl(mapped, metrics, exchange)[0]
            return ordered_int_to_float(torch.from_numpy(out), t.dtype).numpy()
        return self._sort_ranges_impl(data, metrics, exchange)[0]

    def sort_ranges(
        self, data: np.ndarray, metrics: Metrics | None = None,
        exchange: str | None = None,
    ) -> list[np.ndarray]:
        """Like `sort`, but returns the per-shard key ranges: range ``i`` is
        the ``i``-th interval of the key space, a view into one buffer laid
        out in global order.  Float keys are the caller's to map."""
        return self._sort_ranges_impl(data, metrics, exchange)[1]

    def _sort_ranges_impl(
        self, data: np.ndarray, metrics: Metrics | None = None,
        exchange: str | None = None,
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        data = np.asarray(data)
        if np.issubdtype(data.dtype, np.floating):
            raise TypeError("sort_ranges takes integer keys; use sort() for floats")
        if len(data) == 0:
            return data.copy(), [data.copy()]
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        merged, c = self._dispatch_keys(data, timer, metrics, exchange)
        with timer.phase("assemble"):
            return self._assemble_ranges(merged, c, len(data), data.dtype)

    def _dispatch_keys(
        self, data: np.ndarray, timer: PhaseTimer, metrics: Metrics,
        exchange: str | None = None,
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Upload and run the shard program with measured-capacity retries.

        Returns ``(merged, c)``: the ``(P, P*cap)`` device rows and the host
        copy of the per-shard counts — fetched together with the retry
        scalars in one small device-to-host copy, which is also the
        completion barrier.
        """
        self._resolve_exchange(exchange)
        p = self.num_workers
        with timer.phase("partition"):
            shards, counts = pad_to_shards(data, p)
            xs = to_signed_keys(torch.from_numpy(shards).to(self.mesh.device))
            cj = torch.from_numpy(counts).to(self.mesh.device)
        n_local = shards.shape[1]
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
            c, ov, ml = stats[:p], stats[p : 2 * p], stats[2 * p :]
            if not ov.any():
                return merged, c
            metrics.bump("capacity_retries")
            observed = int(ml.max())
            cap_pair = next_cap_pair(observed, cap_pair, n_local, p)
            metrics.event("capacity_retry", observed=observed, cap_pair=cap_pair)
            log.warning(
                "bucket overflow (attempt %d, max bucket %d): retrying with "
                "cap_pair=%d", attempt + 1, observed, cap_pair,
            )
        raise RuntimeError("sample sort bucket overflow after max retries")

    def _assemble_ranges(
        self, merged: torch.Tensor, c: np.ndarray, n: int, dtype
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Trim each row to its count on the device, copy the ``n`` keys to
        the host once, and hand out per-shard views of that buffer."""
        if int(c.sum()) != n:  # a short buffer was detectable; a torn one is not
            raise RuntimeError(f"device range counts sum to {int(c.sum())}, expected {n} keys")
        dense = torch.cat([merged[i, : int(c[i])] for i in range(len(c))])
        key_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        out = from_signed_keys(dense, key_dtype).cpu().numpy()
        ranges, off = [], 0
        for ci in c:
            ranges.append(out[off : off + int(ci)])
            off += int(ci)
        return out, ranges
