"""Fused ring exchange: every step of the ring in one CUDA launch, one merge.

Counterpart of ``dsort_tpu/ops/ring_kernel.py``.  The reference runs the
whole P-1-step ring as one Pallas kernel per device: step ``k``'s bucket
leaves as an async remote DMA into a ``caps[k]``-long slot of the receiver's
output, and an in-kernel bitonic merge network folds the landed runs (R1
`_fused_ring_kernel` for keys, R2 `_fused_ring_kv_kernel` for records, which
also moves each payload row once and permutes it in the kernel).  On one
card the P shards are the rows of one tensor, so:

  ===========================  ===============================  =======================
  CUDA kernel (wrapper)        replaces                         plain version
  ===========================  ===============================  =======================
  ring_exchange_kernel         the remote copies of R1 / R2:    `ring_exchange_plain`
  (`ring_exchange`)            all P x P (destination, step)
                               slots in ONE launch
  block kernels, rank plane    R1 / R2's merge network          their plain versions
  (`block_sort.merge_          (keys; ``(key, tag)`` for kv)    (`ops.block_sort`)
  alternating_runs`)
  gather_rows_kernel           R2's in-kernel payload           `gather_rows_plain`
  (`gather_rows`)              placement
  ===========================  ===============================  =======================

The exchange kernel writes each destination row as ``ceil_pow2(P)`` slots of
``ceil_pow2(max caps)`` keys, odd slots reversed — the bitonic merge entry —
with the sentinel (and, for kv, tag ``2 * total + pos``) past each bucket,
so the block kernels merge it in place with no pad or flip pass; the
first ``sum(caps)`` keys of each merged row are the output.  kv tags are
the reference's plane, ``offs[k] + pos + is_pad * total``: ``(key, tag)``
is a total order, so the merged permutation — and the payload — equals the
lax ring's exactly.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; anything else raises.  `launch_counts` counts the
launches (``ring_exchange_kernel+kv`` for the records variant).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dsort_tpu_torch.ops.errors import KernelLaunchError
from dsort_tpu_torch.ops.local_sort import sentinel_for

#: Transfer dispatches per fused exchange: the whole P-1-step ring is one
#: exchange-kernel launch.
DISPATCHES_PER_FUSED_EXCHANGE = 1

#: SPMD contract (parsed, not imported — `dsort_tpu_torch.analysis.spmd`).
#: ``layouts`` puts the exchange kernel's slot layout under the DS1204
#: proof: `ring_exchange_plain` (the layout the CUDA kernel writes,
#: chip_smoke.py holds the two equal bit for bit) is evaluated step by step
#: over sample caps, and every step's writes must be disjoint from every
#: other step's and lie inside their buffers; ``caps`` pins `_step_offsets`
#: to the exact partial-sum layout the kv tag plane and the payload
#: workspace index.
SPMD_CONTRACT = {
    "plane": "device",
    "layouts": {
        "ring_exchange_plain": {"axis": "p", "caps": "caps"},
    },
    "caps": {
        "_step_offsets": {
            "args": ("caps",),
            "domain": {"caps": "CAPS_SAMPLES"},
            "require": (
                ("DS1302", "out[0] == 0"),
                ("DS1302", "len(out) == len(caps) + 1"),
                (
                    "DS1302",
                    "all(out[i + 1] == out[i] + caps[i]"
                    " for i in range(len(caps)))",
                ),
            ),
        },
    },
}

_MAX_SHARDS = 128  # csrc/ring_exchange.cu kMaxShards
_KEY_DTYPES = (torch.int32, torch.int64)

_LAUNCHES = {"ring_exchange_kernel": 0, "ring_exchange_kernel+kv": 0, "gather_rows_kernel": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per CUDA kernel name."""
    return dict(_LAUNCHES)


def _ceil_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _step_offsets(caps) -> list[int]:
    """Offset of each step's slot in the flat ``(sum(caps),)`` layout the kv
    tags index; slot 0 (the shard's own bucket) at 0."""
    offs = [0]
    for c in caps:
        offs.append(offs[-1] + int(c))
    return offs


def _slot_len(caps) -> int:
    """Slot length of the merge layout: the largest cap, to a power of two."""
    return _ceil_pow2(max(int(c) for c in caps))


def _send_runs(lens: torch.Tensor, caps) -> torch.Tensor:
    """Per-source overflow flag: does any step's run, ``lens[src, (src + k)
    % P]``, exceed ``caps[k]``?  The runs themselves are read in place by
    the exchange kernel, which takes the ``(P, P)`` bounds."""
    p = lens.shape[0]
    src = torch.arange(p, device=lens.device).unsqueeze(1)
    step = torch.arange(p, device=lens.device).unsqueeze(0)
    cap = torch.as_tensor([int(c) for c in caps], device=lens.device)
    return (lens.gather(1, (src + step) % p) > cap).any(dim=1)


def _recv_lens(hist: torch.Tensor) -> torch.Tensor:
    """Records each destination receives, from the plan's ``(P, P)``
    histogram — no extra exchange (the kernel reads each step's length,
    ``hist[(d - k) % P, d]``, itself)."""
    return hist.sum(dim=0)


def _fused_eager(merge_kernel: str, kernel: str, dtype, total: int, device) -> bool:
    """The ring's eager-vs-deferred rule, with a CUDA launch read as the
    reference's compiled kernel: always the merge network.  On the CPU the
    runs merge only where the combine resolves to a run merge, and are
    otherwise sorted once."""
    from dsort_tpu_torch.parallel.sample_sort import _resolve_merge_kernel

    if torch.device(device).type == "cuda":
        return True
    return _resolve_merge_kernel(merge_kernel, kernel, dtype, total, device) != "sort"


def _payload_bytes(payload: torch.Tensor) -> torch.Tensor:
    """``(P, n, ...)`` payload as ``(P, n, row_bytes)`` uint8 (a view)."""
    p, n = payload.shape[:2]
    return payload.contiguous().reshape(p, n, -1).view(torch.uint8)


# -- plain PyTorch versions --------------------------------------------------


def ring_exchange_plain(xs, starts, lens, caps, payload=None):
    """The exchange kernel's result with tensor ops: ``(wk (P, P2 * slot),
    wt (P, P2 * slot) int32 or None, wv (P, total, row_bytes) uint8 or
    None)`` in the merge layout described above; ``payload`` is ``(P,
    n_local, row_bytes)`` uint8 or None (keys alone)."""
    from dsort_tpu_torch.ops.local_sort import _apply_perm

    p, n_local = xs.shape
    dev = xs.device
    p2, slot = _ceil_pow2(p), _slot_len(caps)
    offs = _step_offsets(caps)
    total = offs[-1]
    sent = sentinel_for(xs.dtype)
    wk = torch.full((p, p2, slot), sent, dtype=xs.dtype, device=dev)
    wt = wv = None
    if payload is not None:
        beyond = 2 * total + torch.arange(slot, device=dev)
        wt = beyond.to(torch.int32).expand(p, p2, slot).clone()
        wv = torch.zeros((p, total, payload.shape[2]), dtype=torch.uint8, device=dev)
    d = torch.arange(p, device=dev)
    for k in range(p):
        s, cap = (d - k) % p, int(caps[k])
        ln = torch.clamp(lens[s, d], max=cap)
        pos = torch.arange(cap, device=dev)
        idx = (starts[s, d].unsqueeze(1) + pos).clamp(0, max(n_local - 1, 0))
        valid = pos < ln.unsqueeze(1)
        wk[:, k, :cap] = torch.where(valid, xs[s].gather(1, idx), sent)
        if payload is not None:
            wt[:, k, :cap] = (offs[k] + pos + (~valid) * total).to(torch.int32)
            rows = _apply_perm(payload[s], idx)
            wv[:, offs[k] : offs[k] + cap] = torch.where(valid.unsqueeze(2), rows, 0)
    wk[:, 1::2] = wk[:, 1::2].flip(-1)
    if wt is not None:
        wt[:, 1::2] = wt[:, 1::2].flip(-1)
        wt = wt.reshape(p, p2 * slot)
    return wk.reshape(p, p2 * slot), wt, wv


def gather_rows_plain(ws: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """``out[d, i] = ws[d, tags[d, i]]`` where the tag is a real position
    (``< total``), ``ws[d, 0]`` otherwise; ``ws (P, total, row_bytes)``."""
    from dsort_tpu_torch.ops.local_sort import _apply_perm

    total = ws.shape[1]
    return _apply_perm(ws, torch.where((tags >= 0) & (tags < total), tags, 0))


# -- kernel wrappers ---------------------------------------------------------


def _route(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"ring exchange kernels run on cuda or cpu, not {x.device}")


def _check_exchange(xs, starts, lens, caps, payload) -> None:
    if xs.dim() != 2 or xs.dtype not in _KEY_DTYPES or not xs.is_contiguous():
        raise ValueError(
            f"keys must be a contiguous (P, n_local) int32/int64 tensor, got "
            f"{xs.dtype} {tuple(xs.shape)}"
        )
    p = xs.shape[0]
    if not 2 <= p <= _MAX_SHARDS:
        raise ValueError(f"the exchange kernel takes 2..{_MAX_SHARDS} shards, got {p}")
    for name, t in (("starts", starts), ("lens", lens)):
        if t.shape != (p, p) or t.dtype != torch.int64 or not t.is_contiguous() \
                or t.device != xs.device:
            raise ValueError(f"{name} must be a contiguous ({p}, {p}) int64 tensor on {xs.device}")
    if len(caps) != p or min(int(c) for c in caps) < 1:
        raise ValueError(f"need {p} positive step caps, got {tuple(caps)}")
    if payload is not None and sum(int(c) for c in caps) >= 2**29:
        # kv tags reach 2 * total + slot: they must fit int32.
        raise ValueError("sum(caps) leaves no int32 room for the kv tags (total < 2^29)")
    if payload is not None and (
        payload.dim() != 3 or payload.shape[:2] != xs.shape
        or payload.dtype != torch.uint8 or not payload.is_contiguous()
        or payload.device != xs.device
    ):
        raise ValueError("payload must be a contiguous (P, n_local, row_bytes) uint8 tensor")


def ring_exchange(xs, starts, lens, caps, payload=None):
    """Every (destination, step) slot of the ring in one launch; see
    `ring_exchange_plain` for the result.  ``starts`` / ``lens`` are the
    plan's ``(P, P)`` bucket bounds of the sorted shards ``xs``."""
    _check_exchange(xs, starts, lens, caps, payload)
    if not _route(xs):
        return ring_exchange_plain(xs, starts, lens, caps, payload)
    from dsort_tpu_torch.ops._build import library

    p, n_local = xs.shape
    p2, slot = _ceil_pow2(p), _slot_len(caps)
    total = sum(int(c) for c in caps)
    dev = xs.device
    wk = torch.empty((p, p2 * slot), dtype=xs.dtype, device=dev)
    wt = wv = None
    row_bytes = 0
    if payload is not None:
        row_bytes = payload.shape[2]
        wt = torch.empty((p, p2 * slot), dtype=torch.int32, device=dev)
        wv = torch.empty((p, total, row_bytes), dtype=torch.uint8, device=dev)
    suffix = "i32" if xs.dtype == torch.int32 else "i64"
    fn = getattr(library(), f"dsort_ring_exchange_{suffix}")
    host_caps = (ctypes.c_longlong * p)(*(int(c) for c in caps))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = fn(
            xs.data_ptr(), starts.data_ptr(), lens.data_ptr(), ptr(payload),
            wk.data_ptr(), ptr(wt), ptr(wv), p, n_local, slot, row_bytes,
            host_caps, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError("ring_exchange", err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES["ring_exchange_kernel" + ("" if payload is None else "+kv")] += 1
    return wk, wt, wv


def gather_rows(ws: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """Payload placement by the merged tags; see `gather_rows_plain`.
    ``tags`` is ``(P, total)`` int32 with unit column stride (a leading
    slice of the merged rows is fine)."""
    if ws.dim() != 3 or ws.dtype != torch.uint8 or not ws.is_contiguous():
        raise ValueError("workspace must be a contiguous (P, total, row_bytes) uint8 tensor")
    if tags.shape != ws.shape[:2] or tags.dtype != torch.int32 or tags.stride(1) != 1 \
            or tags.device != ws.device:
        raise ValueError(f"tags must be ({ws.shape[0]}, {ws.shape[1]}) int32 rows on {ws.device}")
    if not _route(ws):
        return gather_rows_plain(ws, tags)
    from dsort_tpu_torch.ops._build import library

    out = torch.empty_like(ws)
    with torch.cuda.device(ws.device):
        err = library().dsort_gather_rows(
            ws.data_ptr(), tags.data_ptr(), out.data_ptr(), ws.shape[0], ws.shape[1],
            tags.stride(0), ws.shape[2], torch.cuda.current_stream(ws.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError("gather_rows", err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES["gather_rows_kernel"] += 1
    return out


# -- shard-level entries ------------------------------------------------------


def fused_ring_exchange_shard(
    xs, counts, splitters, hist, *, caps: tuple,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Fused counterpart of `exchange._ring_exchange_shard`, same contract
    and bit-identical output: ``(merged (P, sum(caps)), out_count (P,),
    overflow (P,))``.  ``hist`` is the plan's ``(P, P)`` histogram, which
    supplies the counts."""
    from dsort_tpu_torch.ops.block_sort import merge_alternating_runs
    from dsort_tpu_torch.ops.local_sort import sort_with_kernel
    from dsort_tpu_torch.parallel.exchange import _bucket_bounds

    caps = tuple(int(c) for c in caps)
    total = sum(caps)
    starts, lens = _bucket_bounds(xs, counts, splitters)
    wk, _, _ = ring_exchange(xs, starts, lens, caps)
    if _fused_eager(merge_kernel, kernel, xs.dtype, total, xs.device):
        merge_alternating_runs(wk, _slot_len(caps))
    else:
        wk = sort_with_kernel(wk, kernel)
    return wk[:, :total].contiguous(), _recv_lens(hist), _send_runs(lens, caps)


def fused_ring_exchange_kv_shard(
    keys, payload, counts, splitters, hist, *, caps: tuple,
    merge_kernel: str = "auto", kernel: str = "lax",
):
    """Fused counterpart of `exchange._ring_exchange_kv_shard`: keys and
    payload rows move once (the exchange kernel), the ``(key, tag)`` merge
    runs on the block kernels' rank plane, and the payload is placed once
    by the merged tags (`gather_rows`).  Returns ``(keys (P, total),
    payload (P, total, ...), out_count (P,), overflow (P,))``."""
    from dsort_tpu_torch.ops.block_sort import merge_alternating_runs
    from dsort_tpu_torch.ops.local_sort import sort_pairs
    from dsort_tpu_torch.parallel.exchange import _bucket_bounds

    caps = tuple(int(c) for c in caps)
    total = sum(caps)
    p = keys.shape[0]
    trailing = tuple(payload.shape[2:])
    starts, lens = _bucket_bounds(keys, counts, splitters)
    wk, wt, wv = ring_exchange(keys, starts, lens, caps, _payload_bytes(payload))
    if _fused_eager(merge_kernel, kernel, keys.dtype, total, keys.device):
        merge_alternating_runs(wk, _slot_len(caps), wt)
    else:
        wk, wt = sort_pairs(wk, wt)
    out_v = gather_rows(wv, wt[:, :total])
    out_v = out_v.view(payload.dtype).reshape((p, total) + trailing)
    return wk[:, :total].contiguous(), out_v, _recv_lens(hist), _send_runs(lens, caps)
