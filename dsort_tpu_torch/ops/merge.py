"""Merging sorted runs: the host merges and the on-device merge of shards.

Counterpart of ``dsort_tpu/ops/merge.py``.  The reference's own combine is
a single-threaded O(N*k) min-scan on the master (``server.c:481-524``);
these replace it:

- `merge_sorted_host`: pairwise two-way merges on the host, log2(k) rounds
  of ``np.concatenate`` plus a stable sort (timsort's galloping makes the
  sort of two sorted runs near-linear).  The JAX package first tries its
  native C++ k-way merge (``runtime/native``), which is not ported; the
  numpy path is that module's own fallback and gives the same bits, so it
  is the only path here;
- `merge_sorted_host_kv`: the key+payload twin, stable in run order;
- `merge_sorted_host_streaming`: a ``heapq`` k-way generator;
- `merge_shards_device`: ``(W, cap)`` sorted padded runs merged on the
  device by one flat `ops.local_sort.sort_keys` (``torch.sort``, the role
  ``lax.sort`` plays in the reference).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from dsort_tpu_torch.ops.local_sort import sort_keys


def merge_sorted_host(chunks: list[np.ndarray]) -> np.ndarray:
    """Merge sorted host arrays into one sorted array (O(N log k)).

    Empty chunks are dropped; with none left the result is empty, in the
    first chunk's dtype (int32 when there is no chunk at all).
    """
    dtype = np.asarray(chunks[0]).dtype if chunks else np.int32
    runs = [np.asarray(c) for c in chunks if len(c)]
    if not runs:
        return np.empty(0, dtype=dtype)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            merged = np.concatenate([runs[i], runs[i + 1]])
            merged.sort(kind="stable")
            nxt.append(merged)
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def merge_sorted_host_kv(
    key_runs: list[np.ndarray], val_runs: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Stable k-way merge of sorted (key, payload-rows) run pairs.

    Pairwise two-way merges: each side's output positions come from one
    ``searchsorted`` against the other (``left`` for the first run,
    ``right`` for the second, so earlier runs win ties and the merge is
    stable in run order); payload rows follow the same scatter and are
    never compared.
    """
    runs = [
        (np.asarray(k), np.asarray(v))
        for k, v in zip(key_runs, val_runs) if len(k)
    ]
    if not runs:
        k0 = np.asarray(key_runs[0]) if key_runs else np.empty(0, np.int32)
        v0 = np.asarray(val_runs[0]) if val_runs else np.empty(0, np.int32)
        return k0[:0].copy(), v0[:0].copy()
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            (ka, va), (kb, vb) = runs[i], runs[i + 1]
            pa = np.arange(len(ka)) + np.searchsorted(kb, ka, side="left")
            pb = np.arange(len(kb)) + np.searchsorted(ka, kb, side="right")
            out_k = np.empty(len(ka) + len(kb), ka.dtype)
            out_v = np.empty((len(ka) + len(kb),) + va.shape[1:], va.dtype)
            out_k[pa], out_k[pb] = ka, kb
            out_v[pa], out_v[pb] = va, vb
            nxt.append((out_k, out_v))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def merge_sorted_host_streaming(chunks: list[np.ndarray]):
    """Generator form (``heapq`` k-way) for bounded-memory egress."""
    return heapq.merge(*[iter(c) for c in chunks])


def merge_shards_device(
    shards: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``(W, cap)`` sorted padded runs into one ``(W*cap,)`` sorted run.

    Pads (the dtype sentinel) already sit at each run's tail, so one flat
    re-sort leaves the valid keys in the prefix of length ``sum(counts)``;
    returns ``(flat, total)`` with ``total`` an int32 scalar tensor.
    """
    flat = shards.reshape(-1)
    return sort_keys(flat), counts.sum().to(torch.int32)
