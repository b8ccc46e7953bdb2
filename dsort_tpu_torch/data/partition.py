"""Partitioning: split a key array into per-worker shards.

Counterpart of ``dsort_tpu/data/partition.py`` (numpy, host side): equal
chunks with the remainder spread one extra element each over the first
``total % num_workers`` workers, and the static ``(W, cap)`` layouts plus
per-shard counts the SPMD phases take (keys, key+payload records, and
companion channels such as a secondary key).
"""

from __future__ import annotations

import numpy as np

from dsort_tpu_torch.ops.local_sort import sentinel_for


def equal_partition(total: int, num_workers: int) -> list[int]:
    """Chunk sizes per worker, the remainder on the first workers."""
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    base, rem = divmod(total, num_workers)
    return [base + (1 if i < rem else 0) for i in range(num_workers)]


def partition(data: np.ndarray, num_workers: int) -> list[np.ndarray]:
    """Split ``data`` into contiguous chunks per `equal_partition` sizes."""
    sizes = equal_partition(len(data), num_workers)
    out, off = [], 0
    for s in sizes:
        out.append(data[off : off + s])
        off += s
    return out


def pad_to_shards(
    data: np.ndarray, num_workers: int, multiple: int = 8, cap: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Lay ``data`` out as ``(num_workers, cap)`` + per-shard valid counts.

    ``cap`` is the largest chunk rounded up to ``multiple``; pads hold the
    dtype sentinel.  An explicit ``cap`` overrides the computed one.
    """
    sizes = equal_partition(len(data), num_workers)
    if cap is None:
        cap = -(-max(sizes + [1]) // multiple) * multiple
    elif cap < max(sizes + [0]):
        raise ValueError(f"cap {cap} < largest shard {max(sizes)}")
    out = np.empty((num_workers, cap), dtype=data.dtype)
    sent = sentinel_for(data.dtype)
    off = 0
    for i, s in enumerate(sizes):
        out[i, :s] = data[off : off + s]
        out[i, s:] = sent
        off += s
    return out, np.asarray(sizes, dtype=np.int32)


def pad_to_layout(
    data: np.ndarray, counts: np.ndarray, cap: int, fill=0
) -> np.ndarray:
    """Lay ``data`` out as ``(len(counts), cap)`` with the shard sizes a
    prior `pad_to_shards` / `pad_kv_to_shards` computed (a companion
    channel such as a secondary sort key).  Pads hold ``fill``."""
    out = np.full((len(counts), cap) + data.shape[1:], fill, dtype=data.dtype)
    off = 0
    for i, s in enumerate(np.asarray(counts)):
        out[i, :s] = data[off : off + s]
        off += s
    return out


def pad_kv_to_shards(
    keys: np.ndarray,
    payload: np.ndarray,
    num_workers: int,
    multiple: int = 8,
    cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Key+payload variant of `pad_to_shards`: key pads hold the sentinel,
    payload pads are zeros.  Returns ``(keys (W, cap), payload (W, cap,
    ...), counts)``."""
    sizes = equal_partition(len(keys), num_workers)
    if cap is None:
        cap = -(-max(sizes + [1]) // multiple) * multiple
    elif cap < max(sizes + [0]):
        raise ValueError(f"cap {cap} < largest shard {max(sizes)}")
    out_k = np.full((num_workers, cap), sentinel_for(keys.dtype), dtype=keys.dtype)
    out_v = np.zeros((num_workers, cap) + payload.shape[1:], dtype=payload.dtype)
    off = 0
    for i, s in enumerate(sizes):
        out_k[i, :s] = keys[off : off + s]
        out_v[i, :s] = payload[off : off + s]
        off += s
    return out_k, out_v, np.asarray(sizes, dtype=np.int32)
