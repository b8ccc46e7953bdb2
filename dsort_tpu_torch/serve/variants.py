"""The variant cache, keyed on the capacity ladder.

Counterpart of ``dsort_tpu/serve/variants.py``, with the same keys, LRU
bound and hit / miss / eviction / prewarm counters.  The 8-aligned rung
quantization (`models.pipelines.pad_rung` for the fused small-job route,
`parallel.sample_sort.cap_pair_policy` for the SPMD buffers) exists so a
job's program is reusable across jobs of nearby sizes; `VariantCache`
holds, counts and prewarms those variants.  A fused variant is
`models.pipelines._fused_small_fn` (the rung's padded-row sort, which
holds no device buffer); on the card there is no XLA compile, and the
first call of a variant on a slice stream (the kernels' library load, the
launch attributes, the allocator's growth) is what the prewarm pays ahead
of traffic and `obs.prof` times.  The SPMD path stores a token
(`SampleSort` owns its buffers).

Thread-safe; builders run outside the lock.  Two racing builders for one
key both build and the last insert wins.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


def fused_variant_key(n_keys: int, dtype_str: str, kernel: str) -> tuple:
    """The fused path's cache key: the padded ladder rung, not the raw size
    — every job size inside one rung shares one variant."""
    from dsort_tpu_torch.models.pipelines import pad_rung

    return ("fused", pad_rung(max(int(n_keys), 1)), dtype_str, kernel)


def spmd_variant_key(
    n_keys: int, num_workers: int, dtype_str: str, kernel: str,
    capacity_factor: float, exchange: str,
) -> tuple:
    """The SPMD path's cache key: per-shard length plus the policy bucket
    capacity — the pair the sample sort's buffers are sized by."""
    from dsort_tpu_torch.parallel.sample_sort import cap_pair_policy

    n_local = -(-max(int(n_keys), 1) // num_workers)
    cap = cap_pair_policy(n_local, capacity_factor, num_workers)
    return ("spmd", num_workers, n_local, cap, dtype_str, kernel, exchange)


class VariantCache:
    """LRU map of rung key -> compiled variant, with journaled counters."""

    #: Stored for keys whose executable lives elsewhere (`note`).
    TOKEN = object()

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prewarmed = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list[tuple]:
        """Snapshot of the cached variant keys (LRU order, oldest first)."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "prewarmed": self.prewarmed,
            }

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def _insert(self, key: tuple, value, metrics) -> None:
        # Caller does NOT hold the lock.
        evicted = 0
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
        if evicted and metrics is not None:
            metrics.bump("variant_cache_evictions", evicted)

    def _lookup(self, key: tuple, metrics):
        """(found, value); counts the hit/miss and refreshes LRU order."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                found, value = True, self._entries[key]
            else:
                self.misses += 1
                found, value = False, None
        if metrics is not None:
            metrics.bump(
                "variant_cache_hits" if found else "variant_cache_misses"
            )
        return found, value

    def get_or_build(self, key: tuple, builder, metrics=None):
        """The cached variant for ``key``, building it on a miss."""
        found, value = self._lookup(key, metrics)
        if found:
            return value
        value = builder()  # outside the lock: a build may be slow
        self._insert(key, value, metrics)
        return value

    def note(self, key: tuple, metrics=None) -> bool:
        """Hit/miss accounting for a variant whose program is owned
        elsewhere (the SPMD path's `SampleSort`); returns whether the key
        was already cached."""
        found, _ = self._lookup(key, metrics)
        if not found:
            self._insert(key, self.TOKEN, metrics)
        return found

    def prewarm(self, key: tuple, builder) -> tuple:
        """Insert ``key`` without counting a miss OR a hit (startup
        prewarm); returns ``(value, fresh)`` — ``fresh`` is False when the
        entry already existed."""
        with self._lock:
            if key in self._entries:
                return self._entries[key], False
        value = builder()
        with self._lock:
            fresh = key not in self._entries
            if fresh:
                self.prewarmed += 1
            else:
                value = self._entries[key]
        if fresh:
            self._insert(key, value, None)
        return value, fresh
