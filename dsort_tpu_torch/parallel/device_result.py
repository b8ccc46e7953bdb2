"""Device-resident sort results: the sorted keys stay on the card.

Counterpart of ``dsort_tpu/parallel/device_result.py``.  Every
``keep_on_device=True`` driver (`SampleSort.sort`, `models.pipelines.
fused_sort_small`, `scheduler.SpmdScheduler.sort`) returns a
`DeviceSortResult` instead of host keys, so a caller that feeds the sort
into the next computation, or only wants it checked, never pays the
device-to-host copy:

- the sorted keys stay on the device as ``P`` equal-length rows, pads (the
  dtype's maximum) at positions ``>= shard_lengths[i]`` of row ``i``; rows
  trimmed to their lengths concatenate to the sorted output;
- ``to_host()`` is the only device-to-host copy of keys, lazy and cached;
- ``consume(fn)`` hands the padded rows to a next stage on the device;
- ``validate_on_device()`` runs ``dsort validate``'s order check and FNV-1a
  multiset checksum on the device (`models.validate`): three scalars come
  back, not the keys.

Keys are always in the caller's dtype: the drivers map unsigned keys back
from their signed carrier, and 8- and 16-bit keys back from int32, once,
when they make the handle.

Fault semantics: `SpmdScheduler` registers every handle it returns and
invalidates them when the mesh re-forms over survivors; an invalidated
handle re-runs the sort on the current mesh at its next use (counter
``device_handle_reruns``).  On one card the buffer outlives any virtual
worker, but the contract is the reference's: a re-form invalidates.
"""

from __future__ import annotations

import numpy as np
import torch

from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("device_result")


class DeviceSortResult:
    """Handle to a sorted array left resident on its device.

    ``data`` is any tensor of ``P * cap`` keys, row ``i`` of its ``(P, cap)``
    view holding the ``i``-th key interval sorted ascending, with the
    dtype's maximum at positions ``>= shard_lengths[i]``.  Making a handle
    with ``metrics`` counts it (``device_handles``) and journals
    ``device_handle``.
    """

    def __init__(self, data: torch.Tensor, shard_lengths, n: int, metrics=None,
                 label: str = "sort"):
        self._data = data.reshape(-1)
        # Captured up front: invalidation drops `_data`, but dtype must keep
        # answering (an empty to_host, repr during drills).
        self._dtype = torch.empty(0, dtype=data.dtype).numpy().dtype
        self.shard_lengths = np.asarray(shard_lengths, dtype=np.int64)
        self.n = int(n)
        self.label = label
        self._metrics = metrics
        self._host: np.ndarray | None = None
        self._consumed = False
        self._invalidated = False
        self._invalid_reason: str | None = None
        #: Optional zero-argument callable returning a fresh handle for the
        #: same job: `SpmdScheduler` wires it so a handle a mesh re-form
        #: invalidated re-runs instead of erroring.
        self._rerun = None
        if metrics is not None:
            metrics.bump("device_handles")
            metrics.event("device_handle", n_keys=self.n, shards=self.num_shards)

    # -- identity ----------------------------------------------------------

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def num_shards(self) -> int:
        return len(self.shard_lengths)

    @property
    def offsets(self) -> np.ndarray:
        """Global start offset of each shard's valid run, then the total."""
        return np.concatenate([[0], np.cumsum(self.shard_lengths)]).astype(np.int64)

    @property
    def valid(self) -> bool:
        return not (self._invalidated or self._consumed)

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        state = (
            "consumed" if self._consumed
            else f"invalidated({self._invalid_reason})" if self._invalidated
            else "live"
        )
        return (
            f"DeviceSortResult(n={self.n}, shards={self.num_shards}, "
            f"dtype={self.dtype}, {state})"
        )

    def _rows(self) -> torch.Tensor:
        """The ``(P, cap)`` view of the device buffer."""
        return self._data.view(self.num_shards, -1)

    # -- fault wiring ------------------------------------------------------

    def invalidate(self, reason: str) -> None:
        """Mark the device buffer unusable (the owning mesh re-formed)."""
        if not self._invalidated:
            self._invalidated = True
            self._invalid_reason = reason
            self._data = None

    def _ensure_live(self) -> None:
        """Re-run an invalidated handle through its hook; refuse a consumed one."""
        if self._consumed:
            raise RuntimeError(
                "device-resident result was already consumed (its buffer was "
                "donated to a next stage); re-run the sort"
            )
        if not self._invalidated:
            return
        if self._rerun is None:
            raise RuntimeError(
                f"device-resident result invalidated ({self._invalid_reason}) "
                "and no re-run hook is attached"
            )
        log.warning(
            "device-resident handle invalidated (%s); re-running on the current mesh",
            self._invalid_reason,
        )
        if self._metrics is not None:
            self._metrics.bump("device_handle_reruns")
        fresh = self._rerun()
        # Adopt the fresh handle's state; keep our hook, so a second
        # re-form re-runs again.
        self._data = fresh._data
        self._dtype = fresh._dtype
        self.shard_lengths = fresh.shard_lengths
        self._host = fresh._host
        self._invalidated = False
        self._invalid_reason = None

    # -- the three verbs ---------------------------------------------------

    def to_host(self) -> np.ndarray:
        """The sorted host array: the handle's only device-to-host copy of
        keys, cached.  Rows are trimmed on the device and copied once; a
        torn buffer (lengths that do not sum to ``n``) raises."""
        if self._host is not None:
            return self._host
        if self.n == 0:
            self._host = np.empty(0, dtype=self.dtype)
            return self._host
        self._ensure_live()
        from dsort_tpu_torch.parallel.sample_sort import _trim_rows

        # Trim as same-width signed ints: the bits are the keys', and
        # PyTorch's unsigned 16-, 32- and 64-bit dtypes have only partial
        # operator support.
        rows = self._rows().view(_SIGNED_OF_WIDTH[self.dtype.itemsize])
        out = _trim_rows(rows, self.shard_lengths, self.n, "keys").cpu().numpy().view(self.dtype)
        self._host = out
        if self._metrics is not None:
            self._metrics.event("result_fetch", n_keys=self.n)
        return out

    def consume(self, fn, donate: bool = True):
        """Run a next stage ``fn(data)`` on the device buffer and return its
        result; nothing crosses to the host.

        ``data`` is the flat ``(P * cap,)`` tensor of padded rows in the
        caller's dtype (`shard_lengths` / `offsets` say which entries are
        keys).  With ``donate=True`` the buffer is the stage's: it may write
        into it or return it, and the handle is consumed (later reads
        refuse).  With ``donate=False`` the handle stays live, so the stage
        must not write into its argument.
        """
        self._ensure_live()
        out = fn(self._data)
        if self._metrics is not None:
            self._metrics.bump("device_consumes")
            self._metrics.event("device_consume", n_keys=self.n, donated=bool(donate))
        if donate:
            self._consumed = True
            self._data = None
        return out

    def validate_on_device(self):
        """``dsort validate`` on the device: order + multiset checksum.

        Returns a `models.validate.ValidationReport` whose ``checksum``
        equals the host `_multiset` of the same keys, so comparing it with
        the input's checksum proves the permutation without fetching the
        sorted keys.
        """
        self._ensure_live()
        from dsort_tpu_torch.models.validate import validate_device_result

        rep = validate_device_result(self)
        if self._metrics is not None:
            self._metrics.bump("device_validates")
            self._metrics.event("device_validate", ok=bool(rep.sorted_ok), n=rep.records)
        return rep


_SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
