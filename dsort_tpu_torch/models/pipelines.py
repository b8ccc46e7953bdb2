"""End-to-end sort pipelines: the fused small-job route and the gather-merge.

Counterpart of ``dsort_tpu/models/pipelines.py``:

- `local_pipeline`: row-wise padded sort of ``(W, cap)`` shards, then the
  on-device merge (`ops.merge.merge_shards_device`);
- `fused_sort_small`: a whole job as one upload, one padded sort on the
  card and one download (the download is the completion barrier) — the
  route ``cli run`` takes for jobs under `FUSED_SMALL_JOB_MAX` keys, and
  ``--mode local`` at any size.  The row is padded to `pad_rung`;
- `GatherMergeSort`: the reference's scatter / sort / central-merge design
  (``server.c:185-216``, ``client.c:140-173``, ``server.c:481-524``) over a
  `VirtualMesh`: one upload of the ``(P, cap)`` shards, one batched sort of
  every row, one download, a host k-way merge.

`_fused_small_fn` is the fused route's per-rung variant — what the serving
layer's variant cache (`serve.variants`) holds and prewarms — and records
its first call per stream into `obs.prof`'s ledger.  `fused_sort_small`
(``cli run``'s route) calls the padded sort directly and records nothing:
its journal carries no ``variant_compiled`` event.  Not ported: the
reference's ``SPMD_CONTRACT`` dict (it feeds the JAX package's SPMD lint,
which reads JAX programs).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsort_tpu_torch.data.partition import pad_to_shards
from dsort_tpu_torch.device import device_scope, resolve_device
from dsort_tpu_torch.obs.prof import LEDGER, instrument_first_call
from dsort_tpu_torch.ops.float_order import (
    from_signed_keys,
    sort_float_keys_via_uint,
    to_signed_keys,
)
from dsort_tpu_torch.ops.local_sort import sort_padded
from dsort_tpu_torch.ops.merge import merge_shards_device, merge_sorted_host
from dsort_tpu_torch.parallel.device_result import DeviceSortResult
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer


def local_pipeline(
    shards: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise padded sort of ``(W, cap)`` shards plus the on-device merge.

    Pads may sit anywhere at positions ``>= counts[w]``; returns
    ``(sorted_flat, total_count)`` with the pads at the tail.  The whole
    reference job (partition -> sort -> merge, ``server.c:160-268``) on one
    device.
    """
    sorted_shards, counts = sort_padded(shards, counts)
    return merge_shards_device(sorted_shards, counts)


#: Jobs strictly below this many keys take `fused_sort_small` in ``cli run``'s
#: default mode; at and above it they go through `scheduler.SpmdScheduler`.
#: The reference's threshold, kept so both CLIs route every job alike.
FUSED_SMALL_JOB_MAX = 1 << 20

#: SPMD contract (parsed, not imported — `dsort_tpu_torch.analysis.spmd`).
#: The host layer is host-plane: it builds meshes and calls shard
#: programs but never issues a collective itself (DS1202).  ``pad_rung`` is
#: the fused route's size quantizer: the DS1301 covering proof
#: (``pad_rung(n) >= n``) is what makes "pad to the rung" safe, and the
#: rung-step bound keeps the pad waste inside one ladder step.
SPMD_CONTRACT = {
    "plane": "host",
    "caps": {
        "pad_rung": {
            "args": ("n",),
            "domain": {
                "n": (
                    "list(range(1, 1025))"
                    " + [4096, 4097, (1 << 20) - 3, 1 << 20]"
                ),
            },
            "require": (
                ("DS1301", "out >= n"),
                ("DS1303", "out >= 8"),
                ("DS1303", "out % 8 == 0"),
                (
                    "DS1301",
                    "out - n"
                    " < max(8, 1 << max((n - 1).bit_length() - 3, 0))",
                ),
            ),
        },
    },
}


def pad_rung(n: int) -> int:
    """The padded row length of an ``n``-key fused job.

    Pads to 1/8 of a power of two (at least 8): at most 12.5% padded work
    at any size, and 8 distinct row lengths a size octave.
    """
    step = max(8, 1 << max((n - 1).bit_length() - 3, 0))
    return -(-n // step) * step


def pad_for_fused(data: np.ndarray) -> np.ndarray:
    """The rung-padded host staging buffer of `fused_sort_small`.

    The tail beyond ``len(data)`` is left uninitialized: `sort_padded` masks
    it to the dtype's sentinel on the device, so trimming the sorted row to
    the input length is exact even for sentinel-valued real keys.
    """
    buf = np.empty(pad_rung(len(data)), data.dtype)
    buf[: len(data)] = data
    return buf


@functools.lru_cache(maxsize=64)
def _fused_small_fn(n_pad: int, dtype_str: str, kernel: str):
    """The fused route's program for one rung: ``fn(x, count)`` sorts the
    device row ``x`` of ``n_pad`` keys whose first ``count`` are real
    (`sort_padded` masks the tail to the dtype's sentinel) through
    ``kernel`` and returns the sorted row in ``x``'s dtype, on the current
    stream.  It holds no device buffer, so slices on their own streams
    share one variant safely.  Its first call per stream is recorded in
    the ledger under the variant cache's key, ``("fused", n_pad, dtype_str,
    kernel)``."""

    def sort_row(x: torch.Tensor, count: int) -> torch.Tensor:
        out, _ = sort_padded(to_signed_keys(x), count, kernel)
        return from_signed_keys(out, x.dtype)

    return instrument_first_call(
        sort_row, key_fn=lambda *a: ("fused", n_pad, dtype_str, kernel)
    )


def fused_sort_small(
    data: np.ndarray, kernel: str = "auto", metrics: Metrics | None = None,
    keep_on_device: bool = False, device=None,
) -> np.ndarray:
    """Sort a whole job as one padded row on the device.

    One upload of the `pad_for_fused` buffer, `sort_padded` of the row
    through ``kernel`` (`ops.local_sort.sort_with_kernel`: ``auto`` is the
    block kernels from a 2^16-key rung up on the card, ``torch.sort``
    below), one download — the completion barrier, with no separate
    synchronize — and a trim to ``len(data)``.  Phases ``partition``
    (padding), ``local_sort`` (upload, sort and download: splitting them
    would need the synchronize this route exists to avoid) and
    ``assemble``.  Float keys ride the order-preserving signed carrier
    (NaNs last, canonical); unsigned and narrow keys sort as their signed
    carrier.  Runs on ``cuda`` unless ``device="cpu"``.  The row's sort is
    the rung's `_fused_small_fn`, so its first call per stream lands in the
    first-call ledger (synchronized, once) and drains into ``metrics``.

    ``keep_on_device=True`` drops the download: one upload and the padded
    row's sort, then a `parallel.device_result.DeviceSortResult` of one
    shard of length ``n`` (``label="fused"``), returned without waiting on
    the sort — the handle's first consumer is the completion barrier.
    Integer keys only.
    """
    dev = resolve_device(device)
    data = np.asarray(data)
    if keep_on_device and data.dtype.kind == "f":
        raise TypeError(
            "keep_on_device supports integer keys only; use fused_sort_small() for floats"
        )
    if data.dtype.kind == "f":
        return sort_float_keys_via_uint(
            lambda d, m: fused_sort_small(d, kernel, m, device=dev), data, metrics
        )
    metrics = metrics if metrics is not None else Metrics()
    timer = PhaseTimer(metrics)
    n = len(data)
    if n == 0:
        if keep_on_device:
            empty = torch.from_numpy(data.copy()).to(dev)
            return DeviceSortResult(empty, np.zeros(1, np.int64), 0, metrics, label="fused")
        return data.copy()
    with timer.phase("partition"):
        buf = pad_for_fused(data)
    with timer.phase("local_sort"), device_scope(dev):
        x = torch.from_numpy(buf).to(dev)
        out = _fused_small_fn(len(buf), str(data.dtype), kernel)(x, n)
        host = None if keep_on_device else out.cpu().numpy()
    LEDGER.drain_to(metrics)
    if host is None:  # no download and no synchronize
        return DeviceSortResult(out, np.array([n], np.int64), n, metrics, label="fused")
    with timer.phase("assemble"):
        return host[:n]


class GatherMergeSort:
    """Per-shard sort on the device, gather, host k-way merge.

    The reference's vmapped per-device ``sort_padded`` becomes one
    `sort_padded` of all ``(P, cap)`` rows through ``auto``: on the card the
    batched block-kernel path for rows of 2^16 keys and more, ``torch.sort``
    below (the reference runs ``lax`` here; the bits are the same).
    """

    def __init__(self, mesh: VirtualMesh):
        self.mesh = mesh
        self.num_workers = mesh.num_workers

    def sort(self, data: np.ndarray, metrics: Metrics | None = None) -> np.ndarray:
        data = np.asarray(data)
        if data.dtype.kind == "f":
            return sort_float_keys_via_uint(self.sort, data, metrics)
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        dev = self.mesh.device
        with timer.phase("partition"), device_scope(dev):
            shards, counts = pad_to_shards(data, self.num_workers)
            xs = torch.from_numpy(shards).to(dev)
            cs = torch.from_numpy(counts).to(dev)
        with timer.phase("local_sort"), device_scope(dev):
            sorted_rows, _ = sort_padded(to_signed_keys(xs), cs, "auto")
            sorted_rows = from_signed_keys(sorted_rows, xs.dtype)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with timer.phase("gather"):
            host_rows = sorted_rows.cpu().numpy()
        with timer.phase("merge"):
            return merge_sorted_host(
                [host_rows[i, : counts[i]] for i in range(self.num_workers)]
            )
