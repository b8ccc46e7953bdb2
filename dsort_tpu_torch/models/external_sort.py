"""Out-of-core external sort: device-sized runs, spilled, then merged.

Counterpart of ``dsort_tpu/models/external_sort.py``.  The reference C
system caps a whole job at 16,384 ints (every chunk fits a worker's fixed
stack buffer); this pipeline sorts datasets larger than device memory, or
host RAM on the input side:

1. **run generation** — the input is consumed in ``run_elems`` slices;
   each slice is sorted on the card (the final partial run padded with the
   sentinel, so every run has one shape) and spilled to disk as a
   checkpointed sorted run;
2. **merge** — the runs merge into the output buffer, which may be a
   disk-backed memmap.

Runs live in `checkpoint.ShardCheckpoint` (the reference's store, so a
store either package wrote resumes in the other): a killed job resumes by
re-sorting only the missing runs.  Float keys spill as the reference's
ordered uints (manifest ``storage_dtype`` "uint32" / "uint64") and unmap at
egress in run-sized chunks.

**The merge.**  The reference merges with its native C++ heap merge when
that library is built (bumping ``native_merges``) and otherwise with
``merge_sorted_host`` and, for records, an in-memory lexsort.  The native
runtime is not ported, so this package always takes those fallbacks (its
own `ops.merge`) and never bumps ``native_merges``; the merge then holds
every run in host memory at once.

**One run in flight on the card.**  A run's upload comes from page-locked
host memory without blocking the host; its sort is queued on the current
stream, and its device-to-host copy is queued at once on a copy stream
into page-locked memory, behind an event of the sort.  So the host reads
the next slice, uploads and launches its sort while the previous run's
copy and its disk write are in flight, and a fetch waits for its own run
alone.  No kernel wrapper on this path synchronises.

This module is the single-device out-of-core path; its mesh-scale
successor is `models.wave_sort` (``cli external --mesh N``).
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dsort_tpu_torch.checkpoint import ShardCheckpoint
from dsort_tpu_torch.device import device_scope, resolve_device
from dsort_tpu_torch.ops.float_order import (
    float_to_ordered_uint,
    is_float_np_dtype,
    ordered_uint_dtype,
    ordered_uint_to_float,
)
from dsort_tpu_torch.ops.local_sort import sentinel_for, sort_kv2_padded, sort_with_kernel
from dsort_tpu_torch.ops.merge import merge_sorted_host
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

log = get_logger("external_sort")


def _fingerprint(data: np.ndarray, samples: int = 16) -> str:
    """Cheap identity check for resume: length, dtype, and sampled bytes.

    Reads at most ``samples`` single elements, so it is O(1) even on a
    memmap of a huge file.  The reference's string, so manifests compare
    across packages.
    """
    n = len(data)
    idx = np.unique(np.linspace(0, n - 1, num=min(samples, n), dtype=np.int64))
    picks = np.asarray([data[int(i)] for i in idx])
    return f"{n}:{data.dtype}:{picks.tobytes().hex()}"


# -- the card side of one run ------------------------------------------------


def _signed_np(dtype) -> np.dtype:
    """The signed integer dtype of ``dtype``'s width: the carrier a key
    column rides on the card as (unsigned keys with the sign bit flipped)."""
    return np.dtype(f"i{np.dtype(dtype).itemsize}")


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """An empty host tensor of numpy ``dtype`` (integers only), page-locked
    when ``device`` is a card so copies to and from it need not block."""
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(shape, dtype=tdt, pin_memory=device.type == "cuda")


def upload_keys(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy host keys (any integer dtype, unsigned included) to ``device``
    as their signed carrier, without blocking the host on a card."""
    arr = np.ascontiguousarray(arr)
    sdt = _signed_np(arr.dtype)
    buf = host_buffer(arr.shape, sdt, device)
    buf.numpy()[...] = arr.view(sdt)
    x = buf.to(device, non_blocking=True)
    if arr.dtype.kind == "u":
        x = x ^ np.iinfo(sdt).min
    return x


def from_carrier_bits(s: torch.Tensor, dtype) -> torch.Tensor:
    """Signed carrier keys -> the bit pattern of ``dtype`` keys, still in
    the signed torch dtype (the host views it as ``dtype``)."""
    return s ^ np.iinfo(_signed_np(dtype)).min if np.dtype(dtype).kind == "u" else s


class PendingFetch:
    """A device-to-host copy in flight: ``wait()`` blocks for it alone and
    returns the host array.

    On a card the copy runs on ``stream`` (a copy stream) behind an event of
    the current stream, into page-locked memory; ``y.record_stream`` keeps
    the source's memory from reuse until the copy is done.  On the CPU it
    is the tensor itself.
    """

    def __init__(self, y: torch.Tensor, stream=None):
        self._done = None
        if y.device.type == "cuda":
            out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            stream.wait_stream(torch.cuda.current_stream(y.device))
            with torch.cuda.stream(stream):
                out.copy_(y, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record(stream)
            y.record_stream(stream)
            y = out
        self._host = y

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def copy_stream(device: torch.device):
    """A copy stream on ``device`` (None off the card)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


# -- the pipeline ------------------------------------------------------------


def _overlapped_run_generation(
    data, n, run_elems, submit_run, fetch_run, ckpt, metrics: Metrics,
    resume, mapper=None,
) -> None:
    """Sort missing runs with read / compute / transfer / write overlap.

    Four stages pipeline: the next slice's disk read runs on a reader
    thread; ``submit_run(chunk)`` queues the run's upload, sort and copy
    back without blocking and returns an in-flight state;
    ``fetch_run(state)`` waits for the PREVIOUS run's copy (one run is
    always in flight) while the card works on the current one; the
    finished run's checkpoint write runs on a writer thread.  Exceptions
    of either thread surface on the main thread at the next result.  Used
    by `ExternalSort` (keys) and `ExternalTeraSort` (records).
    """
    num_runs = -(-n // run_elems)
    todo = [i for i in range(num_runs) if not (resume and ckpt.has(i))]
    if len(todo) < num_runs:
        metrics.bump("runs_resumed", num_runs - len(todo))
    if not todo:
        return

    def read_slice(i: int) -> np.ndarray:
        lo = i * run_elems
        sl = data[lo : min(lo + run_elems, n)]
        # A memmap slice is lazy: np.array forces the disk read here, on
        # the reader thread, so the overlap is real.
        arr = np.array(sl) if isinstance(data, np.memmap) else np.asarray(sl)
        return mapper(arr) if mapper is not None else arr

    with ThreadPoolExecutor(max_workers=1) as reader, ThreadPoolExecutor(
        max_workers=1
    ) as writer:
        next_chunk = reader.submit(read_slice, todo[0])
        pending_write = None
        in_flight: tuple | None = None  # (run_id, in-flight state)

        def retire(run_id, state):
            nonlocal pending_write
            out = fetch_run(state)
            if pending_write is not None:
                pending_write.result()  # surface write errors in order
            pending_write = writer.submit(ckpt.save, run_id, out)
            metrics.bump("runs_sorted")

        for pos, i in enumerate(todo):
            chunk = next_chunk.result()
            if pos + 1 < len(todo):
                next_chunk = reader.submit(read_slice, todo[pos + 1])
            state = submit_run(chunk)  # the card now works on run i ...
            if in_flight is not None:
                retire(*in_flight)  # ... while run i-1 crosses to the host
            in_flight = (i, state)
        retire(*in_flight)
        if pending_write is not None:
            pending_write.result()


def _sync_manifest(
    ckpt: ShardCheckpoint, resume: bool, job_id: str, num_runs: int, dtype,
    total: int, run_elems: int, fingerprint: str, storage_dtype: str,
) -> None:
    """Clear untrusted checkpointed runs, then stamp this job's manifest.

    Runs are trusted only if they came from THIS job: same run count,
    dtype, on-disk storage format, run size and data fingerprint; a missing
    manifest with runs present is untrusted too (a crash mid-``clear``).
    """
    if not resume:
        ckpt.clear()
    else:
        m = ckpt.manifest()
        stale = (m is None and bool(ckpt.completed_shards())) or (
            m is not None
            and (
                m.get("num_shards") != num_runs
                or m.get("dtype") != str(np.dtype(dtype))
                or m.get("storage_dtype") != storage_dtype
                or m.get("total") != total
                or m.get("run_elems") != run_elems
                or m.get("fingerprint") != fingerprint
            )
        )
        if stale:
            log.warning("job %r: checkpointed runs belong to different data; clearing", job_id)
            ckpt.clear()
    ckpt.write_manifest(
        num_runs, dtype, total, run_elems=run_elems, fingerprint=fingerprint,
        storage_dtype=storage_dtype,
    )


def _open_out(out_path: str, dtype, n: int) -> np.memmap:
    """The output memmap: ``.npy`` (dtype and shape recorded) or raw."""
    if out_path.endswith(".npy"):
        return np.lib.format.open_memmap(out_path, mode="w+", dtype=dtype, shape=(n,))
    return np.memmap(out_path, dtype=dtype, mode="w+", shape=(n,))


class ExternalSort:
    """Sort arrays or files of any size with bounded device memory.

    ``run_elems``: keys per sorted run (the device working set).
    ``spill_dir``: where checkpointed runs live (default: a temp dir).
    ``job_id``: resume key — a re-run with the same id skips finished runs.
    ``local_kernel``: `ops.local_sort.sort_with_kernel`'s kernel (``auto``
    is the block kernels for integer runs of at least 2^16 keys on the
    card).  ``device``: ``cuda`` unless ``cpu`` is asked.
    """

    def __init__(
        self,
        run_elems: int = 1 << 22,
        spill_dir: str | None = None,
        job_id: str = "external",
        local_kernel: str = "auto",
        resume: bool = True,
        device=None,
    ):
        if run_elems < 2:
            raise ValueError("run_elems must be >= 2")
        self.run_elems = int(run_elems)
        self.spill_dir = spill_dir or os.path.join(tempfile.gettempdir(), "dsort_external")
        self.job_id = job_id
        self.local_kernel = local_kernel
        self.resume = resume
        self.device = resolve_device(device)
        self._copy_stream = copy_stream(self.device)

    def _submit_run(self, chunk: np.ndarray):
        """Queue one slice's sort (sentinel-padded to ``run_elems``) and its
        copy back; returns the in-flight ``(PendingFetch, n, dtype)``."""
        n = len(chunk)
        if n != self.run_elems:
            # Trim is exact even when real keys equal the sentinel: the sort
            # moves exactly run_elems - n pads to the tail.
            padded = np.full(self.run_elems, sentinel_for(chunk.dtype), dtype=chunk.dtype)
            padded[:n] = chunk
            chunk = padded
        with device_scope(self.device):
            y = sort_with_kernel(upload_keys(chunk, self.device), self.local_kernel)
            return PendingFetch(from_carrier_bits(y, chunk.dtype), self._copy_stream), n, chunk.dtype

    def _fetch_run(self, state) -> np.ndarray:
        fetch, n, dtype = state
        with device_scope(self.device):
            out = fetch.wait().view(dtype)
        return out[:n] if n != self.run_elems else out

    def sort(
        self, data: np.ndarray, out: np.ndarray | None = None, metrics: Metrics | None = None,
    ) -> np.ndarray:
        """Sort ``data`` (ndarray or memmap); the result lands in ``out`` if
        given.  ``data`` is read in ``run_elems`` slices and ``out`` may be
        a memmap."""
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        n = len(data)
        if n == 0:
            return np.asarray(data).copy() if out is None else out
        fdt = np.dtype(data.dtype) if is_float_np_dtype(data.dtype) else None
        storage_dtype = ordered_uint_dtype(fdt) if fdt is not None else np.dtype(data.dtype)
        ckpt = ShardCheckpoint(self.spill_dir, self.job_id)
        num_runs = -(-n // self.run_elems)
        _sync_manifest(
            ckpt, self.resume, self.job_id, num_runs, data.dtype, n, self.run_elems,
            _fingerprint(data), storage_dtype=str(storage_dtype),
        )
        with timer.phase("run_generation"):
            _overlapped_run_generation(
                data, n, self.run_elems, self._submit_run, self._fetch_run, ckpt, metrics,
                resume=self.resume, mapper=float_to_ordered_uint if fdt is not None else None,
            )
        with timer.phase("merge"):
            runs = [ckpt.load_mmap(i) for i in range(num_runs)]
            # A float job merges into a uint view of the caller's buffer,
            # unmapped in place afterwards.
            target = out.view(storage_dtype) if (fdt is not None and out is not None) else out
            if num_runs == 1:
                # A copy: the result must not alias a checkpoint file.
                if target is None:
                    target = np.array(runs[0])
                else:
                    target[:] = runs[0]
            else:
                merged = merge_sorted_host([np.asarray(r) for r in runs])
                if target is None:
                    target = merged
                else:
                    target[:] = merged
            if fdt is not None:
                if out is None:
                    out = np.empty(n, dtype=fdt)
                # Chunked unmap keeps temporaries O(run_elems); alias-safe,
                # the right side materialises before the slice assignment.
                for lo in range(0, n, self.run_elems):
                    sl = slice(lo, min(lo + self.run_elems, n))
                    out[sl] = ordered_uint_to_float(target[sl], fdt)
                return out
            return target if out is None else out

    def sort_binary_file(
        self, in_path: str, out_path: str, dtype=np.int32, metrics: Metrics | None = None,
    ) -> None:
        """Sort a raw binary key file into ``out_path``, out-of-core end to
        end: the input memmapped, read in run-sized slices; the output
        written through a memmap."""
        dtype = np.dtype(dtype)
        size = os.path.getsize(in_path)
        if size % dtype.itemsize:
            raise ValueError(
                f"{in_path}: size {size} not a multiple of itemsize {dtype.itemsize}"
            )
        n = size // dtype.itemsize
        if n == 0:  # numpy cannot mmap an empty file; emit an empty output
            open(out_path, "wb").close()
            return
        data = np.memmap(in_path, dtype=dtype, mode="r")
        out = _open_out(out_path, dtype, n)
        self.sort(data, out=out, metrics=metrics)
        out.flush()


# -- TeraSort records ---------------------------------------------------------

RECORD_BYTES = 100


def record_keys(recs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The full 10-byte key of ``(n, 100)`` records: the big-endian packed
    8-byte prefix (uint64) and key bytes 8-9 (uint16)."""
    from dsort_tpu_torch.data.ingest import _pack_be64, terasort_secondary

    return _pack_be64(recs[:, :8]), terasort_secondary(recs[:, 8:10]).astype(np.uint16)


def lexsort_records(runs: list[np.ndarray]) -> np.ndarray:
    """Sorted runs of records merged by the full key: an in-memory stable
    lexsort over their concatenation (the reference's fallback merge)."""
    allrec = np.concatenate([np.asarray(r) for r in runs])
    k1, k2 = record_keys(allrec)
    return allrec[np.lexsort((k2, k1))]


def sort_records_on_device(recs, counts, device: torch.device) -> torch.Tensor:
    """Sort padded record rows ``(..., cap, 100)`` by the full key on
    ``device`` (`ops.local_sort.sort_kv2_padded`, stable ``torch.sort``
    passes, as the reference's ``lax.sort``): the prefix rides as its
    signed carrier, key bytes 8-9 as int32.  ``counts`` (int or per-row
    tensor) marks the valid records; pads go to the tail."""
    k1, k2 = record_keys(recs.reshape(-1, RECORD_BYTES))
    lead = recs.shape[:-1]
    x1 = upload_keys(k1.reshape(lead), device)
    x2 = upload_keys(k2.astype(np.int32).reshape(lead), device)
    rv = host_buffer(recs.shape, np.uint8, device)
    rv.numpy()[...] = recs
    v = rv.to(device, non_blocking=True)
    return sort_kv2_padded(x1, x2, v, counts)[2]


class ExternalTeraSort:
    """Out-of-core TeraSort: 100-byte records beyond device (or host) memory.

    1. **run generation** — record slices stream in; each slice sorts on the
       card by the full 10-byte key (`sort_records_on_device`; any order of
       fully equal keys is a valid TeraSort output, and this one is stable)
       and the reordered records spill as checkpointed runs;
    2. **merge** — the runs merge by the full key into the output memmap
       (`lexsort_records`, the reference's fallback: the native two-level
       heap merge is not ported).

    Resume semantics are `ExternalSort`'s (same manifest, ``storage_dtype``
    "terasort100").
    """

    RECORD_BYTES = RECORD_BYTES

    def __init__(
        self,
        run_recs: int = 1 << 20,
        spill_dir: str | None = None,
        job_id: str = "tera_external",
        resume: bool = True,
        device=None,
    ):
        if run_recs < 2:
            raise ValueError("run_recs must be >= 2")
        self.run_recs = int(run_recs)
        self.spill_dir = spill_dir or os.path.join(tempfile.gettempdir(), "dsort_external")
        self.job_id = job_id
        self.resume = resume
        self.device = resolve_device(device)
        self._copy_stream = copy_stream(self.device)

    def _submit_run(self, recs: np.ndarray):
        """Queue one record slice's sort (zero-padded to ``run_recs``) and
        its copy back."""
        n = len(recs)
        if n != self.run_recs:
            pad = np.zeros((self.run_recs - n, self.RECORD_BYTES), np.uint8)
            recs = np.concatenate([recs, pad])
        with device_scope(self.device):
            y = sort_records_on_device(recs, n, self.device)
            return PendingFetch(y, self._copy_stream), n

    def _fetch_run(self, state) -> np.ndarray:
        fetch, n = state
        with device_scope(self.device):
            return fetch.wait()[:n]

    def sort_file(self, in_path: str, out_path: str, metrics: Metrics | None = None) -> None:
        """Sort a binary TeraSort file into ``out_path``, out-of-core."""
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        size = os.path.getsize(in_path)
        if size % self.RECORD_BYTES:
            raise ValueError(f"{in_path}: size {size} not a multiple of {self.RECORD_BYTES}")
        n = size // self.RECORD_BYTES
        if n == 0:
            open(out_path, "wb").close()
            return
        data = np.memmap(in_path, dtype=np.uint8, mode="r").reshape(n, self.RECORD_BYTES)
        ckpt = ShardCheckpoint(self.spill_dir, self.job_id)
        num_runs = -(-n // self.run_recs)
        _sync_manifest(
            ckpt, self.resume, self.job_id, num_runs, np.uint8, n, self.run_recs,
            _fingerprint(data), storage_dtype="terasort100",
        )
        with timer.phase("run_generation"):
            _overlapped_run_generation(
                data, n, self.run_recs, self._submit_run, self._fetch_run, ckpt, metrics,
                resume=self.resume,
            )
        with timer.phase("merge"):
            out = np.memmap(out_path, dtype=np.uint8, mode="w+", shape=(n, self.RECORD_BYTES))
            runs = [ckpt.load_mmap(i) for i in range(num_runs)]
            out[:] = runs[0] if len(runs) == 1 else lexsort_records(runs)
            out.flush()
