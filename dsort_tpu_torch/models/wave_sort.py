"""Multi-round out-of-core sort over the mesh: the wave pipeline.

Counterpart of ``dsort_tpu/models/wave_sort.py``: `models.external_sort`
composed with the mesh's ring exchange, so a dataset larger than the
mesh's device memory sorts one device-sized wave at a time.

1. **global splitters, once** — a deterministic strided sample of the whole
   input picks ``P-1`` splitters up front, so every wave's buckets land on
   the same owner and the output is the concatenation of the per-range
   merges: no global re-merge.
2. **wave loop** — the input is consumed in ``wave_elems`` waves.  Each wave
   is sorted and planned on the mesh against the fixed splitters
   (`exchange._wave_plan_shard`: the local sort and the bucket histogram,
   the wave's one small copy to the host), sized (`exchange.ring_caps`) and
   exchanged, leaving mesh row ``r`` with the wave's sorted ``r``-th range.
   Six programs: ``ring`` (the default), ``fused`` (R1, one exchange launch
   a wave), ``hier`` (the two-level schedule; ``ring`` under 2 hosts),
   ``coded`` (``redundancy > 1``: the replicate or parity plane on the
   ring), ``single`` (P = 1: the padded local sort), and the plan.
3. **overlap** — while wave ``k`` runs on the card, wave ``k+1`` is read on a
   reader thread and wave ``k-1`` retires on a writer thread (its copy to
   the host, queued on a copy stream right after its exchange, and its
   spill), like `external_sort._overlapped_run_generation`.
   ``overlap=False`` is the sequential schedule (the A/B baseline).
4. **run store + merge** — each (wave, range) spills as one sorted run in
   `checkpoint.ShardCheckpoint`'s ``(wave, run)`` namespace; the final phase
   merges each range's runs into its slice of the output (which may be a
   memmap).  The merge is the host fallback (`ops.merge.merge_sorted_host`;
   the reference's native heap merge is not ported, so ``native_merges``
   never counts here).

**Resume contract (run granularity).**  The manifest is the reference's:
the external sort's fingerprint guard plus the wave layout and the sampled
splitters (``kind="wave"``), so a crash resumes against identical bucket
ownership, in either package:

- a wave with all ``P`` runs present restores for free (``runs_resumed``);
- an interrupted wave re-sorts ONLY its missing runs on the host
  (``wave_resume``, ``wave_runs_resorted``);
- a worker loss inside a wave's ring (`WorkerFailure` at the `fault_hook`
  seam) is repaired in flight: the wave's input is still on the host, so
  its runs re-sort there and the pipeline continues on the mesh; a coded
  wave instead rebuilds the lost range from the plane (`parallel.coded`,
  zero runs re-sorted);
- a CUDA runtime error propagates: it is sticky, so every later launch of
  the process would fail too; the re-run resumes from the store.

``DSORT_WAVE_DIE_AFTER_WAVE=<k>`` is the crash drill: the process exits with
code 17 right after wave ``k``'s runs are durable.

The mesh is a `VirtualMesh`: P rows of one card, whose collectives are
layout changes (`parallel.mesh`).
"""

from __future__ import annotations

import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dsort_tpu_torch.checkpoint import ShardCheckpoint
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.device import device_scope
from dsort_tpu_torch.models.external_sort import (
    RECORD_BYTES,
    PendingFetch,
    _fingerprint,
    _open_out,
    copy_stream,
    from_carrier_bits,
    lexsort_records,
    record_keys,
    sort_records_on_device,
    upload_keys,
)
from dsort_tpu_torch.ops.float_order import (
    float_to_ordered_uint,
    is_float_np_dtype,
    is_narrow_int_dtype,
    ordered_uint_dtype,
    ordered_uint_to_float,
)
from dsort_tpu_torch.ops.merge import merge_sorted_host
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

log = get_logger("wave_sort")

#: Crash-drill hook: ``os._exit(17)`` right after this wave's runs land.
DIE_AFTER_WAVE_ENV = "DSORT_WAVE_DIE_AFTER_WAVE"


def _recoverable(exc: BaseException) -> bool:
    """A wave fault the pipeline repairs in flight: an injected worker loss
    (`WorkerFailure`) only.  Everything else propagates: a CUDA runtime
    error is sticky (every later launch and copy of the process fails
    too), so repairing it on the host would turn the job into a CPU sort;
    the re-run resumes from whatever the (wave, run) store made durable.
    The reference also repairs a classified device error."""
    from dsort_tpu_torch.scheduler.fault import WorkerFailure

    return isinstance(exc, WorkerFailure)


def sample_global_splitters(data, n: int, p: int, mapper=None, oversample: int = 64):
    """``P-1`` global splitters from ONE deterministic strided sample.

    Position-based (`np.linspace` picks, like `_fingerprint`), so a resumed
    job recomputes identical splitters from identical data; the manifest
    records them too.  ``mapper`` maps float keys to ordered uints, so the
    splitters live in storage space.  O(sample) host memory on a memmap.
    """
    if p <= 1:
        empty = np.array(data[:0])
        return mapper(empty) if mapper is not None else np.asarray(empty)
    s = min(n, max(4096, p * oversample))
    idx = np.unique(np.linspace(0, n - 1, num=s, dtype=np.int64))
    sample = np.array(data[idx])
    if mapper is not None:
        sample = mapper(sample)
    sample.sort(kind="stable")
    pos = (np.arange(1, p, dtype=np.int64) * len(sample)) // p
    return sample[pos]


def _shard_cap(wave_budget: int, p: int) -> int:
    """Per-row buffer length, the same for EVERY wave (the last partial wave
    pads up): ceil(budget / P), 8-aligned."""
    return -(-(-(-wave_budget // p)) // 8) * 8


def _device_dtype(storage: np.dtype) -> np.dtype:
    """The host dtype a wave's keys upload as: int32 for 8- and 16-bit
    keys (an order-preserving widening: the kernels and the fused ring take
    32- and 64-bit keys), else the storage dtype itself."""
    return np.dtype(np.int32) if is_narrow_int_dtype(storage) else storage


def _to_storage(rows: np.ndarray, storage: np.dtype) -> np.ndarray:
    """Keys fetched from the card (the bits of `_device_dtype` keys in
    its signed dtype) as ``storage`` keys."""
    wide = _device_dtype(storage)
    return rows.view(wide).astype(storage, copy=False)


def _die_check(w: int) -> None:
    """Crash-drill hook point: runs after wave ``w``'s runs are durable."""
    if os.environ.get(DIE_AFTER_WAVE_ENV) == str(w):
        log.warning("crash drill: exiting after wave %d persisted", w)
        os._exit(17)


def _sync_wave_manifest(
    ckpt, *, resume, job_id, num_waves, num_ranges, wave_elems, dtype,
    total, fingerprint, storage_dtype, splitters,
) -> None:
    """THE (wave, run) store staleness guard of the key and record
    pipelines: persisted runs are trusted only if the layout AND the
    splitters match (the splitters define bucket ownership)."""
    spl = [int(v) for v in splitters]
    if not resume:
        ckpt.clear()
    else:
        m = ckpt.manifest()
        stale = (m is None and bool(ckpt.completed_wave_runs())) or (
            m is not None
            and (
                m.get("kind") != "wave"
                or m.get("num_waves") != num_waves
                or m.get("num_ranges") != num_ranges
                or m.get("wave_elems") != wave_elems
                or m.get("dtype") != str(np.dtype(dtype))
                or m.get("storage_dtype") != storage_dtype
                or m.get("total") != total
                or m.get("fingerprint") != fingerprint
                or m.get("splitters") != spl
            )
        )
        if stale:
            log.warning(
                "wave job %r: persisted runs belong to a different job/layout; clearing",
                job_id,
            )
            ckpt.clear()
    ckpt.write_manifest(
        num_waves * num_ranges, dtype, total,
        kind="wave", num_waves=num_waves, num_ranges=num_ranges,
        wave_elems=wave_elems, fingerprint=fingerprint,
        storage_dtype=storage_dtype, splitters=spl,
    )


def _classify_waves(ckpt, num_waves: int, p: int, metrics: Metrics):
    """Resume triage over the (wave, run) store: ``(fresh, partial)`` —
    fresh waves run on the mesh, partial ones repair their missing runs;
    complete waves restore for free (``runs_resumed``)."""
    done = set(ckpt.completed_wave_runs())
    fresh, partial, resumed = [], [], 0
    for w in range(num_waves):
        missing = [r for r in range(p) if (w, r) not in done]
        resumed += p - len(missing)
        if not missing:
            continue
        (partial if len(missing) < p else fresh).append((w, missing))
    if resumed:
        metrics.bump("runs_resumed", resumed)
    return fresh, partial


def _range_mask(keys: np.ndarray, splitters: np.ndarray, r: int, p: int):
    """Host twin of the device bucket rule (`exchange._bucket_bounds`):
    range ``r`` owns ``[splitters[r-1], splitters[r])``, open at both ends
    of the key space.  Keys equal to a splitter go right."""
    mask = np.ones(len(keys), bool)
    if r > 0:
        mask &= keys >= splitters[r - 1]
    if r < p - 1:
        mask &= keys < splitters[r]
    return mask


def _merge_runs_into(runs, target) -> None:
    """Sorted runs into ``target`` (a slice of the output or of a memmap)
    by the host merge (`ops.merge.merge_sorted_host`)."""
    runs = [r for r in runs if len(r)]
    if not runs:
        return
    if len(runs) == 1:
        target[:] = runs[0]
        return
    target[:] = merge_sorted_host([np.asarray(r) for r in runs])


def _spill_repaired(w, missing, runs, ckpt, metrics: Metrics, timer: PhaseTimer) -> None:
    """Persist the host-repaired runs of wave ``w`` (keys or records) and
    count them as the reference does."""
    total = 0
    with timer.phase("wave_repair_spill"):
        for r, run in zip(missing, runs):
            ckpt.save_wave_run(w, r, run)
            total += len(run)
            metrics.bump("wave_runs_resorted")
            metrics.bump("runs_sorted")
            metrics.bump("wave_resort_keys", len(run))
    metrics.event("wave_done", wave=w, runs=len(missing), n_keys=total)


def _run_wave_pipeline(waves, *, read, dispatch, retire, repair, die_check, overlap: bool) -> None:
    """The overlapped wave loop (keys and records).

    For wave ``k``: the reader thread loads wave ``k+1``, the mesh runs
    wave ``k`` and wave ``k-1`` retires on the writer thread (its copy to
    the host and spill), surfaced in order.  ``overlap=False`` runs every
    step inline.  An injected worker loss (`_recoverable`) in a wave's
    dispatch or retire re-sorts that wave's runs on the host (``repair``;
    its input is still in host memory) and the pipeline goes on; any other
    error propagates.  ``die_check`` runs after each wave's runs are
    durable (the crash drill's hook point).
    """
    reader = ThreadPoolExecutor(max_workers=1) if overlap else None
    writer = ThreadPoolExecutor(max_workers=1) if overlap else None

    def inline_save(fn, *a):
        fn(*a)

    def settle(retiring):
        """Surface the writer-thread retire of wave ``w``, repairing it on a
        recoverable fault, then run the crash-drill hook."""
        w, chunk, fut = retiring
        try:
            fut.result()
        except Exception as e:  # routed through _recoverable
            if not _recoverable(e):
                raise
            repair(w, chunk, "worker_failure")
        die_check(w)

    try:
        nxt = reader.submit(read, waves[0]) if reader else None
        retiring = None  # (wave, chunk, writer-thread future)
        for pos, w in enumerate(waves):
            chunk = nxt.result() if reader else read(w)
            if reader and pos + 1 < len(waves):
                nxt = reader.submit(read, waves[pos + 1])
            try:
                state = dispatch(w, chunk)
            except Exception as e:  # routed through _recoverable
                if not _recoverable(e):
                    raise
                repair(w, chunk, "worker_failure")
                die_check(w)
                state = None
            if state is None:
                continue
            if overlap:
                # One wave retires at a time (bounded memory), in order.
                if retiring is not None:
                    settle(retiring)
                retiring = (w, chunk, writer.submit(retire, w, chunk, state, inline_save))
            else:
                try:
                    retire(w, chunk, state, inline_save)
                except Exception as e:  # routed through _recoverable
                    if not _recoverable(e):
                        raise
                    repair(w, chunk, "worker_failure")
                die_check(w)
        if retiring is not None:
            settle(retiring)
    finally:
        if reader is not None:
            reader.shutdown(wait=True)
        if writer is not None:
            writer.shutdown(wait=True)


class ExternalWaveSort:
    """Out-of-core mesh sort: wave-pipelined exchange plus the run store.

    ``mesh``: a `VirtualMesh` (default: 8 workers on the card).
    ``wave_elems``: keys consumed per wave, the per-wave device budget.
    ``spill_dir`` / ``job_id`` / ``resume``: the ``(wave, run)`` store and
    its resume key.  ``overlap=False`` turns the pipeline off.
    ``exchange`` (``ring`` | ``fused`` | ``hier``; ``alltoall`` maps to
    ``ring``; default `JobConfig.exchange` through the shared resolver),
    ``redundancy`` / ``redundancy_mode`` (a coded wave runs the ring).
    """

    def __init__(
        self,
        mesh: VirtualMesh | None = None,
        wave_elems: int = 1 << 22,
        spill_dir: str | None = None,
        job_id: str = "wave",
        job: JobConfig | None = None,
        resume: bool = True,
        overlap: bool = True,
        exchange: str | None = None,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ):
        if wave_elems < 2:
            raise ValueError("wave_elems must be >= 2")
        from dsort_tpu_torch.parallel.exchange import (
            resolve_exchange,
            resolve_hier_hosts,
            resolve_redundancy,
            resolve_redundancy_mode,
        )

        self.mesh = mesh if mesh is not None else VirtualMesh(8)
        self.num_workers = self.mesh.num_workers
        self.wave_elems = int(wave_elems)
        self.spill_dir = spill_dir or os.path.join(tempfile.gettempdir(), "dsort_external")
        self.job_id = job_id
        self.job = job or JobConfig()
        self.resume = resume
        self.overlap = overlap
        exch = resolve_exchange(exchange, self.job.exchange, self.num_workers)
        self.hier_hosts = 0
        if exch == "hier":
            self.hier_hosts = resolve_hier_hosts(self.job.hier_hosts, self.num_workers)
            if self.hier_hosts < 2:
                log.warning(
                    "exchange='hier' needs >= 4 workers grouped into >= 2 hosts (have %d); "
                    "waves use the ring schedule", self.num_workers,
                )
                exch = "ring"
        self.exchange = exch if exch in ("fused", "hier") else "ring"
        self.redundancy = resolve_redundancy(redundancy, self.job.redundancy, self.num_workers)
        self.redundancy_mode = resolve_redundancy_mode(redundancy_mode, self.job.redundancy_mode)
        if self.redundancy > 1 and self.exchange != "ring":
            log.warning(
                "redundancy=%d needs the ring schedule; coded waves override exchange=%r "
                "to 'ring'", self.redundancy, self.exchange,
            )
            self.exchange = "ring"
        #: Test seam around a wave's exchange: the same mid-ring injection
        #: point as `SampleSort.fault_hook` (after the exchange on a coded
        #: wave, whose plane is then placed).
        self.fault_hook = None
        self._copy_stream = copy_stream(self.mesh.device)

    # -- the sort ------------------------------------------------------------

    def sort(
        self, data: np.ndarray, out: np.ndarray | None = None, metrics: Metrics | None = None,
    ) -> np.ndarray:
        """Sort ``data`` (ndarray or memmap) out-of-core over the mesh.

        ``data`` is read in wave-sized slices and ``out`` may be a memmap.
        Float keys ride as ordered uints and unmap at egress, like
        `ExternalSort`.
        """
        metrics = metrics if metrics is not None else Metrics()
        timer = PhaseTimer(metrics)
        n = len(data)
        if n == 0:
            return np.asarray(data).copy() if out is None else out
        fdt = np.dtype(data.dtype) if is_float_np_dtype(data.dtype) else None
        storage = ordered_uint_dtype(fdt) if fdt is not None else np.dtype(data.dtype)
        mapper = float_to_ordered_uint if fdt is not None else None
        metrics.event("job_start", mode="wave_external", n_keys=n, job_id=self.job_id)
        num_waves = -(-n // self.wave_elems)
        with timer.phase("splitter_sample"):
            splitters = sample_global_splitters(data, n, self.num_workers, mapper=mapper)
        ckpt = ShardCheckpoint(self.spill_dir, self.job_id)
        ckpt.journal = metrics.journal
        _sync_wave_manifest(
            ckpt, resume=self.resume, job_id=self.job_id, num_waves=num_waves,
            num_ranges=self.num_workers, wave_elems=self.wave_elems, dtype=data.dtype,
            total=n, fingerprint=_fingerprint(data), storage_dtype=str(storage),
            splitters=splitters,
        )
        with timer.phase("run_generation"):
            self._run_waves(data, n, num_waves, splitters, storage, ckpt, metrics, timer, mapper)
        with timer.phase("merge"):
            if fdt is not None:
                target = out.view(storage) if out is not None else np.empty(n, dtype=storage)
            else:
                target = out if out is not None else np.empty(n, dtype=storage)
            self._merge_ranges(num_waves, n, ckpt, target)
        if fdt is not None:
            if out is None:
                out = np.empty(n, dtype=fdt)
            # Chunked unmap: O(wave_elems) temporaries, alias-safe.
            for lo in range(0, n, self.wave_elems):
                sl = slice(lo, min(lo + self.wave_elems, n))
                out[sl] = ordered_uint_to_float(target[sl], fdt)
            result = out
        else:
            result = target if out is None else out
        metrics.event("job_done", n_keys=n, counters=dict(metrics.counters))
        return result

    def sort_binary_file(
        self, in_path: str, out_path: str, dtype=np.int32, metrics: Metrics | None = None,
    ) -> None:
        """Sort a raw binary key file out-of-core end to end (memmap in,
        memmap out): ``cli external --mesh``'s entry point."""
        dtype = np.dtype(dtype)
        size = os.path.getsize(in_path)
        if size % dtype.itemsize:
            raise ValueError(
                f"{in_path}: size {size} not a multiple of itemsize {dtype.itemsize}"
            )
        n = size // dtype.itemsize
        if n == 0:
            open(out_path, "wb").close()
            return
        data = np.memmap(in_path, dtype=dtype, mode="r")
        out = _open_out(out_path, dtype, n)
        self.sort(data, out=out, metrics=metrics)
        out.flush()

    # -- wave machinery ------------------------------------------------------

    def _read_mapped(self, data, n, w, mapper):
        lo = w * self.wave_elems
        sl = data[lo : min(lo + self.wave_elems, n)]
        arr = np.array(sl) if isinstance(data, np.memmap) else np.asarray(sl)
        return mapper(arr) if mapper is not None else arr

    def _run_waves(
        self, data, n, num_waves, splitters, storage, ckpt, metrics, timer, mapper
    ) -> None:
        from dsort_tpu_torch.data.partition import pad_to_shards

        p = self.num_workers
        fresh, partial = _classify_waves(ckpt, num_waves, p, metrics)
        # Interrupted waves first: the run-granular repair needs no mesh.
        for w, missing in partial:
            with timer.phase("wave_repair"):
                arr = self._read_mapped(data, n, w, mapper)
                self._repair_wave(arr, w, missing, splitters, ckpt, metrics,
                                  reason="restart_resume")
            _die_check(w)
        if not fresh:
            return
        wide = _device_dtype(storage)
        with device_scope(self.mesh.device):
            spl = upload_keys(splitters.astype(wide, copy=False), self.mesh.device)

        def read(w):
            with timer.phase("wave_read"):
                arr = self._read_mapped(data, n, w, mapper)
                shards, counts = pad_to_shards(arr, p, cap=_shard_cap(self.wave_elems, p))
            return arr, shards.astype(wide, copy=False), counts

        def dispatch(w, chunk):
            arr, shards, counts = chunk
            metrics.event("wave_start", wave=w, n_keys=len(arr))
            try:
                with device_scope(self.mesh.device):
                    return self._dispatch_wave(shards, counts, spl, storage, metrics, timer)
            except Exception as e:  # the coded seam, then the repair path
                # A loss in a CODED wave carries the plane's snapshot: the
                # wave completes from it here, zero runs re-sorted, and the
                # pipeline moves on (None skips the retire).  Anything else,
                # an over-budget loss included, falls through to the repair.
                state = getattr(e, "coded_state", None)
                if state is not None and self._coded_recover_wave(
                    w, e, state, storage, ckpt, metrics, timer
                ):
                    return None
                raise

        def retire(w, chunk, state, save):
            self._retire_wave(w, state, storage, ckpt, metrics, timer, save)

        def repair(w, chunk, reason):
            with timer.phase("wave_repair"):
                self._repair_wave(chunk[0], w, list(range(p)), splitters, ckpt, metrics,
                                  reason=reason)

        _run_wave_pipeline(
            [w for w, _ in fresh], read=read, dispatch=dispatch, retire=retire,
            repair=repair, die_check=_die_check, overlap=self.overlap,
        )

    def _dispatch_wave(self, shards, counts, spl, storage, metrics, timer):
        """Queue one wave's plan and exchange; returns ``(rows fetch,
        overflow fetch or None, per-range key counts)``, the copies back
        already queued.  The plan's ``(P, P)`` histogram is the wave's one
        synchronising copy: it sizes the ring's steps."""
        from dsort_tpu_torch.ops.local_sort import sort_padded
        from dsort_tpu_torch.parallel.exchange import (
            _wave_plan_shard,
            note_fused_plan,
            note_ring_plan,
            ring_caps,
        )

        p = self.num_workers
        dev = self.mesh.device
        n_local = shards.shape[1]
        kernel = self.job.local_kernel
        if p == 1:
            with timer.phase("wave_sort"):
                y, _ = sort_padded(upload_keys(shards, dev), int(counts[0]), kernel)
                fetch = PendingFetch(from_carrier_bits(y, shards.dtype), self._copy_stream)
            return fetch, None, counts.astype(np.int64)
        fused = self.exchange == "fused"
        hier = self.exchange == "hier"
        coded = self.redundancy > 1
        with timer.phase("wave_sort"):
            xs = upload_keys(shards, dev)
            cj = torch.from_numpy(counts).to(dev)
            xs_sorted, hist = _wave_plan_shard(xs, cj, spl, kernel=kernel)
            hist_h = hist.cpu().numpy()
        caps = ring_caps(hist_h, n_local, p)
        args = (metrics, caps, hist_h, n_local, p, storage.itemsize, self.job.capacity_factor)
        hplan = None
        if coded:
            from dsort_tpu_torch.parallel.exchange import note_coded_plan

            note_coded_plan(*args, self.redundancy, mode=self.redundancy_mode)
        elif hier:
            from dsort_tpu_torch.parallel.exchange import hier_plan, note_hier_plan

            hplan = hier_plan(hist_h, n_local, p, self.hier_hosts)
            note_hier_plan(metrics, hplan, *args[1:])
        else:
            (note_fused_plan if fused else note_ring_plan)(*args)
        if not coded and self.fault_hook is not None:
            self.fault_hook()
        kw = dict(merge_kernel=self.job.merge_kernel, kernel=kernel)
        with timer.phase("wave_exchange"):
            if coded:
                from dsort_tpu_torch.parallel.exchange import (
                    _coded_ring_exchange_shard,
                    _parity_ring_exchange_shard,
                )

                shard = (_parity_ring_exchange_shard if self.redundancy_mode == "parity"
                         else _coded_ring_exchange_shard)
                outs = shard(xs_sorted, cj, spl, redundancy=self.redundancy, caps=caps, **kw)
                merged, overflow = outs[0], outs[2]
            elif hier:
                from dsort_tpu_torch.parallel.exchange import _hier_exchange_shard

                merged, _, overflow = _hier_exchange_shard(
                    xs_sorted, cj, spl, hosts=hplan.hosts, agg_cap=hplan.agg_cap,
                    leg_caps=hplan.leg_caps, scatter_cap=hplan.scatter_cap, **kw,
                )
            elif fused:
                from dsort_tpu_torch.ops.ring_kernel import fused_ring_exchange_shard

                merged, _, overflow = fused_ring_exchange_shard(
                    xs_sorted, cj, spl, hist, caps=caps, **kw
                )
            else:
                from dsort_tpu_torch.parallel.exchange import _ring_exchange_shard

                merged, _, overflow = _ring_exchange_shard(xs_sorted, cj, spl, caps=caps, **kw)
        if coded and self.fault_hook is not None:
            from dsort_tpu_torch.parallel import coded as cd
            from dsort_tpu_torch.scheduler.fault import WorkerFailure

            try:
                self.fault_hook()
            except WorkerFailure as e:
                # The plane was placed with the exchange: snapshot what the
                # survivors hold, so the wave repairs from it
                # (`_coded_recover_wave`), no host re-sort.
                snap = (cd.snapshot_parity_state if self.redundancy_mode == "parity"
                        else cd.snapshot_state)
                e.coded_state = snap(p, self.redundancy, caps, int(hist_h.sum()), *outs)
                raise
        # Keys landing on each range this wave, from the fetched histogram:
        # the retire needs no further count.
        recv_lens = hist_h.sum(axis=0).astype(np.int64)
        return (PendingFetch(from_carrier_bits(merged, shards.dtype), self._copy_stream),
                PendingFetch(overflow, self._copy_stream), recv_lens)

    def _retire_wave(self, w, state, storage, ckpt, metrics, timer, save) -> None:
        """Wave ``w``'s completion: wait for its copy (under overlap, while
        wave ``w+1`` is already on the card), check the overflow invariant,
        spill one run per range."""
        from dsort_tpu_torch.parallel.exchange import check_ring_overflow

        fetch, overflow, recv_lens = state
        p = self.num_workers
        with timer.phase("wave_spill"):
            with device_scope(self.mesh.device):
                if overflow is not None:
                    check_ring_overflow(overflow.wait())
                mh = _to_storage(fetch.wait(), storage).reshape(p, -1)
            total = 0
            for r in range(p):
                run = np.array(mh[r, : int(recv_lens[r])])
                total += len(run)
                save(ckpt.save_wave_run, w, r, run)
        metrics.bump("waves_sorted")
        metrics.bump("runs_sorted", p)
        metrics.event("wave_done", wave=w, runs=p, n_keys=total)

    def _repair_wave(self, arr, w, missing, splitters, ckpt, metrics, reason) -> None:
        """Run-granular recompute on the host: range ``r`` of wave ``w`` is
        the sorted subset the fixed splitters assign to ``r``."""
        p = self.num_workers
        metrics.event(
            "wave_resume", wave=w, missing=len(missing), present=p - len(missing),
            reason=reason,
        )
        timer = PhaseTimer(metrics)
        with timer.phase("wave_repair_select"):
            subsets = [arr[_range_mask(arr, splitters, r, p)] for r in missing]
        with timer.phase("wave_repair_sort"):
            runs = [np.sort(sub, kind="stable") for sub in subsets]
        del subsets
        _spill_repaired(w, missing, runs, ckpt, metrics, timer)
        log.warning("wave %d repaired: %d/%d runs re-sorted on host (%s)",
                    w, len(missing), p, reason)

    def _coded_recover_wave(self, w, exc, state, storage, ckpt, metrics, timer) -> bool:
        """Complete wave ``w`` from the coded exchange's plane: the dead
        range is rebuilt by a local merge of a survivor's slots and every
        range lands in the store, ``wave_runs_resorted`` untouched.  False
        (``coded_budget_exceeded`` journaled) when the losses exceed the
        budget: the caller re-raises into the host re-sort."""
        from dsort_tpu_torch.parallel.coded import dead_positions, journal_recovery

        positions = dead_positions(exc)
        rec = journal_recovery(metrics, state, positions, assemble=False, wave=w)
        if rec is None:
            log.warning(
                "wave %d: coded recovery over budget (positions %s at redundancy=%d); "
                "repairing by host re-sort", w, sorted(positions), state.redundancy,
            )
            return False
        ranges, info = rec
        p = self.num_workers
        wide = _device_dtype(storage)
        sdt = np.dtype(f"i{wide.itemsize}")
        with timer.phase("wave_spill"):
            total = 0
            for r in range(p):
                run = np.asarray(ranges[r]).astype(sdt, copy=False)
                if wide.kind == "u":  # the signed carrier back to its bits
                    run = run ^ np.iinfo(sdt).min
                run = _to_storage(run, storage)
                total += len(run)
                ckpt.save_wave_run(w, r, run)
        metrics.bump("waves_sorted")
        metrics.bump("runs_sorted", p)
        metrics.event("wave_done", wave=w, runs=p, n_keys=total)
        log.warning(
            "wave %d repaired CODED: %d key(s) of %d dead range(s) recovered from the %s "
            "plane — zero runs re-sorted", w, info["recovered_keys"], len(positions), state.mode,
        )
        _die_check(w)
        return True

    def _merge_ranges(self, num_waves, n, ckpt, target) -> None:
        p = self.num_workers
        off = 0
        for r in range(p):
            runs = [ckpt.load_wave_run_mmap(w, r) for w in range(num_waves)]
            ln = sum(len(x) for x in runs)
            _merge_runs_into(runs, target[off : off + ln])
            off += ln
        if off != n:  # a lost run would silently shift every later range
            raise RuntimeError(
                f"wave merge assembled {off} of {n} keys; the run store is "
                "inconsistent — clear the spill dir and re-run"
            )


class ExternalWaveTeraSort:
    """Record (TeraSort) twin of `ExternalWaveSort`.

    Run generation is mesh-parallel: each wave's records shard over the
    mesh and every row sorts by the full 10-byte key
    (`external_sort.sort_records_on_device`) in one collective-free
    dispatch.  The exchange is on the host, as in the reference: while wave
    ``k`` sorts on the card, wave ``k-1``'s sorted rows split at the fixed
    prefix splitters and each range's ``P`` pieces merge (an in-memory
    lexsort: the native two-level heap merge is not ported) into one
    ``(wave, run)`` record run.  The final phase merges each range's runs
    across waves into the output memmap; the ranges concatenate in splitter
    order.  Resume contract and crash hook are the key pipeline's.

    ``redundancy > 1`` retains each wave's sorted rows on the host before
    the fault seam (the copy the host-side split needs anyway), so a loss
    after the wave's sort retires the wave from that copy:
    ``coded_recover`` with ``mode="retain"`` and zero runs re-sorted.
    """

    RECORD_BYTES = RECORD_BYTES

    def __init__(
        self,
        mesh: VirtualMesh | None = None,
        wave_recs: int = 1 << 20,
        spill_dir: str | None = None,
        job_id: str = "tera_wave",
        resume: bool = True,
        overlap: bool = True,
        job: JobConfig | None = None,
        exchange: str | None = None,
        redundancy: int | None = None,
        redundancy_mode: str | None = None,
    ):
        if wave_recs < 2:
            raise ValueError("wave_recs must be >= 2")
        from dsort_tpu_torch.parallel.exchange import (
            resolve_exchange,
            resolve_redundancy,
            resolve_redundancy_mode,
        )

        self.mesh = mesh if mesh is not None else VirtualMesh(8)
        self.num_workers = self.mesh.num_workers
        self.wave_recs = int(wave_recs)
        self.spill_dir = spill_dir or os.path.join(tempfile.gettempdir(), "dsort_external")
        self.job_id = job_id
        self.job = job or JobConfig()
        self.resume = resume
        self.overlap = overlap
        # The record wave's exchange is on the host: a device schedule is
        # validated and recorded, with a warning that none is selected.
        self.exchange = resolve_exchange(exchange, self.job.exchange, self.num_workers)
        if self.exchange != "alltoall":
            log.warning(
                "the record wave pipeline's exchange is host-side (split + merge); "
                "exchange=%r selects no device schedule here", self.exchange,
            )
        self.redundancy = resolve_redundancy(redundancy, self.job.redundancy, self.num_workers)
        self.redundancy_mode = resolve_redundancy_mode(redundancy_mode, self.job.redundancy_mode)
        self.fault_hook = None
        self._copy_stream = copy_stream(self.mesh.device)

    def sort_file(self, in_path: str, out_path: str, metrics: Metrics | None = None) -> None:
        """Sort a binary TeraSort file out-of-core through the wave mesh."""
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
        metrics.event("job_start", mode="wave_external_kv", n_keys=n, job_id=self.job_id)
        num_waves = -(-n // self.wave_recs)
        with timer.phase("splitter_sample"):
            splitters = sample_global_splitters(
                data, n, self.num_workers, mapper=lambda rows: record_keys(np.asarray(rows))[0],
            )
        ckpt = ShardCheckpoint(self.spill_dir, self.job_id)
        ckpt.journal = metrics.journal
        _sync_wave_manifest(
            ckpt, resume=self.resume, job_id=self.job_id, num_waves=num_waves,
            num_ranges=self.num_workers, wave_elems=self.wave_recs, dtype=np.uint8,
            total=n, fingerprint=_fingerprint(data), storage_dtype="terasort100",
            splitters=splitters,
        )
        with timer.phase("run_generation"):
            self._run_waves(data, n, num_waves, splitters, ckpt, metrics, timer)
        with timer.phase("merge"):
            out = np.memmap(out_path, dtype=np.uint8, mode="w+", shape=(n, self.RECORD_BYTES))
            self._merge_ranges(num_waves, n, ckpt, out)
            out.flush()
        metrics.event("job_done", n_keys=n, counters=dict(metrics.counters))

    # -- wave machinery ------------------------------------------------------

    def _read_wave(self, data, n, w) -> np.ndarray:
        lo = w * self.wave_recs
        return np.array(data[lo : min(lo + self.wave_recs, n)])

    def _run_waves(self, data, n, num_waves, splitters, ckpt, metrics, timer) -> None:
        p = self.num_workers
        fresh, partial = _classify_waves(ckpt, num_waves, p, metrics)
        for w, missing in partial:
            with timer.phase("wave_repair"):
                self._repair_wave(self._read_wave(data, n, w), w, missing, splitters, ckpt,
                                  metrics, reason="restart_resume")
            _die_check(w)
        if not fresh:
            return

        def read(w):
            with timer.phase("wave_read"):
                recs = self._read_wave(data, n, w)
                shards = self._pad_shards(recs)
            return recs, shards

        def dispatch(w, chunk):
            recs, shards = chunk
            metrics.event("wave_start", wave=w, n_keys=len(recs))
            try:
                with device_scope(self.mesh.device):
                    return self._dispatch_wave(shards, timer)
            except Exception as e:  # the coded seam, then the repair path
                # A loss in a CODED record wave carries the retained rows:
                # the wave retires from them here, zero runs re-sorted.
                state = getattr(e, "wave_record_state", None)
                if state is not None:
                    self._coded_recover_wave(w, e, state, splitters, ckpt, metrics, timer)
                    return None
                raise

        def retire(w, chunk, state, save):
            self._retire_wave(w, state, splitters, ckpt, metrics, timer, save)

        def repair(w, chunk, reason):
            with timer.phase("wave_repair"):
                self._repair_wave(chunk[0], w, list(range(p)), splitters, ckpt, metrics,
                                  reason=reason)

        _run_wave_pipeline(
            [w for w, _ in fresh], read=read, dispatch=dispatch, retire=retire,
            repair=repair, die_check=_die_check, overlap=self.overlap,
        )

    def _pad_shards(self, recs: np.ndarray):
        """Host layout: ``(P, cap, 100)`` records, zero-padded (the sort
        masks pads by count), and the per-row counts."""
        from dsort_tpu_torch.data.partition import equal_partition

        p = self.num_workers
        cap = _shard_cap(self.wave_recs, p)
        sizes = equal_partition(len(recs), p)
        rv = np.zeros((p, cap, self.RECORD_BYTES), np.uint8)
        off = 0
        for i, s in enumerate(sizes):
            rv[i, :s] = recs[off : off + s]
            off += s
        return rv, np.asarray(sizes, np.int32)

    def _dispatch_wave(self, shards, timer):
        rv, counts = shards
        dev = self.mesh.device
        with timer.phase("wave_sort"):
            y = sort_records_on_device(rv, torch.from_numpy(counts).to(dev), dev)
            fetch = PendingFetch(y, self._copy_stream)
        retained = None
        if self.redundancy > 1:
            # The redundancy plane of the host-side exchange: wait for the
            # copy the retire needs anyway BEFORE the fault seam, so a loss
            # past this point cannot take the wave's work with it.
            with timer.phase("wave_spill"):
                retained = fetch.wait()
        if self.fault_hook is not None:
            from dsort_tpu_torch.scheduler.fault import WorkerFailure

            try:
                self.fault_hook()
            except WorkerFailure as e:
                if retained is not None:
                    e.wave_record_state = (retained, counts)
                raise
        return (retained if retained is not None else fetch), counts

    def _retire_wave(self, w, state, splitters, ckpt, metrics, timer, save) -> None:
        """Host-side exchange and run merge for one wave: split each row's
        sorted records at the fixed splitters, then merge each range's ``P``
        pieces into its single (wave, run) record run."""
        rows, counts = state
        p = self.num_workers
        with timer.phase("wave_spill"):
            if isinstance(rows, PendingFetch):
                with device_scope(self.mesh.device):
                    rows = rows.wait()
            rows = rows.reshape(p, -1, self.RECORD_BYTES)
            per_range: list[list[np.ndarray]] = [[] for _ in range(p)]
            for d in range(p):
                shard = rows[d, : int(counts[d])]
                k1, _ = record_keys(shard)
                bounds = np.searchsorted(k1, splitters, side="left")
                lo = 0
                for r in range(p):
                    hi = int(bounds[r]) if r < p - 1 else len(shard)
                    if hi > lo:
                        per_range[r].append(shard[lo:hi])
                    lo = hi
            total = 0
            for r in range(p):
                subs = per_range[r]
                if not subs:
                    run = np.zeros((0, self.RECORD_BYTES), np.uint8)
                elif len(subs) == 1:
                    run = np.array(subs[0])
                else:
                    run = lexsort_records(subs)
                total += len(run)
                save(ckpt.save_wave_run, w, r, run)
        metrics.bump("waves_sorted")
        metrics.bump("runs_sorted", p)
        metrics.event("wave_done", wave=w, runs=p, n_keys=total)

    def _coded_recover_wave(self, w, exc, state, splitters, ckpt, metrics, timer) -> None:
        """Complete record wave ``w`` from the retained host rows: the
        normal host-side retire runs on the retained copy, so
        ``wave_runs_resorted`` stays 0; journaled as ``coded_recover`` with
        ``mode="retain"`` and ``replica_bytes=0`` (retention ships nothing
        extra)."""
        from dsort_tpu_torch.parallel.coded import dead_positions

        t0 = time.monotonic()
        positions = sorted(set(dead_positions(exc)))
        per_range: dict[int, int] = {}

        def save(f, w_, r, run):
            per_range[r] = len(run)
            f(w_, r, run)

        self._retire_wave(w, state, splitters, ckpt, metrics, timer, save)
        recovered = sum(per_range.get(d, 0) for d in positions)
        metrics.bump("coded_recoveries")
        metrics.bump("coded_recovered_keys", recovered)
        metrics.event(
            "coded_recover", dead=positions, holders={}, recovered_keys=recovered,
            replica_bytes=0, redundancy=self.redundancy, mode="retain",
            wall_s=round(time.monotonic() - t0, 6), wave=w,
        )
        log.warning(
            "record wave %d repaired CODED: %d record(s) of %d dead range(s) retired from "
            "retained host rows — zero runs re-sorted", w, recovered, len(positions),
        )
        _die_check(w)

    def _repair_wave(self, recs, w, missing, splitters, ckpt, metrics, reason) -> None:
        p = self.num_workers
        metrics.event(
            "wave_resume", wave=w, missing=len(missing), present=p - len(missing),
            reason=reason,
        )
        timer = PhaseTimer(metrics)
        with timer.phase("wave_repair_select"):
            k1, k2 = record_keys(recs)
            masks = [_range_mask(k1, splitters, r, p) for r in missing]
        with timer.phase("wave_repair_sort"):
            runs = [recs[m][np.lexsort((k2[m], k1[m]))] for m in masks]
        del masks
        _spill_repaired(w, missing, runs, ckpt, metrics, timer)
        log.warning("record wave %d repaired: %d/%d runs re-sorted on host (%s)",
                    w, len(missing), p, reason)

    def _merge_ranges(self, num_waves, n, ckpt, out) -> None:
        p = self.num_workers
        off = 0
        for r in range(p):
            runs = [x for x in (ckpt.load_wave_run_mmap(w, r) for w in range(num_waves))
                    if len(x)]
            ln = sum(len(x) for x in runs)
            if runs:
                out[off : off + ln] = runs[0] if len(runs) == 1 else lexsort_records(runs)
            off += ln
        if off != n:
            raise RuntimeError(
                f"wave merge assembled {off} of {n} records; the run store is "
                "inconsistent — clear the spill dir and re-run"
            )
