"""The multi-process plane: one sort over the processes of a ``torch.distributed`` group.

Counterpart of ``dsort_tpu/parallel/distributed.py``.  Every process of the
group calls `sort_local_shards` (keys) or `sort_local_records` (TeraSort
records) with its own host data; the sample sort runs over all of them,
and each process gets back the contiguous slice of the globally sorted
output that its own shards own, with that slice's global offset.  Data
never funnels through one process, unlike the reference's master
(``server.c:171-216,481-524``).

- **The group.** `initialize_multihost` joins it (its arguments default
  from torch's own environment, ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK``, as ``torchrun`` sets them) with an explicit
  timeout, so a dead peer surfaces as an error in bounded time, never as a
  hang.  Without a group everything runs in one process (world 1).
- **Why gloo.** Every rank of this machine shares its one card, and NCCL
  refuses two ranks on one device.  So the backend is gloo, and every leg
  that crosses processes stages through pinned host memory: the card to a
  pinned buffer, the gloo transfer, back to the card.  An NCCL group
  across several cards waits for a machine that has them.
- **The mesh.** `ProcessGroupMesh` holds ``L`` virtual shards (rows) in each
  process, ``P = world * L`` in all, and gives the shard programs of
  `parallel.sample_sort` and `parallel.exchange` the collectives they take
  from a `VirtualMesh`: the part inside a process stays a row move, the
  part across processes is ``all_gather_into_tensor`` / ``all_to_all_single``
  / a send and receive per process pair.
- **Lockstep.** The capacity retry reduces the any-overflow and the largest
  bucket over the group, so every process takes the same branch; ``ring``
  and ``fused`` fall back to the padded all-to-all (warned), ``hier`` runs
  the two-level schedule with the processes as its hosts.
- **Recovery is restart-and-resume.** With ``job.checkpoint_dir`` and a
  ``job_id`` each process persists its output range (records: range,
  payload block and sorted secondary) under its rank, behind a
  partition-independent fingerprint manifest, the manifest first.  A re-run
  of the same ``job_id``, with the same or another process count, restores
  every persisted range and re-sorts only the missing key intervals (the
  reference's reassign-on-failure, ``server.c:367-401``).  The stores are
  the JAX package's file for file, so either package resumes the other's.

The drill hook ``DSORT_MH_DIE_BEFORE_RANGE=<rank>`` makes that rank exit
(``os._exit(17)``) after the manifest barrier and before its range lands.
"""

from __future__ import annotations

import datetime
import os
import time
import zlib

import numpy as np
import torch

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.device import resolve_device
from dsort_tpu_torch.ops.float_order import (
    from_signed_keys,
    is_float_np_dtype,
    sort_float_keys_via_uint,
    to_signed_keys,
)
from dsort_tpu_torch.utils.logging import get_logger
from dsort_tpu_torch.utils.metrics import Metrics, PhaseTimer

log = get_logger("distributed")

#: The group's default timeout: a collective with a dead peer errors after
#: at most this long.
DEFAULT_TIMEOUT_S = 300.0
#: The crash drill's hook: the named rank exits before its range persists.
DIE_BEFORE_RANGE_ENV = "DSORT_MH_DIE_BEFORE_RANGE"

#: SPMD contract (parsed, not imported — `dsort_tpu_torch.analysis.spmd`).
#: The process-group plane: every collective here blocks the whole gloo
#: group, so none may sit under a branch on the process rank (DS1202) —
#: a rank that skips it leaves the others waiting until the group's
#: timeout.  Control decisions that differ per rank go through
#: `_allgather_u64` / `_global_max` first, so every rank branches alike.
SPMD_CONTRACT = {"plane": "device"}


def _dist():
    import torch.distributed as dist

    return dist


def _gather_into(out: torch.Tensor, src: torch.Tensor) -> None:
    """``all_gather`` of equal host tensors into one, in rank order (the
    call's name moved between torch releases)."""
    dist = _dist()
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, src)


def _rank_world() -> tuple[int, int]:
    """``(rank, world)`` of the initialised group; ``(0, 1)`` without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_multihost(
    init_method: str | None = None, world_size: int | None = None,
    rank: int | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group if one is configured; True when joined.

    ``init_method`` is any of torch's (``tcp://host:port``,
    ``file:///path``); without one the group is named by the environment
    ``torchrun`` sets (``MASTER_ADDR`` and ``MASTER_PORT``, with
    ``WORLD_SIZE`` and ``RANK``), and with neither this is a single-process
    run: False, nothing joined.  The backend is gloo (module docstring).
    """
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            return False
        init_method = "env://"
    kw = {}
    world = world_size if world_size is not None else os.environ.get("WORLD_SIZE")
    me = rank if rank is not None else os.environ.get("RANK")
    if world is not None:
        kw["world_size"] = int(world)
    if me is not None:
        kw["rank"] = int(me)
    _dist().init_process_group(
        "gloo", init_method=init_method, timeout=datetime.timedelta(seconds=timeout_s), **kw
    )
    r, w = _rank_world()
    log.info("joined the process group: rank %d of %d (gloo)", r, w)
    return True


class ProcessGroupMesh:
    """``local_workers`` virtual shards in every process of the group.

    Rows ``rank * L .. rank * L + L - 1`` of the global ``P = world * L``
    worker mesh live here, as the leading axis of this process's tensors.
    The collectives are `VirtualMesh`'s, acting across the group.  Tensors
    cross processes as bytes (gloo takes any dtype so), staged through
    pinned host memory from a card.  ``wire_s`` / ``wire_bytes`` add up
    the host time spent in the cross-process legs (staging included) and
    the bytes this process sent on them.
    """

    def __init__(self, local_workers: int = 1, device=None):
        if local_workers < 1:
            raise ValueError(f"local_workers must be >= 1, got {local_workers}")
        self.rank, self.world = _rank_world()
        self.local_workers = int(local_workers)
        self.num_workers = self.world * self.local_workers
        self.device = resolve_device(device)
        self.wire_s = 0.0
        self.wire_bytes = 0

    def row_ids(self, rows: int, device) -> torch.Tensor:
        return self.rank * self.local_workers + torch.arange(rows, device=device)

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a contiguous host byte tensor (pinned from a card)."""
        x = x.contiguous()
        if x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            x = host
        return x.view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8)

    def _from_wire(self, b: torch.Tensor, dtype, shape) -> torch.Tensor:
        return b.view(dtype).reshape(shape).to(self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's ``(L, s)`` rows -> the ``(1, P*s)`` every shard sees."""
        if self.world == 1:
            return x.reshape(1, -1)
        t0 = time.perf_counter()
        src = self._to_wire(x.reshape(-1))
        out = torch.empty(self.world * src.numel(), dtype=torch.uint8)
        _gather_into(out, src)
        self.wire_bytes += src.numel() * (self.world - 1)
        got = self._from_wire(out, x.dtype, (1, -1))
        self.wire_s += time.perf_counter() - t0
        return got

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``(L_src, P_dst, ...)`` -> ``(L_dst, P_src, ...)``: local row d is
        what global shard ``rank * L + d`` receives, ordered by source."""
        w, lw = self.world, self.local_workers
        rest = send.shape[2:]
        if w == 1:
            return send.reshape((lw, lw) + rest).transpose(0, 1).contiguous()
        t0 = time.perf_counter()
        # (L_src, W, L_dst) -> (W, L_src, L_dst): chunk r goes to rank r.
        chunks = send.reshape((lw, w, lw) + rest).transpose(0, 1)
        src = self._to_wire(chunks)
        out = torch.empty_like(src)
        _dist().all_to_all_single(out, src)
        self.wire_bytes += src.numel() // w * (w - 1)
        recv = self._from_wire(out, send.dtype, (w, lw, lw) + rest)  # (W_src, L_src, L_dst)
        got = recv.permute((2, 0, 1) + tuple(range(3, 3 + len(rest))))
        got = got.contiguous().view(send.shape)
        self.wire_s += time.perf_counter() - t0
        return got

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """`VirtualMesh.ppermute` over global positions: a pair inside this
        process is a row move, a pair across processes one send and one
        receive between them."""
        dist = _dist()
        lw, me = self.local_workers, self.rank
        out = torch.zeros_like(x)
        ops, landing = [], []
        t0 = time.perf_counter()
        for src, dst in pairs:
            s_rank, d_rank = src // lw, dst // lw
            if s_rank == me and d_rank == me:
                out[dst % lw] = x[src % lw]
            elif s_rank == me:
                buf = self._to_wire(x[src % lw])
                ops.append(dist.P2POp(dist.isend, buf, d_rank))
                self.wire_bytes += buf.numel()
            elif d_rank == me:
                buf = self._to_wire(torch.empty_like(x[dst % lw], device="cpu"))
                ops.append(dist.P2POp(dist.irecv, buf, s_rank))
                landing.append((dst % lw, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for row, buf in landing:
                out[row] = self._from_wire(buf, x.dtype, x.shape[1:])
            self.wire_s += time.perf_counter() - t0
        return out


def global_worker_mesh(local_workers: int = 1, device=None) -> ProcessGroupMesh:
    """The mesh over every process of the group: ``local_workers`` shards
    here, on ``device`` (``cuda`` unless ``cpu`` is asked)."""
    return ProcessGroupMesh(local_workers, device)


# -- agreement across the group -------------------------------------------------


def _allgather_u64(vals) -> np.ndarray:
    """Every process's ``vals`` (u64 / int64), ``(world, len)`` uint64 in
    rank order."""
    v = np.ascontiguousarray(np.asarray(vals, np.uint64).reshape(-1))
    rank, world = _rank_world()
    if world == 1:
        return v.reshape(1, -1).copy()
    src = torch.from_numpy(v.view(np.int64).copy())
    out = torch.empty(world * len(v), dtype=torch.int64)
    _gather_into(out, src)
    return out.numpy().view(np.uint64).reshape(world, len(v))


def _global_max(vals) -> np.ndarray:
    """Elementwise max of int64 ``vals`` over the group."""
    t = torch.as_tensor(np.asarray(vals, np.int64).reshape(-1))
    if _rank_world()[1] > 1:
        dist = _dist()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()


def _agree_cap(n_items: int, n_local_workers: int) -> int:
    """One per-shard capacity for every process, whatever their loads."""
    my_cap = -(-max(n_items, 1) // (8 * n_local_workers)) * 8
    return int(_global_max([my_cap])[0])


def _cap_pair_for(factor: float, cap: int, p_total: int) -> int:
    """The shared capacity policy (`sample_sort.cap_pair_policy`)."""
    from dsort_tpu_torch.parallel.sample_sort import cap_pair_policy

    return cap_pair_policy(cap, factor, p_total)


def _mh_sync(tag: str) -> None:
    """Barrier: every process reaches ``tag`` before any goes on."""
    if _rank_world()[1] > 1:
        _dist().barrier()


def _global_fingerprint(local_data, payload=None) -> tuple[str, int]:
    """Partition-independent job identity: ``(fingerprint, global_total)``.

    The input-to-process mapping may change between runs (a 2-process job
    restarting as 1 process must still restore), so the identity is the
    global record multiset: the FNV-1a multiset checksum
    (`models.validate._multiset`) summed over processes mod 2^64, with the
    global count and the dtypes — the JAX package's string, so the stores
    compare across packages.  A dtype or payload-shape tag that differs
    between processes raises ``ValueError`` before any control flow can
    diverge (and the next barrier deadlock).
    """
    from dsort_tpu_torch.models.validate import _multiset

    local = np.ascontiguousarray(local_data)
    n = len(local)
    kw = local.dtype.itemsize
    if payload is not None:
        # Widths from metadata, never from the data: a process with no
        # records computes the same tag and layout as its peers.
        pay = np.ascontiguousarray(payload)
        pw = int(np.prod(pay.shape[1:], dtype=np.int64)) * pay.dtype.itemsize
        rows = np.concatenate(
            [local.view(np.uint8).reshape(n, kw), pay.view(np.uint8).reshape(n, pw)], axis=1
        )
        h = _multiset(rows, n, kw + pw)
        dt = f"{local.dtype}+{pay.dtype}x{tuple(pay.shape[1:])}"
    else:
        h = _multiset(local, n, kw)
        dt = str(local.dtype)
    g = _allgather_u64([h, n, zlib.crc32(dt.encode("utf-8"))])
    if not (g[:, 2] == g[0, 2]).all():
        bad = [int(p) for p in np.nonzero(g[:, 2] != g[0, 2])[0]]
        raise ValueError(
            f"multihost dtype/payload-shape tag disagrees across processes (this process: "
            f"{dt!r}; differing process ids: {bad}) — all hosts must pass identical "
            "key/payload dtypes and shapes"
        )
    total = int(g[:, 1].sum())
    checksum = int(g[:, 0].sum(dtype=np.uint64))
    return f"{total}:{dt}:{checksum:016x}", total


def _per_host_egress(out_counts, rows_list) -> tuple[list[np.ndarray], int]:
    """This process's trimmed rows of each tensor in ``rows_list`` (all
    ``(L, width, ...)``, valid counts ``out_counts``), copied to the host,
    and the global offset of the slice: the valid counts of every earlier
    process."""
    from dsort_tpu_torch.parallel.sample_sort import _trim_rows

    c = out_counts.cpu().numpy().astype(np.int64)
    n = int(c.sum())
    outs = [_trim_rows(r, c, n, "rows").cpu().numpy() for r in rows_list]
    rank, _ = _rank_world()
    offset = int(_allgather_u64([n])[:rank].sum())
    return outs, offset


def _upload(mesh: ProcessGroupMesh, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _attach_mh_observers(job: JobConfig, metrics: Metrics, mesh: ProcessGroupMesh) -> None:
    """A flight recorder for this job call when the job configures one (no
    scheduler owns the multi-process path, so one attaches per call): its
    bundles name the process group's state — ``mode``, this ``process``,
    the ``processes`` of the group and its ``local_devices`` (the shards
    this rank holds on the card)."""
    if not job.flight_recorder_dir:
        return
    from dsort_tpu_torch.obs.flight import FlightRecorder

    FlightRecorder(
        job.flight_recorder_dir,
        ring_size=job.flight_ring_size,
        state_fn=lambda: {
            "mode": "multihost",
            "process": mesh.rank,
            "processes": mesh.world,
            "local_devices": mesh.local_workers,
        },
        config=job,
    ).attach(metrics)


# -- keys -----------------------------------------------------------------------


def sort_local_shards(
    local_data, job: JobConfig | None = None, metrics: Metrics | None = None,
    job_id: str | None = None, mesh: ProcessGroupMesh | None = None,
):
    """Sort every process's keys as one job (call from every process).

    Returns ``(local_sorted, global_offset)``: this process's slice of the
    globally sorted, range-partitioned output and its start in it.  All
    processes make the same call (same ``job``; ``mesh`` with the same
    ``local_workers``; default one shard a process on the card).  Float
    keys pass through the ordered uints (`ops.float_order`).

    With ``job.checkpoint_dir`` and ``job_id`` the job is recoverable
    (module docstring): a re-run restores what was persisted and re-sorts
    only the missing key intervals, under the same or another process
    count.
    """
    local_data = np.asarray(local_data)
    if is_float_np_dtype(local_data.dtype):
        return sort_float_keys_via_uint(sort_local_shards, local_data, job, metrics, job_id, mesh)
    job = job or JobConfig()
    metrics = metrics if metrics is not None else Metrics()
    mesh = mesh if mesh is not None else global_worker_mesh()
    _attach_mh_observers(job, metrics, mesh)
    metrics.event("job_start", mode="multihost", n_keys=len(local_data), job_id=job_id,
                  process=mesh.rank, tenant=job.tenant)
    # The journal merger's alignment handshake: one (wall, mono) pair per
    # process journal.
    metrics.event("clock_sync", process=mesh.rank)
    if job.checkpoint_dir and job_id:
        out = _sort_local_shards_ckpt(local_data, job, metrics, job_id, mesh)
    else:
        out = _sort_local_shards_plain(local_data, job, metrics, mesh)
    metrics.event("job_done", n_keys=len(out[0]), counters=dict(metrics.counters))
    return out


def _retry_loop(job, metrics, timer, cap, p_total, run):
    """The lockstep capacity retry: ``run(cap_pair)`` returns ``(outs,
    overflow, max_len)``; the any-overflow and the largest bucket reduce
    over the group, so every process computes the same next capacity."""
    from dsort_tpu_torch.parallel.sample_sort import next_cap_pair

    cap_pair = _cap_pair_for(job.capacity_factor, cap, p_total)
    for _ in range(job.max_capacity_retries + 1):
        with timer.phase("spmd_sort"):
            outs, overflow, max_len = run(cap_pair)
            local = torch.stack([overflow.long().max(), max_len.long().max()]).cpu().numpy()
            any_ov, observed = (int(v) for v in _global_max(local))
        if not any_ov:
            return outs
        metrics.bump("capacity_retries")
        cap_pair = next_cap_pair(observed, cap_pair, cap, p_total)
        metrics.event("capacity_retry", observed=observed, cap_pair=cap_pair)
        log.warning("multihost bucket overflow (max bucket %d): retrying with cap_pair=%d",
                    observed, cap_pair)
    raise RuntimeError("sample sort bucket overflow after max retries")


def _sort_local_shards_plain(local_data, job, metrics, mesh):
    """The sort itself, no checkpoint (see `sort_local_shards`)."""
    from dsort_tpu_torch.data.partition import pad_to_shards
    from dsort_tpu_torch.parallel.exchange import resolve_exchange, resolve_hier_hosts
    from dsort_tpu_torch.parallel.sample_sort import _sample_sort_shard

    timer = PhaseTimer(metrics)
    p_total, lw = mesh.num_workers, mesh.local_workers
    key_dtype = local_data.dtype
    with timer.phase("partition"):
        cap = _agree_cap(len(local_data), lw)
        shards, counts = pad_to_shards(local_data, lw, cap=cap)
        xs = to_signed_keys(_upload(mesh, shards))
        cj = _upload(mesh, counts)
    exch = resolve_exchange(None, job.exchange, p_total)
    if exch == "hier":
        hosts = resolve_hier_hosts(job.hier_hosts, p_total)
        if hosts >= 2:
            return _sort_local_shards_hier(job, metrics, timer, mesh, xs, cj, cap, hosts,
                                           key_dtype)
        log.warning(
            "exchange='hier' needs >= 4 global devices grouped into >= 2 hosts (have %d); "
            "the multi-process sort falls back to the padded all_to_all", p_total,
        )
    elif exch != "alltoall":
        log.warning(
            "exchange=%r has no multi-process schedule yet; the sort uses the padded "
            "all_to_all (exchange='hier' is the two-level pod schedule)", exch,
        )

    def run(cap_pair):
        merged, out_counts, overflow, max_len = _sample_sort_shard(
            xs, cj, mesh=mesh, oversample=job.oversample, cap_pair=cap_pair,
            kernel=job.local_kernel, merge_kernel=job.merge_kernel,
        )
        return (merged, out_counts), overflow, max_len

    merged, out_counts = _retry_loop(job, metrics, timer, cap, p_total, run)
    with timer.phase("assemble"):
        (local_sorted,), offset = _per_host_egress(
            out_counts, [from_signed_keys(merged, _torch_dtype(key_dtype))]
        )
    return local_sorted, offset


def _sort_local_shards_hier(job, metrics, timer, mesh, xs, cj, cap, hosts, key_dtype):
    """The two-level exchange across processes, in place of the padded
    all-to-all.  The plan comes from the ``(P, P)`` histogram, gathered so
    every process holds the same matrix and computes the same caps
    (`hier_plan`); with ``hier_hosts`` auto the hosts are the processes,
    so the legs inside a process stay on the card and each (source,
    destination) process pair is one transfer.  No retry: every buffer is
    sized from the histogram, so an overflow is an invariant violation."""
    from dsort_tpu_torch.parallel.exchange import (
        _hier_exchange_shard,
        _ring_plan_shard,
        check_ring_overflow,
        hier_plan,
        note_hier_plan,
        ring_caps,
    )

    p_total = mesh.num_workers
    with timer.phase("spmd_sort"):
        xs_sorted, splitters, hist = _ring_plan_shard(
            xs, cj, mesh=mesh, oversample=job.oversample, kernel=job.local_kernel
        )
        hist_h = mesh.all_gather(hist).view(p_total, p_total).cpu().numpy()
    caps = ring_caps(hist_h, cap, p_total)  # the flat baseline dcn_bytes_saved prices
    plan = hier_plan(hist_h, cap, p_total, hosts)
    note_hier_plan(metrics, plan, caps, hist_h, cap, p_total, np.dtype(key_dtype).itemsize,
                   job.capacity_factor)
    with timer.phase("spmd_sort"):
        merged, out_counts, overflow = _hier_exchange_shard(
            xs_sorted, cj, splitters, mesh=mesh, hosts=plan.hosts, agg_cap=plan.agg_cap,
            leg_caps=plan.leg_caps, scatter_cap=plan.scatter_cap,
            merge_kernel=job.merge_kernel, kernel=job.local_kernel,
        )
        check_ring_overflow(_global_max([int(overflow.any())]))
    with timer.phase("assemble"):
        (local_sorted,), offset = _per_host_egress(
            out_counts, [from_signed_keys(merged, _torch_dtype(key_dtype))]
        )
    return local_sorted, offset


# -- checkpoint and resume, keys ------------------------------------------------


def _chunk_bounds(total: int) -> tuple[int, int]:
    """This process's ``[start, stop)`` interval of a ``total``-row output."""
    from dsort_tpu_torch.data.partition import equal_partition

    rank, world = _rank_world()
    sizes = equal_partition(total, world)
    start = int(np.sum(sizes[:rank], dtype=np.int64))
    return start, start + sizes[rank]


class _CatParts:
    """Random access over consecutive (memory-mapped) parts as one sorted
    array: the resume's bisections and slices read only the pages they
    touch, so no process materialises the whole output."""

    def __init__(self, parts):
        self.parts = parts
        self.offs = np.cumsum([0] + [len(p) for p in parts])

    def __len__(self) -> int:
        return int(self.offs[-1])

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                raise ValueError("_CatParts takes contiguous slices only")
            return _slice_parts(self.parts, lo, hi, len(self))
        k = int(np.searchsorted(self.offs, i, side="right")) - 1
        return self.parts[k][i - self.offs[k]]


def _merge_split(a, b, k: int) -> tuple[int, int]:
    """Split point of ``merge(a, b)`` at rank ``k``: ``(i, j)``, ``i + j =
    k``, with the first ``k`` merged elements ``a[:i] + b[:j]`` (ties to
    ``a``).  O(log) element reads; either side may be memory-mapped."""
    lo, hi = max(0, k - len(b)), min(k, len(a))
    while lo < hi:
        i = (lo + hi) // 2
        j = k - i
        if j > 0 and b[j - 1] > a[i]:  # a[i] must precede b[j-1]
            lo = i + 1
        else:
            hi = i
    return lo, k - lo


def _merge_slice(a, b, start: int, stop: int):
    """Rows ``[start, stop)`` of ``merge(a, b)`` without materialising it."""
    from dsort_tpu_torch.ops.merge import merge_sorted_host

    i0, j0 = _merge_split(a, b, start)
    i1, j1 = _merge_split(a, b, stop)
    return merge_sorted_host([a[i0:i1], b[j0:j1]])


def _slice_parts(parts, start: int, stop: int, total: int):
    """Rows ``[start, stop)`` of the consecutive ``parts`` (which hold the
    whole ``total``-row output): only the overlapping pieces are read, so a
    full restore costs one chunk of host memory per process."""
    if sum(len(p) for p in parts) != total:
        raise RuntimeError(
            f"checkpoint parts hold {sum(len(p) for p in parts)} of {total} rows; clear the "
            "checkpoint and re-run"
        )
    out = np.empty((stop - start,) + parts[0].shape[1:], parts[0].dtype)
    pos = 0
    for p in parts:
        lo, hi = max(start, pos), min(stop, pos + len(p))
        if hi > lo:
            out[lo - start : hi - start] = p[lo - pos : hi - pos]
        pos += len(p)
    return out


def _mh_stale_clear(ckpt, valid: bool, pid: int, job_id: str) -> bool:
    """Clear all persisted state that cannot be resumed: a manifest of
    another job, or orphaned ranges and shards with no manifest (a crash
    before the manifest landed).  The decision is all-gathered, so every
    process takes the same branch even if directory listings raced.
    Returns True when the state is (now) unusable."""
    have_state = bool(ckpt.completed_ranges() or ckpt.completed_shards())
    need = _allgather_u64([int((not valid) and have_state)]).max()
    if not need:
        return not valid
    if pid == 0:
        log.warning("multihost checkpoint for %r is stale or orphaned; clearing", job_id)
        ckpt.clear_ranges()
        ckpt.clear_shards()
        for tag in ("sec", "rk", "rv", "rs"):  # the kv side channels and resume scratch
            ckpt.clear_aux(tag)
    _mh_sync("dsort-mh-stale-clear")
    return True


def _die_before_range(pid: int) -> None:
    """The crash drill: the named rank dies here, its range not persisted."""
    if os.environ.get(DIE_BEFORE_RANGE_ENV) == str(pid):
        os._exit(17)


def _sort_local_shards_ckpt(local_data, job, metrics, job_id, mesh):
    """Recoverable sort: fingerprint manifest, then each process's range
    (the manifest lands first, behind a barrier, so no range is ever
    orphaned by a lost process 0)."""
    from dsort_tpu_torch.checkpoint import ShardCheckpoint

    pid, nprocs = _rank_world()
    fp, total = _global_fingerprint(local_data)
    ckpt = ShardCheckpoint(job.checkpoint_dir, job_id)
    ckpt.journal = metrics.journal
    man = ckpt.manifest()
    valid = (
        man is not None and man.get("kind") == "mh_keys" and man.get("fingerprint") == fp
        and man.get("total") == total and man.get("dtype") == str(local_data.dtype)
    )
    if _mh_stale_clear(ckpt, valid, pid, job_id):
        # Every process falls through to the fresh sort, also one whose
        # raced listing saw a valid store: the manifest is cleared.
        man, valid = None, False
    if valid:
        done = ckpt.completed_ranges()
        n_ranges = int(man["n_ranges"])
        if done and len(done) == n_ranges:
            parts = [ckpt.load_range_mmap(i) for i in sorted(done)]
            metrics.bump("multihost_ranges_restored", len(done))
            metrics.event("checkpoint_restore", kind="multihost_full", n=len(done))
            log.info("multihost job %r fully restored from %d ranges", job_id, len(done))
            start, stop = _chunk_bounds(total)
            return _slice_parts(parts, start, stop, total), start
        if done:
            return _mh_resume_missing(local_data, job, metrics, job_id, ckpt, man, done, fp,
                                      total, mesh)
    out, off = _sort_local_shards_plain(local_data, job, metrics, mesh)
    if pid == 0:
        ckpt.write_manifest(nprocs, local_data.dtype, total, fingerprint=fp, n_ranges=nprocs,
                            kind="mh_keys")
    # No range may land before the manifest: if process 0 dies first, this
    # barrier fails everywhere and no orphan range is left behind.
    _mh_sync("dsort-mh-manifest")
    _die_before_range(pid)
    ckpt.save_range(pid, out)
    return out, off


def _mh_resume_missing(local, job, metrics, job_id, ckpt, man, done, fp, total, mesh):
    """Restore the persisted ranges; re-sort only the missing key intervals.

    Keys strictly inside a persisted range's ``[min, max]`` are accounted
    for; of a boundary-equal key the global missing copy count (the
    all-gathered input counts less the persisted ones) is split in process
    order, so the union over processes is exactly the missing multiset
    whatever the current input-to-process partition.  The missing subset
    sorts over the current mesh, each process publishes its sorted slice
    through the shard namespace, merges its chunk of (persisted, re-sorted)
    by rank bisection, and the result re-persists under the current
    topology so the next run restores fully.
    """
    pid, nprocs = _rank_world()
    present = [ckpt.load_range_mmap(i) for i in sorted(done)]
    nonempty = [r for r in present if len(r)]
    in_present = np.zeros(len(local), bool)
    bset: set = set()
    for r in nonempty:
        lo, hi = r[0], r[-1]
        in_present |= (local > lo) & (local < hi)
        bset.update((lo.item(), hi.item()))
    bvals = np.asarray(sorted(bset), dtype=local.dtype)
    subset = local[~in_present & ~np.isin(local, bvals)]
    sl = np.sort(local)
    local_bc = (np.searchsorted(sl, bvals, side="right")
                - np.searchsorted(sl, bvals, side="left")).astype(np.int64)
    all_bc = _allgather_u64(local_bc).astype(np.int64)  # (nprocs, nb)
    present_bc = np.asarray(
        [sum(int(np.searchsorted(r, v, side="right") - np.searchsorted(r, v, side="left"))
             for r in nonempty) for v in bvals],
        np.int64,
    )
    missing_bc = all_bc.sum(axis=0) - present_bc
    prior = all_bc[:pid].sum(axis=0)
    take = np.clip(missing_bc - prior, 0, local_bc)
    subset = np.concatenate(
        [subset] + [np.full(int(t), v, local.dtype) for t, v in zip(take, bvals) if t > 0]
    )
    metrics.bump("multihost_ranges_restored", len(done))
    metrics.bump("multihost_resort_keys", len(subset))
    metrics.event("checkpoint_restore", kind="multihost_partial", n=len(done),
                  resort_keys=len(subset))
    log.warning("multihost resume of %r: %d/%d ranges restored; re-sorting %d local keys",
                job_id, len(done), int(man["n_ranges"]), len(subset))
    sub_out, _ = _sort_local_shards_plain(subset, job, metrics, mesh)
    ckpt.save(pid, sub_out)
    _mh_sync("dsort-mh-missing-saved")
    a = _CatParts(present)
    b = _CatParts([ckpt.load_mmap(i) for i in range(nprocs)])
    if len(a) + len(b) != total:
        raise RuntimeError(
            f"multihost resume reconstructed {len(a) + len(b)} of {total} keys; clear the "
            "checkpoint and re-run"
        )
    start, stop = _chunk_bounds(total)
    out = _merge_slice(a, b, start, stop)
    # Everyone has read the old ranges and the scratch before process 0
    # deletes either; the scratch goes too.
    _mh_sync("dsort-mh-merged")
    if pid == 0:
        ckpt.clear_ranges()
        ckpt.clear_shards()
        ckpt.write_manifest(nprocs, local.dtype, total, fingerprint=fp, n_ranges=nprocs,
                            kind="mh_keys")
    _mh_sync("dsort-mh-rewrite")
    ckpt.save_range(pid, out)
    return out, start


# -- records --------------------------------------------------------------------


def sort_local_records(
    keys, payload, secondary=None, job: JobConfig | None = None,
    metrics: Metrics | None = None, job_id: str | None = None,
    mesh: ProcessGroupMesh | None = None,
):
    """The record twin of `sort_local_shards` (call from every process):
    each process's ``(keys, payload[, secondary])`` in, ``(keys_slice,
    payload_slice, global_offset)`` out, ordered by ``(key, secondary)``.

    With ``job.checkpoint_dir`` and ``job_id`` each process persists its
    (keys range, payload block[, sorted secondary]) set behind the same
    fingerprint as `sort_local_shards`; a restart restores a complete
    store, and resumes a partial one at record granularity
    (`_mh_resume_missing_kv`).
    """
    keys = np.asarray(keys)
    payload = np.asarray(payload)
    if is_float_np_dtype(keys.dtype):
        return sort_float_keys_via_uint(sort_local_records, keys, payload, secondary, job,
                                        metrics, job_id, mesh)
    job = job or JobConfig()
    metrics = metrics if metrics is not None else Metrics()
    mesh = mesh if mesh is not None else global_worker_mesh()
    _attach_mh_observers(job, metrics, mesh)
    metrics.event("job_start", mode="multihost_kv", n_keys=len(keys), job_id=job_id,
                  process=mesh.rank, tenant=job.tenant)
    metrics.event("clock_sync", process=mesh.rank)
    if job.checkpoint_dir and job_id:
        out = _sort_local_records_ckpt(keys, payload, secondary, job, metrics, job_id, mesh)
    else:
        k, v, _, off = _sort_local_records_plain(keys, payload, secondary, job, metrics, mesh)
        out = (k, v, off)
    metrics.event("job_done", n_keys=len(out[0]), counters=dict(metrics.counters))
    return out


def _sort_local_records_plain(keys, payload, secondary, job, metrics, mesh):
    """The record sort itself.  Returns ``(local_k, local_v, local_s,
    offset)``; ``local_s`` is this process's slice of the sorted secondary
    keys (None without one), which the checkpoint persists so a partial
    resume merges in full ``(key, secondary)`` order."""
    from dsort_tpu_torch.data.partition import pad_kv_to_shards, pad_to_layout
    from dsort_tpu_torch.parallel.sample_sort import _kv_shard_body

    timer = PhaseTimer(metrics)
    p_total, lw = mesh.num_workers, mesh.local_workers
    with timer.phase("partition"):
        cap = _agree_cap(len(keys), lw)
        sk, sv, counts = pad_kv_to_shards(keys, payload, lw, cap=cap)
        xs = to_signed_keys(_upload(mesh, sk))
        vs = _upload(mesh, sv)
        cj = _upload(mesh, counts)
        sj = None
        if secondary is not None:
            sec = np.asarray(secondary)
            sj = to_signed_keys(_upload(mesh, pad_to_layout(sec, counts, cap)))

    def run(cap_pair):
        out_k, out_v, out_counts, overflow, max_len, out_s = _kv_shard_body(
            xs, vs, sj, cj, mesh=mesh, oversample=job.oversample, cap_pair=cap_pair,
            merge_kernel=job.merge_kernel, kernel=job.local_kernel,
        )
        return (out_k, out_v, out_s, out_counts), overflow, max_len

    out_k, out_v, out_s, out_counts = _retry_loop(job, metrics, timer, cap, p_total, run)
    with timer.phase("assemble"):
        rows = [from_signed_keys(out_k, _torch_dtype(keys.dtype)), out_v]
        if out_s is not None:
            rows.append(from_signed_keys(out_s, _torch_dtype(sec.dtype)))
        parts, offset = _per_host_egress(out_counts, rows)
    return parts[0], parts[1], (parts[2] if out_s is not None else None), offset


def _sort_local_records_ckpt(keys, payload, secondary, job, metrics, job_id, mesh):
    """Recoverable record sort: a complete store restores, a partial one
    resumes by records, otherwise a fresh sort persists."""
    from dsort_tpu_torch.checkpoint import ShardCheckpoint

    pid, _ = _rank_world()
    fp_payload = payload
    if secondary is not None:
        # The secondary is part of a record's identity: its bytes join the
        # fingerprint rows (widths from metadata, as in _global_fingerprint).
        n = len(keys)
        pay = np.ascontiguousarray(payload)
        sec = np.ascontiguousarray(secondary)
        pw = int(np.prod(pay.shape[1:], dtype=np.int64)) * pay.dtype.itemsize
        sw = int(np.prod(sec.shape[1:], dtype=np.int64)) * sec.dtype.itemsize
        fp_payload = np.concatenate(
            [pay.view(np.uint8).reshape(n, pw), sec.view(np.uint8).reshape(n, sw)], axis=1
        )
    fp, total = _global_fingerprint(keys, payload=fp_payload)
    ckpt = ShardCheckpoint(job.checkpoint_dir, job_id)
    ckpt.journal = metrics.journal
    man = ckpt.manifest()
    valid = (
        man is not None and man.get("kind") == "mh_kv" and man.get("fingerprint") == fp
        and man.get("total") == total and man.get("dtype") == str(keys.dtype)
    )
    if _mh_stale_clear(ckpt, valid, pid, job_id):
        man, valid = None, False
    if valid:
        n_ranges = int(man["n_ranges"])
        done = ckpt.completed_ranges()
        have_payloads = all(ckpt.has(i) for i in range(n_ranges))
        if done and len(done) == n_ranges and have_payloads:
            k_parts = [ckpt.load_range_mmap(i) for i in sorted(done)]
            v_parts = [ckpt.load_mmap(i) for i in range(n_ranges)]
            metrics.bump("multihost_ranges_restored", n_ranges)
            log.info("multihost kv job %r fully restored from %d host pairs", job_id, n_ranges)
            start, stop = _chunk_bounds(total)
            return (_slice_parts(k_parts, start, stop, total),
                    _slice_parts(v_parts, start, stop, total), start)
        if done or any(ckpt.has(i) for i in range(n_ranges)):
            return _mh_resume_missing_kv(keys, payload, secondary, job, metrics, job_id, ckpt,
                                         man, done, fp, total, mesh)
    return _mh_kv_sort_and_persist(keys, payload, secondary, job, metrics, ckpt, fp, total,
                                   mesh)


def _mh_kv_sort_and_persist(keys, payload, secondary, job, metrics, ckpt, fp, total, mesh):
    """Fresh record sort, then the crash-ordered persist: the manifest,
    then each process's range, payload block and sorted secondary."""
    pid, nprocs = _rank_world()
    out_k, out_v, out_s, off = _sort_local_records_plain(keys, payload, secondary, job,
                                                         metrics, mesh)
    if pid == 0:
        ckpt.write_manifest(nprocs, keys.dtype, total, fingerprint=fp, n_ranges=nprocs,
                            kind="mh_kv", has_sec=out_s is not None)
    _mh_sync("dsort-mh-kv-manifest")  # no set may land before the manifest
    _die_before_range(pid)
    ckpt.save_range(pid, out_k)
    ckpt.save(pid, out_v)
    if out_s is not None:
        ckpt.save_aux("sec", pid, out_s)
    return out_k, out_v, off


def _row_hashes(payload_rows, sec_rows=None) -> np.ndarray:
    """Per-record FNV-1a over the raw payload (and secondary) bytes: the
    hash family of `_global_fingerprint`, kept per row so record
    multisets can be differenced."""
    rows = np.ascontiguousarray(payload_rows)
    n = len(rows)
    if n == 0:
        return np.zeros(0, np.uint64)
    rb = rows.view(np.uint8).reshape(n, -1)
    if sec_rows is not None:
        sb = np.ascontiguousarray(sec_rows).view(np.uint8).reshape(n, -1)
        rb = np.concatenate([rb, sb], axis=1)
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64(1469598103934665603))
        prime = np.uint64(1099511628211)
        for b in range(rb.shape[1]):
            h = (h ^ rb[:, b].astype(np.uint64)) * prime
    return h


def _merge_split_kv(ak, asec, bk, bsec, k: int) -> tuple[int, int]:
    """`_merge_split` under the ``(key, secondary)`` order (the key alone
    when ``asec`` is None), ties to the ``a`` side."""
    def gt(xk, xs, yk, ys):  # (xk, xs) > (yk, ys), lexicographic
        if xk != yk:
            return bool(xk > yk)
        if xs is None:
            return False
        return bool(xs > ys)

    lo, hi = max(0, k - len(bk)), min(k, len(ak))
    while lo < hi:
        i = (lo + hi) // 2
        j = k - i
        if j > 0 and gt(bk[j - 1], bsec[j - 1] if bsec is not None else None,
                        ak[i], asec[i] if asec is not None else None):
            lo = i + 1
        else:
            hi = i
    return lo, k - lo


def _merge_slice_kv(a, b, start: int, stop: int):
    """Rows ``[start, stop)`` of the ``(key, secondary, a-side first)``
    merge of two sorted record sequences ``(keys, secondary|None,
    payload)``, without materialising the merge: the order agrees with the
    bisection's tie rule, so the processes' windows concatenate in order."""
    ak, asec, av = a
    bk, bsec, bv = b
    i0, j0 = _merge_split_kv(ak, asec, bk, bsec, start)
    i1, j1 = _merge_split_kv(ak, asec, bk, bsec, stop)
    wk = np.concatenate([ak[i0:i1], bk[j0:j1]])
    wv = np.concatenate([av[i0:i1], bv[j0:j1]])
    side = np.concatenate([np.zeros(i1 - i0, np.int8), np.ones(j1 - j0, np.int8)])
    if asec is not None:
        ws = np.concatenate([asec[i0:i1], bsec[j0:j1]])
        order = np.lexsort((side, ws, wk))
        return wk[order], wv[order], ws[order]
    order = np.lexsort((side, wk))
    return wk[order], wv[order], None


def _mh_resume_missing_kv(keys, payload, secondary, job, metrics, job_id, ckpt, man, done,
                          fp, total, mesh):
    """Record-level resume of a partial store (the kv twin of
    `_mh_resume_missing`).

    A persisted set is usable when its keys range, payload block and (with
    a secondary) sorted secondary all survived.  Records whose key lies
    strictly inside a usable range are accounted for; of boundary keys the
    missing copies are the record multiset difference, per (boundary key,
    payload-row hash) the all-gathered input counts less the persisted
    counts, split in process order.  The missing records re-sort over the
    current mesh; each process takes its chunk of the ``(key, secondary)``
    merge of persisted and re-sorted records by rank bisection, and the
    result re-persists under the current topology.
    """
    pid, nprocs = _rank_world()
    has_sec = secondary is not None
    sec = np.asarray(secondary) if has_sec else None
    usable = [i for i in sorted(done) if ckpt.has(i) and (not has_sec or ckpt.has_aux("sec", i))]
    present_k = [ckpt.load_range_mmap(i) for i in usable]
    present_v = [ckpt.load_mmap(i) for i in usable]
    present_s = [ckpt.load_aux_mmap("sec", i) for i in usable] if has_sec else None
    nonempty = [ix for ix, r in enumerate(present_k) if len(r)]
    in_present = np.zeros(len(keys), bool)
    bset: set = set()
    for ix in nonempty:
        r = present_k[ix]
        lo, hi = r[0], r[-1]
        in_present |= (keys > lo) & (keys < hi)
        bset.update((lo.item(), hi.item()))
    bvals = np.asarray(sorted(bset), dtype=keys.dtype)
    base_idx = np.nonzero(~in_present & ~np.isin(keys, bvals))[0]
    # Boundary records: the (key, row hash) multiset difference.
    tables = []  # per boundary value: (local indices, their hashes, uniques, counts)
    for v in bvals:
        li = np.nonzero(keys == v)[0]
        lh = _row_hashes(payload[li], sec[li] if has_sec else None)
        uh, uc = np.unique(lh, return_counts=True)
        tables.append((li, lh, uh, uc))
    take_idx: list = []
    nb = len(bvals)
    if nb:
        lens = _allgather_u64([len(t[2]) for t in tables]).astype(np.int64)
        max_l = int(lens.max())
        if max_l:
            flat = np.zeros((nb, 2, max_l), np.uint64)
            for bi, (_, _, uh, uc) in enumerate(tables):
                flat[bi, 0, : len(uh)] = uh
                flat[bi, 1, : len(uh)] = uc.astype(np.uint64)
            g = _allgather_u64(flat.reshape(-1)).reshape(nprocs, nb, 2, max_l)
            for bi, (li, lh, _, _) in enumerate(tables):
                v = bvals[bi]
                pc: dict = {}  # persisted copies of v, by the same identity
                for ix in nonempty:
                    rk = present_k[ix]
                    a = int(np.searchsorted(rk, v, side="left"))
                    b = int(np.searchsorted(rk, v, side="right"))
                    if b > a:
                        ph = _row_hashes(present_v[ix][a:b],
                                         present_s[ix][a:b] if has_sec else None)
                        for h, c in zip(*np.unique(ph, return_counts=True)):
                            pc[int(h)] = pc.get(int(h), 0) + int(c)
                vocab = sorted({int(h) for proc in range(nprocs)
                                for h in g[proc, bi, 0, : int(lens[proc, bi])]})
                for h in vocab:
                    counts = np.asarray(
                        [int(g[proc, bi, 1][g[proc, bi, 0, : int(lens[proc, bi])]
                                            == np.uint64(h)].sum()) for proc in range(nprocs)],
                        np.int64,
                    )
                    missing = int(counts.sum()) - pc.get(h, 0)
                    if missing <= 0:
                        continue
                    prior = int(counts[:pid].sum())
                    take = int(np.clip(missing - prior, 0, int(counts[pid])))
                    if take > 0:
                        take_idx.extend(li[lh == np.uint64(h)][:take].tolist())
    sub_idx = np.concatenate([base_idx, np.asarray(sorted(take_idx), np.int64)]).astype(np.int64)
    sub_k, sub_v = keys[sub_idx], payload[sub_idx]
    sub_s = sec[sub_idx] if has_sec else None
    metrics.bump("multihost_ranges_restored", len(usable))
    metrics.bump("multihost_resort_keys", len(sub_idx))
    metrics.event("checkpoint_restore", kind="multihost_kv_partial", n=len(usable),
                  resort_keys=len(sub_idx))
    log.warning("multihost kv resume of %r: %d/%d host sets restored; re-sorting %d local "
                "records", job_id, len(usable), int(man["n_ranges"]), len(sub_idx))
    out_k, out_v, out_s, _ = _sort_local_records_plain(sub_k, sub_v, sub_s, job, metrics, mesh)
    # Each process's re-sorted slice goes out through scratch channels
    # (apart from the persisted sets) so every process can bisect it all.
    ckpt.save_aux("rk", pid, out_k)
    ckpt.save_aux("rv", pid, out_v)
    if has_sec:
        ckpt.save_aux("rs", pid, out_s)
    _mh_sync("dsort-mh-kv-missing-saved")
    a = (_CatParts(present_k), _CatParts(present_s) if has_sec else None, _CatParts(present_v))
    b_k = _CatParts([ckpt.load_aux_mmap("rk", i) for i in range(nprocs)])
    b_v = _CatParts([ckpt.load_aux_mmap("rv", i) for i in range(nprocs)])
    b_s = _CatParts([ckpt.load_aux_mmap("rs", i) for i in range(nprocs)]) if has_sec else None
    if len(a[0]) + len(b_k) != total:
        raise RuntimeError(
            f"multihost kv resume reconstructed {len(a[0]) + len(b_k)} of {total} records; "
            "clear the checkpoint and re-run"
        )
    start, stop = _chunk_bounds(total)
    if len(a[0]):
        out_k, out_v, out_s = _merge_slice_kv(a, (b_k, b_s, b_v), start, stop)
    else:  # nothing usable survived: the reconstruction is the output
        out_k, out_v = b_k[start:stop], b_v[start:stop]
        out_s = b_s[start:stop] if has_sec else None
    _mh_sync("dsort-mh-kv-merged")
    if pid == 0:
        ckpt.clear_ranges()
        ckpt.clear_shards()
        for tag in ("sec", "rk", "rv", "rs"):
            ckpt.clear_aux(tag)
        ckpt.write_manifest(nprocs, keys.dtype, total, fingerprint=fp, n_ranges=nprocs,
                            kind="mh_kv", has_sec=has_sec)
    _mh_sync("dsort-mh-kv-rewrite")
    ckpt.save_range(pid, out_k)
    ckpt.save(pid, out_v)
    if has_sec:
        ckpt.save_aux("sec", pid, out_s)
    return out_k, out_v, start
