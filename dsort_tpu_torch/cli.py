"""Command line: ``python -m dsort_tpu_torch.cli {run,serve,batch,terasort,external,validate,gen} ...``.

Counterparts of ``dsort run`` and of the in-core ``dsort terasort``, over
``--workers`` virtual workers on the GPU unless ``--device cpu``:

- ``run INPUT -o OUTPUT [--mode M] [--exchange E] [--dtype D] [--journal
  J]``: one key per line in and out, read and written as ``D`` (default
  int32; signed and unsigned ints, and floats through the
  order-preserving key mapping), as ``dsort run --dtype`` reads it.
  ``--mode`` routes the job as ``dsort run --mode`` does (`_make_sorter`):

  * ``spmd`` (default): a job under `models.pipelines.FUSED_SMALL_JOB_MAX`
    keys, unless coded (``--redundancy`` above 1: a coded job always
    reaches the exchange), runs as one fused device program
    (`fused_sort_small`) under the scheduler's bounded wait (``run_bounded(tag="fused")``); a device
    error or a lapsed wait falls back to `SpmdScheduler.sort`, and three
    latches close the fused route after a wedge (below).  Larger jobs go
    through `SpmdScheduler` (failure detection, bounded waits, probes,
    re-form over the survivors);
  * ``taskpool``: `scheduler.Scheduler` over a `DeviceExecutor` (one
    worker per shard, reassignment, host merge);
  * ``local``: `fused_sort_small` at any size.

  ``--journal J`` writes the job's `EventLog` as JSONL once the job ends,
  also when it failed, in every mode.  ``--device-resident`` (``--mode
  spmd`` only) sorts through `SpmdScheduler` at every size with
  ``keep_on_device=True``, validates the handle on the device (order, and
  its checksum against the input's host `_multiset`), then copies it to
  the host for the output file; exit 1 when either check fails.
  ``--checkpoint-dir DIR [--job-id ID]`` makes the job resumable
  (`JobConfig.checkpoint_dir`; the id defaults to the input's sanitised
  basename, `_job_id_for`): a checkpointed ``spmd`` job skips the fused
  route and goes through `SpmdScheduler`, whose re-run restores what is on
  disk; ``taskpool`` persists its shards; ``--mode local`` and
  ``--device-resident`` warn and ignore the flags, as the reference does;
- ``serve [-o OUT] [--mode M] [--max-in-flight N] [--metrics-port P]
  [--prewarm [auto|all]] [--slice-devices S] [--queue-limit Q]
  [--tenant-limit T] [--weights acme=2,...] [--slo-shed-ms MS]
  [--journal J]``: the reference's job loop (``server.c:160-167``) on the
  serving core (`serve.SortService`): each stdin line ``[tenant=NAME]
  PATH`` is submitted through admission control and its sorted keys
  written to ``OUT`` (``exit`` or end of input ends the loop); with
  ``--max-in-flight 1`` (the default) each job is awaited, as the
  reference's blocking loop, with more the jobs run concurrently (small
  jobs on slices of the mesh, each on its own CUDA stream, big jobs on the
  whole mesh).  ``--mode taskpool|local`` wraps that mode's sorter as the
  service's runner.  SIGINT and SIGTERM drain the queued and in-flight
  jobs, reject new ones (verdict ``shutting_down``), flush the journal
  (``serve_drain``, ``serve_stop``) and exit 0.  ``--metrics-port``
  serves the live telemetry on localhost (``/metrics``, ``/json``);
- ``batch INPUT... --outdir DIR [--dp N] [--dtype D] [--checkpoint-dir C]
  [--journal J]``: many one-int-per-line files as one `BatchSampleSort.sort`
  call (size buckets, each one program over its jobs), each written to
  ``DIR/<basename>``, as ``dsort batch`` does; ``--checkpoint-dir`` persists
  each finished file under its sanitised basename (`_job_id_for`), so a
  re-run restores them and sorts the rest;
- ``terasort INPUT -o OUTPUT``: 100-byte TeraSort records
  through `SampleSort.sort_kv` (the reference's ``cmd_terasort`` does not
  use the scheduler either), ordered by the full 10-byte key (8-byte
  prefix, then key bytes 8-9 as the secondary key — which keeps the
  ``alltoall`` exchange and runs uncoded, both warned); its keys are
  always the uint64 prefix, so it takes no ``--dtype``, as in the
  reference.  ``--external`` sorts out-of-core: `ExternalTeraSort`
  (``--run-recs`` records a spilled run), or with ``--mesh N``
  `ExternalWaveTeraSort` over a ``VirtualMesh(N)`` (``--run-recs`` records
  a wave); ``--spill-dir``, ``--job-id`` and ``--no-resume`` name and reset
  the run store, ``--journal`` writes the job's events;
- ``external INPUT -o OUTPUT [--dtype D] [--mesh N]``: out-of-core sort of
  a raw binary key file: `ExternalSort` (``--run-elems`` keys a run,
  ``--kernel``), or with ``--mesh N`` the wave pipeline `ExternalWaveSort`
  over a ``VirtualMesh(N)`` (``--wave-elems``, ``--no-overlap``,
  ``--exchange ring|fused|hier``, ``--hier-hosts``, ``--redundancy``,
  ``--redundancy-mode``; the last two and ``--exchange`` warn without
  ``--mesh``, as the reference's do); resumable at run or (wave, run)
  granularity under ``--spill-dir`` / ``--job-id``.

The sorting subcommands take ``--kernel`` (`JobConfig.local_kernel`,
``radix`` included), ``--merge-kernel``, ``--exchange`` (``hier``
included), ``--hier-hosts``, ``--redundancy`` and ``--redundancy-mode``
(`JobConfig`'s fields of those names), as the JAX package's common flags
do.  ``run``, ``serve`` and ``batch`` load their config as the
reference's ``common()`` does (`_load_config`): ``--conf FILE`` (the
reference's ``KEY=value`` keys, `config.SortConfig.from_mapping`), then
the flags, then the planner — ``--no-autotune`` wins, then a conf
``AUTOTUNE=``, else autotune is on (`obs.plan`: the exchange planned per
dispatch, journaled ``plan_decision``); a knob flag actually given joins
``JobConfig.explicit``, so the planner journals ``plan_override`` and
yields.  They also take ``--tenant`` and ``--flight-dir``.  Two
host tools run no sort and touch no device, as ``dsort``'s do:

- ``validate INPUT [--against FILE] [--terasort|--binary] [--dtype D]``:
  order plus the permutation checksum (`models.validate`); prints one JSON
  line and exits 0 only when both hold;
- ``gen N -o FILE [--dist uniform|zipf|terasort] [--dtype D] [--zipf-a A]
  [--seed S] [--format text|bin]``: the reference's seeded inputs, byte for
  byte.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time

from dsort_tpu_torch.config import (
    _EXCHANGES,
    _LOCAL_KERNELS,
    _MERGE_KERNELS,
    _REDUNDANCY_MODES,
    ExternalConfig,
    JobConfig,
    SortConfig,
)
from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("cli")

# The fused route's latches, with the reference's settings (``dsort_tpu/
# cli.py``), so both CLIs decide alike.  All fused attempts serialize on one
# lane thread, so "one entry executing for longer than any first build"
# is evidence that the card is wedged, while any number of cold lapses
# queued behind a still-building entry is not.  On the H100 a cold first
# job's cost is the kernels' build (nvcc): 6.09-8.71 s in PERF.md's runs,
# far below the ceiling.
FUSED_COLD_WEDGE_CEILING_S = 900.0
# The cold latch is evidence, not proof, so it expires: after this long the
# route is tried again; a card still wedged lapses again and re-latches.
FUSED_COLD_RETRY_S = 1800.0
# Fail-slow backstop: this many consecutive cold lapses without a fused
# success latch the route off too (each call errors after the wait budget
# but before the ceiling, so the lane keeps draining and the ceiling never
# trips).
FUSED_COLD_LAPSE_BACKSTOP = 8

MODES = ("spmd", "taskpool", "local")


def _common(p: argparse.ArgumentParser, default_output: str) -> None:
    p.add_argument("input")
    p.add_argument("-o", "--output", default=default_output)
    _knobs(p)


def _knobs(p: argparse.ArgumentParser) -> None:
    """The mesh, exchange and kernel flags every sorting subcommand takes."""
    p.add_argument("--workers", type=int, default=None,
                   help="virtual mesh shards (default 8; conf NUM_WORKERS)")
    p.add_argument("--exchange", choices=_EXCHANGES, default=None,
                   help="bucket exchange schedule (default: JobConfig's); hier = the "
                        "two-level schedule: intra-host aggregation, one transfer per "
                        "host pair, a local scatter")
    p.add_argument("--hier-hosts", type=int, default=None,
                   help="host count the hier schedule groups the workers into (default "
                        "0 = auto: the torch.distributed world size, else 2 simulated)")
    p.add_argument("--redundancy", type=int, default=None,
                   help="coded redundancy r (default 1 = off): the ring exchange also "
                        "ships every bucket's redundancy to its destination's ring "
                        "successors, so losses within the budget recover by a local "
                        "merge, zero keys re-sorted (forces the ring schedule)")
    p.add_argument("--redundancy-mode", choices=_REDUNDANCY_MODES, default=None,
                   help="how r > 1 ships its premium: replicate (r-1 full bucket "
                        "copies) or parity (XOR at r=2, GF(256) P+Q at r>=3)")
    p.add_argument("--kernel", choices=_LOCAL_KERNELS, default=None,
                   help="local sort kernel (default auto)")
    p.add_argument("--merge-kernel", choices=_MERGE_KERNELS, default=None,
                   help="post-exchange combine (default auto: block_merge wherever "
                        "the block kernel applies)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def _config_flags(p: argparse.ArgumentParser) -> None:
    """The config flags of the reference's ``common()`` (`_load_config`)."""
    p.add_argument("--conf", help="KEY=value conf file (the reference's keys accepted)")
    p.add_argument("--tenant", help="tenant label on the job's events and SLO histograms "
                                    "(default 'default')")
    p.add_argument("--flight-dir",
                   help="flight recorder directory: any recovery path dumps a postmortem "
                        "bundle here (ring + config + worker state + counters)")
    p.add_argument("--no-autotune", action="store_true",
                   help="disable the planner: every knob rides its flag/conf/default value "
                        "(conf AUTOTUNE=0; the planner is otherwise on, and explicit flags "
                        "win over it either way)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsort_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="sort a one-int-per-line text file")
    _common(run, "output.txt")
    _config_flags(run)
    run.add_argument("--dtype", default=None,
                     help="key dtype of the file (int32, int64, uint32, uint64, float32, ...; "
                          "default int32, conf KEY_DTYPE)")
    run.add_argument("--mode", choices=MODES, default="spmd",
                     help="spmd (fused route under 2^20 keys, else the SPMD "
                          "scheduler), taskpool or local")
    run.add_argument("--journal", default=None,
                     help="write the job's structured event journal (JSONL) here")
    run.add_argument("--device-resident", action="store_true",
                     help="keep the sorted keys on the device and validate them there "
                          "(order + multiset checksum); the output file write is the "
                          "only device-to-host copy of keys")
    run.add_argument("--checkpoint-dir",
                     help="persist per-shard/range progress here; a re-run of the same "
                          "input resumes instead of re-sorting")
    run.add_argument("--job-id", help="checkpoint namespace (default: input basename)")
    serve = sub.add_parser("serve", help="the job loop: file names on stdin, served by the "
                                         "multi-tenant core")
    serve.add_argument("-o", "--output", default=None,
                       help="where each job's sorted keys go (default output.txt, conf "
                            "OUTPUT_PATH)")
    _knobs(serve)
    _config_flags(serve)
    serve.add_argument("--dtype", default=None, help="key dtype of the files (default int32)")
    serve.add_argument("--mode", choices=MODES, default="spmd",
                       help="spmd (slices + the whole mesh), or a taskpool / local runner")
    serve.add_argument("--journal", default=None,
                       help="write the session's structured event journal (JSONL) here, "
                            "flushed after every job")
    serve.add_argument("--checkpoint-dir",
                       help="persist each job's progress under its file's basename; a "
                            "checkpointed job takes the whole mesh")
    serve.add_argument("--job-id", help="ignored by serve: each file checkpoints under its "
                                        "own name")
    serve.add_argument("--metrics-port", type=int,
                       help="serve the live telemetry on this localhost port (0 = "
                            "ephemeral; Prometheus text at /metrics, JSON at /json)")
    serve.add_argument("--max-in-flight", type=int, default=1,
                       help="jobs in flight at once (default 1 = await each job, the "
                            "reference's blocking loop; more = concurrent slices)")
    serve.add_argument("--prewarm", nargs="?", const="auto", choices=("auto", "all"),
                       help="run the fused rungs once on every slice at startup: 'auto' "
                            "the planner's predicted set (the full ladder on a cold "
                            "start), 'all' the exhaustive ladder (conf SERVE_PREWARM)")
    serve.add_argument("--slice-devices", type=int,
                       help="virtual workers per small-job slice (default 1: 8 slices, "
                            "8 streams)")
    serve.add_argument("--queue-limit", type=int,
                       help="admission control: most jobs queued service-wide")
    serve.add_argument("--tenant-limit", type=int,
                       help="admission control: most queued + running jobs a tenant")
    serve.add_argument("--weights", help="fair-scheduler tenant weights, e.g. acme=2,blue=1 "
                                         "(unlisted tenants weigh 1)")
    serve.add_argument("--slo-shed-ms", type=float,
                       help="reject (verdict 'slo_shed') while a tenant's live p95 queue "
                            "wait is over this many ms with work still queued")
    batch = sub.add_parser("batch", help="sort many one-int-per-line files as one batched "
                                          "program (the dp axis)")
    batch.add_argument("inputs", nargs="+")
    batch.add_argument("--outdir", required=True, help="each input is written to "
                                                       "OUTDIR/<its basename>")
    batch.add_argument("--dp", type=int, default=None,
                       help="job slots a size bucket is padded to (the reference's dp axis; "
                            "default 1, conf DP)")
    _knobs(batch)
    _config_flags(batch)
    batch.add_argument("--dtype", default=None, help="key dtype of the files (default int32)")
    batch.add_argument("--journal", default=None,
                       help="write the batch's structured event journal (JSONL) here")
    batch.add_argument("--checkpoint-dir",
                       help="persist each finished file's result here; a re-run restores "
                            "them and sorts only the rest")
    tera = sub.add_parser("terasort", help="sort a binary 100-byte-record file")
    _common(tera, "terasort_out.bin")
    tera.add_argument("--external", action="store_true",
                      help="out-of-core: spill sorted record runs, then merge them")
    tera.add_argument("--mesh", type=int,
                      help="external mode: run record waves over this many virtual "
                           "workers (the wave pipeline)")
    tera.add_argument("--run-recs", type=int, default=1 << 20,
                      help="records per spilled run / per wave (external mode)")
    _store_flags(tera, "tera_external")
    ext = sub.add_parser("external", help="out-of-core sort of a raw binary key file")
    ext.add_argument("input")
    ext.add_argument("-o", "--output", required=True)
    ext.add_argument("--dtype", default="int32")
    ext.add_argument("--kernel", choices=_LOCAL_KERNELS, help="local sort kernel")
    ext.add_argument("--run-elems", type=int, default=None,
                     help="keys per spilled run, single-device mode (default %d)"
                          % ExternalConfig.run_elems)
    ext.add_argument("--mesh", type=int,
                     help="sort in waves over this many virtual workers (the wave "
                          "pipeline)")
    ext.add_argument("--wave-elems", type=int, default=None,
                     help="keys per wave, the per-wave device budget (default %d)"
                          % ExternalConfig.wave_elems)
    ext.add_argument("--no-overlap", action="store_true",
                     help="disable the wave pipeline's spill/exchange overlap (the A/B "
                          "baseline)")
    ext.add_argument("--exchange", choices=["ring", "fused", "hier"],
                     help="per-wave exchange schedule (wave mode; default ring; fused = "
                          "one exchange kernel launch a wave; hier = the two-level "
                          "schedule)")
    ext.add_argument("--hier-hosts", type=int,
                     help="host grouping for --exchange hier (default 0 = auto)")
    ext.add_argument("--redundancy", type=int,
                     help="coded redundancy r for each wave's exchange (default 1 = "
                          "off): a worker lost mid-wave repairs from the plane instead "
                          "of a host re-sort")
    ext.add_argument("--redundancy-mode", choices=_REDUNDANCY_MODES,
                     help="plane mode of coded waves: full copies or parity slots")
    ext.add_argument("--device", default=None, help="cuda (default) or cpu")
    _store_flags(ext, "external")
    gen = sub.add_parser("gen", help="generate synthetic input files")
    gen.add_argument("n", type=int)
    gen.add_argument("-o", "--output", required=True)
    gen.add_argument("--dist", default="uniform", choices=["uniform", "zipf", "terasort"])
    gen.add_argument("--dtype", default="int32")
    gen.add_argument("--zipf-a", type=float, default=1.3)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--format", default="text", choices=["text", "bin"],
                     help="'bin' streams raw binary keys")
    val = sub.add_parser("validate",
                         help="validate a sort output (order + permutation checksum)")
    val.add_argument("input")
    val.add_argument("--against", help="original input file to prove the permutation")
    val.add_argument("--terasort", action="store_true",
                     help="treat files as binary 100-byte-record TeraSort data")
    val.add_argument("--binary", action="store_true",
                     help="treat files as raw binary key arrays (streamed)")
    val.add_argument("--dtype", default="int32")
    return ap


def _store_flags(p: argparse.ArgumentParser, job_id: str) -> None:
    """The run store and journal flags of the out-of-core subcommands."""
    p.add_argument("--spill-dir", help="where spilled runs live (default: a temp dir)")
    p.add_argument("--job-id", default=job_id)
    p.add_argument("--no-resume", action="store_true",
                   help="discard checkpointed runs and start fresh")
    p.add_argument("--journal", default=None,
                   help="write the job's structured event journal (JSONL) here")


def _job_id_for(path: str, explicit: str | None) -> str:
    """Stable checkpoint job id for a CLI input file: the sanitised basename
    by default, so a re-run of ``run FILE`` resumes FILE's own checkpoints
    (the schedulers' fingerprint guard clears them if FILE changed).  An
    explicit id is validated, never rewritten: an id like ``..`` would
    escape the checkpoint root."""
    if explicit:
        if re.fullmatch(r"[A-Za-z0-9._-]+", explicit) and explicit.strip("."):
            return explicit
        raise SystemExit(
            f"invalid --job-id {explicit!r}: use letters, digits, '.', '_', '-' (and "
            "not only dots)"
        )
    jid = re.sub(r"[^A-Za-z0-9._-]", "_", os.path.basename(str(path)))
    return jid if jid.strip(".") else "job"


def _load_config(args) -> SortConfig:
    """The conf file, then the flags, then the planner, field by field.

    Flags override with ``dataclasses.replace`` on the loaded config, so a
    flag never drops conf settings it does not know about.  Autotune:
    ``--no-autotune`` wins, then an explicit conf ``AUTOTUNE=``, else on
    (the library's `JobConfig` default stays off).  A knob flag actually
    given (``--exchange``, ``--redundancy``, ``--redundancy-mode``,
    ``--slice-devices``, ``--prewarm all``) joins ``JobConfig.explicit``,
    so the planner journals a ``plan_override`` instead of deciding.
    """
    import dataclasses

    from dsort_tpu_torch.config import load_conf_file

    conf_map = load_conf_file(args.conf) if getattr(args, "conf", None) else {}
    cfg = SortConfig.from_mapping(conf_map) if conf_map else SortConfig()
    job_over: dict = {}
    mesh_over: dict = {}
    if getattr(args, "workers", None):
        mesh_over["num_workers"] = args.workers
    for flag, field in (("dtype", "key_dtype"), ("kernel", "local_kernel"),
                        ("merge_kernel", "merge_kernel"), ("exchange", "exchange"),
                        ("hier_hosts", "hier_hosts"), ("redundancy", "redundancy"),
                        ("redundancy_mode", "redundancy_mode"),
                        ("checkpoint_dir", "checkpoint_dir"), ("tenant", "tenant"),
                        ("flight_dir", "flight_recorder_dir")):
        if getattr(args, flag, None):
            job_over[field] = getattr(args, flag)
    if getattr(args, "no_autotune", False):
        job_over["autotune"] = False
    elif "AUTOTUNE" not in conf_map:
        job_over["autotune"] = True
    explicit = set(cfg.job.explicit)
    for flag in ("exchange", "redundancy", "redundancy_mode", "slice_devices"):
        if getattr(args, flag, None):
            explicit.add(flag)
    if getattr(args, "prewarm", None) == "all":
        explicit.add("prewarm")
    if explicit != set(cfg.job.explicit):
        job_over["explicit"] = tuple(sorted(explicit))
    if job_over:
        cfg = dataclasses.replace(cfg, job=dataclasses.replace(cfg.job, **job_over))
    if mesh_over:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, **mesh_over))
    return cfg


def _make_sorter(job: JobConfig, mode: str, workers: int = 8, device=None):
    """The sort callable ``sorter(data, metrics, job_id=None)`` of one mode;
    builds its scheduler (and so resolves the device) at once."""
    if mode == "spmd":
        from dsort_tpu_torch.models.pipelines import FUSED_SMALL_JOB_MAX, fused_sort_small
        from dsort_tpu_torch.scheduler import SpmdScheduler
        from dsort_tpu_torch.scheduler.fault import ProgramWaitTimeout, classify_runtime_error

        sched = SpmdScheduler(workers, device, job)
        # Warm-wedge latch: once a fused attempt on a warm bucket lapses, its
        # lane thread is stuck for the process lifetime; skip the route from
        # then on instead of paying a full wait budget a job.
        fused_wedged = threading.Event()
        # Cold latch: a card wedged on first contact never warms the bucket,
        # so every lapse stays cold; the lane-stuck discriminator and the
        # backstop close the route until FUSED_COLD_RETRY_S has passed.
        fused_cold_latch_ts = [0.0]  # 0 = cold latch inactive
        fused_cold_streak = [0]  # consecutive cold lapses since a success

        def fused_path_open() -> bool:
            if fused_wedged.is_set():
                return False
            ts = fused_cold_latch_ts[0]
            return not ts or time.monotonic() - ts > FUSED_COLD_RETRY_S

        def sorter(data, metrics, job_id=None):
            # A checkpointed job (checkpoint_dir and a job_id) goes through
            # the scheduler at any size: resumability wins over dispatch
            # count.  A coded job (redundancy > 1) must reach the exchange
            # plane: the fused route has no replica plane, and dropping an
            # asked-for availability posture would be worse than the extra
            # dispatches.
            if (
                len(data) < FUSED_SMALL_JOB_MAX
                and not (job.checkpoint_dir and job_id)
                and job.redundancy <= 1
                and fused_path_open()
            ):
                try:
                    metrics.event(
                        "job_start", mode="fused", n_keys=len(data), job_id=job_id,
                        tenant=job.tenant,
                    )
                    # The bounded wait covers the fused program's completion
                    # barrier (the download inside fused_sort_small): a
                    # wedged card lapses and falls back, never blocks.
                    out = sched.run_bounded(
                        lambda: fused_sort_small(data, job.local_kernel, metrics,
                                                 device=sched.device),
                        n_keys=len(data), tag="fused",
                    )
                    metrics.bump("fused_small_jobs")
                    metrics.event(
                        "job_done", n_keys=len(data), counters=dict(metrics.counters),
                    )
                    fused_cold_latch_ts[0] = 0.0
                    fused_cold_streak[0] = 0
                    return out
                except Exception as e:
                    lapsed = isinstance(e, ProgramWaitTimeout)
                    if not lapsed and classify_runtime_error(e) is None:
                        raise  # a program error, not a device loss or a hang
                    if lapsed and not getattr(e, "cold", False):
                        fused_wedged.set()
                    elif lapsed:
                        # The streak resets only on a fused success, so a
                        # fail-slow card re-latches on the one retry after
                        # the latch expires.
                        stuck = sched.lane_stuck_for("fused")
                        fused_cold_streak[0] += 1
                        if stuck > FUSED_COLD_WEDGE_CEILING_S:
                            log.warning(
                                "fused route latched off for %.0f s: its lane has been "
                                "inside one entry for %.0f s (past the %.0f s ceiling: "
                                "the card is wedged, not building)",
                                FUSED_COLD_RETRY_S, stuck, FUSED_COLD_WEDGE_CEILING_S,
                            )
                            fused_cold_latch_ts[0] = time.monotonic()
                        elif fused_cold_streak[0] >= FUSED_COLD_LAPSE_BACKSTOP:
                            log.warning(
                                "fused route latched off for %.0f s: %d consecutive cold "
                                "wait lapses without a fused success (fail-slow backstop)",
                                FUSED_COLD_RETRY_S, fused_cold_streak[0],
                            )
                            fused_cold_latch_ts[0] = time.monotonic()
                    reason = str(e).splitlines()[0][:120]
                    metrics.bump("fused_fallbacks")
                    metrics.event("fused_fallback", reason=reason)
                    log.warning(
                        "fused small-job route failed (%s); retrying on the SPMD scheduler",
                        reason,
                    )
            return sched.sort(data, metrics=metrics, job_id=job_id)

        return sorter
    if mode == "taskpool":
        from dsort_tpu_torch.scheduler import DeviceExecutor, Scheduler

        pool = Scheduler(DeviceExecutor(workers, device), job)
        return lambda data, metrics, job_id=None: pool.run_job(
            data, metrics=metrics, job_id=job_id
        )
    if mode == "local":
        from dsort_tpu_torch.device import resolve_device
        from dsort_tpu_torch.models.pipelines import fused_sort_small

        dev = resolve_device(device)
        if job.checkpoint_dir:
            log.warning(
                "--mode local runs one fused device program and does not checkpoint; "
                "--checkpoint-dir/--job-id are ignored (use spmd or taskpool mode for "
                "resumable jobs)"
            )

        def local_sorter(data, metrics, job_id=None):
            # No scheduler journals this mode's job boundaries: do it here.
            metrics.event(
                "job_start", mode="local", n_keys=len(data), job_id=job_id, tenant=job.tenant,
            )
            out = fused_sort_small(data, job.local_kernel, metrics, device=dev)
            metrics.event("job_done", n_keys=len(data), counters=dict(metrics.counters))
            return out

        return local_sorter
    raise SystemExit(f"unknown mode {mode!r}")


def _make_device_sorter(job: JobConfig, workers: int = 8, device=None):
    """``run --device-resident``'s sorter ``(data, metrics) -> (out, ok)``:
    `SpmdScheduler` at every size (not the fused route), the handle
    validated on the device, the input's checksum on the host, then the
    handle's one copy of keys to the host (which journals
    ``result_fetch``)."""
    from dsort_tpu_torch.models.validate import _multiset
    from dsort_tpu_torch.scheduler import SpmdScheduler

    sched = SpmdScheduler(workers, device, job)

    def sorter(data, metrics):
        handle = sched.sort(data, metrics=metrics, keep_on_device=True)
        rep = handle.validate_on_device()
        in_sum = _multiset(data, len(data), data.dtype.itemsize)
        perm_ok = rep.records == len(data) and rep.checksum == in_sum
        log.info(
            "device-resident: %d keys, on-device validate: sorted=%s permutation=%s "
            "checksum=%016x", len(data), rep.sorted_ok, perm_ok, rep.checksum,
        )
        return handle.to_host(), rep.sorted_ok and perm_ok

    return sorter


def _run(args, job: JobConfig) -> int:
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    if args.device_resident:
        if args.mode != "spmd":
            raise SystemExit("--device-resident requires --mode spmd")
        if job.checkpoint_dir:
            log.warning(
                "--device-resident does not checkpoint: --checkpoint-dir/--job-id are "
                "ignored; a failed job re-runs from the input"
            )
        sorter = _make_device_sorter(job, args.workers, args.device)
    else:
        host_sorter = _make_sorter(job, args.mode, args.workers, args.device)
        job_id = _job_id_for(args.input, args.job_id) if job.checkpoint_dir else None

        def sorter(data, metrics):
            out = host_sorter(data, metrics, job_id=job_id)
            metrics.event("result_fetch", n_keys=len(out))
            return out, True

    journal = EventLog() if args.journal else None
    try:
        keys = ingest.read_ints_file(args.input, job.key_dtype)
        metrics = Metrics(journal=journal)
        try:
            out, ok = sorter(keys, metrics)
        except BaseException as e:
            # The schedulers journal job_failed only on their clean failure
            # path (no live worker); close the job on any other escape too.
            metrics.event(
                "job_failed", reason=(str(e).splitlines() or [repr(e)])[0][:120],
                counters=dict(metrics.counters),
            )
            raise
        ingest.write_ints_file(args.output, out)
    finally:
        # The journal exists to answer "what happened": a failed job's
        # fault timeline lands on disk too.
        if journal is not None:
            journal.flush_jsonl(args.journal)
    if not ok:
        log.error("on-device validation FAILED for %s", args.input)
        return 1
    return 0


def _sigterm_to_interrupt(signum, frame):
    """SIGTERM handler of ``serve``: the same graceful path as Ctrl-C
    (drain, reject new admissions, flush the journal, exit 0)."""
    raise KeyboardInterrupt


def _make_serve_service(args, cfg: SortConfig, journal, telemetry):
    """The `serve.SortService` behind ``serve``: spmd gets slices and the
    whole mesh; taskpool / local wrap their sorter as the service's runner,
    with the same admission, fairness and shutdown."""
    import dataclasses

    from dsort_tpu_torch.serve import SortService
    from dsort_tpu_torch.serve.fair import parse_weights

    serve_over: dict = {}
    for flag, field in (("slice_devices", "slice_devices"), ("queue_limit", "max_queue_depth"),
                        ("tenant_limit", "max_tenant_inflight"), ("slo_shed_ms", "slo_shed_ms")):
        if getattr(args, flag, None):
            serve_over[field] = getattr(args, flag)
    if args.weights:
        serve_over["tenant_weights"] = parse_weights(args.weights)
    if args.prewarm == "all":
        serve_over["prewarm_policy"] = "all"
    serve_cfg = dataclasses.replace(cfg.serve, **serve_over)
    workers = cfg.mesh.num_workers or 8
    kwargs = dict(job=cfg.job, serve=serve_cfg, telemetry=telemetry, journal=journal,
                  journal_path=args.journal)
    if args.mode == "spmd":
        service = SortService(workers, args.device, **kwargs)
    else:
        service = SortService(
            runner=_make_sorter(cfg.job, args.mode, workers, args.device), **kwargs
        )
    if args.prewarm or serve_cfg.prewarm:
        log.info("variant cache prewarmed: %d rung(s)", service.prewarm())
    return service


def _parse_serve_line(line: str, default_tenant: str) -> tuple[str, str]:
    """``[tenant=NAME] path`` -> (tenant, path)."""
    name = line.strip()
    tenant = default_tenant
    if name.startswith("tenant="):
        head, _, rest = name.partition(" ")
        tenant = head[len("tenant="):]
        name = rest.strip()
    return tenant, name


def _serve(args, cfg: SortConfig) -> int:
    """``serve``: the reference's interactive loop on the serving core."""
    import signal

    from dsort_tpu_torch.utils.events import EventLog

    journal = EventLog() if args.journal else None
    if args.job_id and cfg.job.checkpoint_dir:
        log.warning("serve ignores --job-id: each input file checkpoints under its own name")
    telemetry = server = None
    if args.metrics_port is not None:
        from dsort_tpu_torch.obs import MetricsServer, Telemetry

        telemetry = Telemetry()
        server = MetricsServer(telemetry, port=args.metrics_port)
        log.info("metrics endpoint: %s", server.url)
    old_term = None
    try:
        service = _make_serve_service(args, cfg, journal, telemetry)
        try:
            old_term = signal.signal(signal.SIGTERM, _sigterm_to_interrupt)
        except ValueError:
            pass  # not the main thread: the Ctrl-C path still holds
        return _serve_loop(args, cfg, service)
    finally:
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if server is not None:
            server.close()


def _serve_loop(args, cfg: SortConfig, service) -> int:
    from dsort_tpu_torch.data import ingest

    out_path = args.output or cfg.output_path
    max_in_flight = max(args.max_in_flight or 1, 1)
    pending: list[tuple[str, float, object]] = []  # (name, t0, ticket)

    def reap(limit: int) -> None:
        """Write out finished tickets in order; block on the oldest only
        while ``limit`` or more jobs are in flight."""
        while pending:
            name, t0, ticket = pending[0]
            if len(pending) < limit and not ticket.done():
                break
            pending.pop(0)
            try:
                out = ticket.result()
            except Exception as e:  # a bad job must not kill the server
                log.error("job failed (%s): %s", name, e)
                continue
            try:
                ingest.write_ints_file(out_path, out)
            except OSError as e:  # nor an unwritable output path
                log.error("result write failed (%s): %s", name, e)
                continue
            log.info(
                "sorted %d keys in %.1f ms (%s, tenant %s) -> %s | %s",
                len(out), (time.perf_counter() - t0) * 1e3, name, ticket.tenant, out_path,
                dict(ticket.metrics.counters),
            )

    interrupted = False
    while True:
        try:
            line = input("Enter the filename to sort (or 'exit' to quit): ")
        except EOFError:
            break
        except KeyboardInterrupt:
            # SIGINT, and SIGTERM through `_sigterm_to_interrupt`: drain below.
            print()
            interrupted = True
            break
        tenant, name = _parse_serve_line(line, cfg.job.tenant)
        if not name:
            continue
        if name == "exit":
            break
        try:
            data = ingest.read_ints_file(name, cfg.job.key_dtype)
        except Exception as e:  # unreadable input must not kill the server
            log.error("job failed (%s): %s", name, e)
            continue
        jid = _job_id_for(name, None) if cfg.job.checkpoint_dir else None
        verdict, ticket = service.submit(data, tenant=tenant, job_id=name, ckpt_job_id=jid)
        if not verdict.admitted:
            log.error(
                "job NOT admitted (%s): %s (queue depth %d, tenant depth %d)",
                name, verdict.reason, verdict.queue_depth, verdict.tenant_depth,
            )
            continue
        pending.append((name, time.perf_counter(), ticket))
        # One job at a time by default (the reference's blocking loop); the
        # service flushes the journal after every completion.
        reap(limit=max_in_flight)
    if interrupted:
        st = service.stats()
        log.warning(
            "shutting down: draining %d queued + %d in-flight job(s); new admissions are "
            "rejected with verdict 'shutting_down'", st["queued"], st["in_flight"],
        )
    service.shutdown(drain=True)
    reap(limit=1)
    return 0


def _gen(args) -> int:
    """``dsort gen``: the reference's seeded input files, byte for byte."""
    import numpy as np

    from dsort_tpu_torch.data import ingest

    if args.dist == "terasort":
        if args.format == "bin":
            # TeraSort files are always binary records; a --format bin here
            # would be silently ignored, so it is refused.
            raise SystemExit(
                "--format bin is for raw key files; --dist terasort always "
                "writes binary 100-byte records (drop --format)"
            )
        ingest.gen_terasort_file(args.output, args.n, seed=args.seed)
        log.info("wrote %d terasort records to %s", args.n, args.output)
        return 0
    if args.format == "bin":
        if args.dist != "uniform":
            raise SystemExit("--format bin supports --dist uniform only")
        ingest.gen_uniform_bin_file(args.output, args.n, dtype=np.dtype(args.dtype),
                                    seed=args.seed)
        log.info("wrote %d %s binary keys to %s", args.n, args.dtype, args.output)
        return 0
    if args.dist == "uniform":
        data = ingest.gen_uniform(args.n, dtype=np.dtype(args.dtype), seed=args.seed)
    else:
        data = ingest.gen_zipf(args.n, a=args.zipf_a, dtype=np.dtype(args.dtype), seed=args.seed)
    ingest.write_ints_file(args.output, data)
    log.info("wrote %d %s keys (%s) to %s", args.n, args.dtype, args.dist, args.output)
    return 0


def _validate(args) -> int:
    """``dsort validate``: order + permutation of ``--against``; one JSON
    line, exit 0 only when both hold."""
    import numpy as np

    from dsort_tpu_torch.models import validate as v

    dtype = np.dtype(args.dtype)
    if args.terasort:
        rep = v.validate_terasort_file(args.input)
    elif args.binary:
        rep = v.validate_bin_file(args.input, dtype=dtype)
    else:
        rep = v.validate_ints_file(args.input, dtype=dtype)
    result = {"records": rep.records, "sorted": rep.sorted_ok, "checksum": f"{rep.checksum:016x}"}
    if rep.first_violation is not None:
        result["first_violation"] = rep.first_violation
    ok = rep.sorted_ok
    if args.against:
        if args.terasort:
            n_in, sum_in = v.checksum_terasort_file(args.against)
        elif args.binary:
            n_in, sum_in = v.checksum_bin_file(args.against, dtype=dtype)
        else:
            n_in, sum_in = v.checksum_ints_file(args.against, dtype=dtype)
        result["permutation_of_input"] = n_in == rep.records and sum_in == rep.checksum
        ok = ok and result["permutation_of_input"]
    print(json.dumps(result))
    return 0 if ok else 1


def _journaled(args, run, what: str | None = None) -> int:
    """``run(metrics)`` with the job's journal written to ``args.journal``
    once it ends, also when it failed; logs the wall time and phases of
    ``what`` (default ``INPUT -> OUTPUT``)."""
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    journal = EventLog() if args.journal else None
    metrics = Metrics(journal=journal)
    t0 = time.perf_counter()
    try:
        run(metrics)
    finally:
        if journal is not None:
            journal.flush_jsonl(args.journal)
    log.info(
        "%s %s in %.1f ms | %s | phases: %s", args.cmd, what or f"{args.input} -> {args.output}",
        (time.perf_counter() - t0) * 1e3, dict(metrics.counters),
        metrics.summary()["phases_ms"],
    )
    return 0


def _external(args) -> int:
    """``external``: `ExternalSort`, or `ExternalWaveSort` with ``--mesh``."""
    import numpy as np

    ext = ExternalConfig(
        run_elems=args.run_elems if args.run_elems is not None else ExternalConfig.run_elems,
        wave_elems=args.wave_elems if args.wave_elems is not None else ExternalConfig.wave_elems,
        mesh=args.mesh,
    )
    if ext.mesh:
        from dsort_tpu_torch.models.wave_sort import ExternalWaveSort
        from dsort_tpu_torch.parallel.mesh import VirtualMesh

        job_kw = {}
        if args.kernel:
            job_kw["local_kernel"] = args.kernel
        if args.hier_hosts:
            job_kw["hier_hosts"] = args.hier_hosts
        s = ExternalWaveSort(
            VirtualMesh(ext.mesh, args.device), wave_elems=ext.wave_elems,
            spill_dir=args.spill_dir, job_id=args.job_id,
            job=JobConfig(**job_kw) if job_kw else None, resume=not args.no_resume,
            overlap=not args.no_overlap, exchange=args.exchange,
            redundancy=args.redundancy, redundancy_mode=args.redundancy_mode,
        )
    else:
        from dsort_tpu_torch.models.external_sort import ExternalSort

        if args.exchange:
            log.warning(
                "--exchange has no effect without --mesh: the single-device external "
                "sort has no exchange; add --mesh N to run the wave pipeline"
            )
        if args.redundancy and args.redundancy > 1:
            log.warning(
                "--redundancy has no effect without --mesh: the single-device external "
                "sort has no replica plane; add --mesh N to run coded waves"
            )
        s = ExternalSort(
            run_elems=ext.run_elems, spill_dir=args.spill_dir, job_id=args.job_id,
            local_kernel=args.kernel or "auto", resume=not args.no_resume,
            device=args.device,
        )
    return _journaled(args, lambda m: s.sort_binary_file(
        args.input, args.output, dtype=np.dtype(args.dtype), metrics=m))


def _terasort_external(args, job: JobConfig) -> int:
    """``terasort --external``: `ExternalTeraSort`, or `ExternalWaveTeraSort`
    with ``--mesh`` (its exchange is on the host, so ``--exchange`` is
    recorded and warned, as in the reference)."""
    if args.mesh:
        from dsort_tpu_torch.models.wave_sort import ExternalWaveTeraSort
        from dsort_tpu_torch.parallel.mesh import VirtualMesh

        s = ExternalWaveTeraSort(
            VirtualMesh(args.mesh, args.device), wave_recs=args.run_recs,
            spill_dir=args.spill_dir, job_id=args.job_id, resume=not args.no_resume,
            job=job, exchange=args.exchange,
        )
    else:
        from dsort_tpu_torch.models.external_sort import ExternalTeraSort

        if args.exchange:
            log.warning(
                "--exchange has no effect without --mesh: the single-device external "
                "record sort has no exchange; add --mesh N to run record waves"
            )
        s = ExternalTeraSort(
            run_recs=args.run_recs, spill_dir=args.spill_dir, job_id=args.job_id,
            resume=not args.no_resume, device=args.device,
        )
    return _journaled(args, lambda m: s.sort_file(args.input, args.output, metrics=m))


def _batch(args, job: JobConfig) -> int:
    """``batch``: every input file through one `BatchSampleSort.sort` call;
    each writes ``<outdir>/<basename>``.  Refused before any sort: two
    inputs with one basename (they would overwrite each other), and, with
    ``--checkpoint-dir``, two that sanitise to one checkpoint id (they
    would clear each other's results every run)."""
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import BatchSampleSort

    names = [os.path.basename(p) for p in args.inputs]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise SystemExit(
            f"duplicate input basenames would overwrite each other in --outdir: {dupes}"
        )
    job_ids = None
    if job.checkpoint_dir:
        job_ids = [_job_id_for(p, None) for p in args.inputs]
        id_dupes = sorted({j for j in job_ids if job_ids.count(j) > 1})
        if id_dupes:
            raise SystemExit(
                f"these inputs sanitize to the same checkpoint id(s) {id_dupes}; rename "
                "the files or drop --checkpoint-dir"
            )
    bss = BatchSampleSort(VirtualMesh(args.workers, args.device), job, dp=args.dp)
    os.makedirs(args.outdir, exist_ok=True)

    def run(metrics):
        jobs = [ingest.read_ints_file(p, job.key_dtype) for p in args.inputs]
        outs = bss.sort(jobs, metrics=metrics, job_ids=job_ids)
        for src, out in zip(args.inputs, outs):
            ingest.write_ints_file(os.path.join(args.outdir, os.path.basename(src)), out)

    return _journaled(args, run, f"{len(args.inputs)} files (dp={args.dp}) -> {args.outdir}")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "gen":
        return _gen(args)
    if args.cmd == "validate":
        return _validate(args)
    knobs = {"exchange": args.exchange, "hier_hosts": args.hier_hosts,
             "redundancy": args.redundancy, "redundancy_mode": args.redundancy_mode}
    if args.cmd == "external":
        return _external(args)
    if args.cmd in ("run", "batch", "serve"):
        cfg = _load_config(args)
        args.workers = cfg.mesh.num_workers or 8
        if args.cmd == "run":
            return _run(args, cfg.job)
        if args.cmd == "serve":
            return _serve(args, cfg)
        args.dp = args.dp or cfg.mesh.dp
        return _batch(args, cfg.job)
    knobs.update(local_kernel=args.kernel, merge_kernel=args.merge_kernel)
    job = JobConfig(**{k: v for k, v in knobs.items() if v})
    args.workers = args.workers or 8
    if args.external:
        return _terasort_external(args, job)
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    ss = SampleSort(VirtualMesh(args.workers, args.device), job)
    keys, payload = ingest.read_terasort_file(args.input)
    sk, sv = ss.sort_kv(
        keys, payload, secondary=ingest.terasort_secondary(payload),
        exchange=args.exchange,
    )
    ingest.write_terasort_file(args.output, sk, sv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
