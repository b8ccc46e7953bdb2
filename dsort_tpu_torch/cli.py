"""Command line: ``python -m dsort_tpu_torch.cli {run,serve,batch,terasort,external,coordinator,worker,fleet,fleet-agent,bench,validate,gen,report,top,lint,spec} ...``.

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
  ``--device-resident`` warn and ignore the flags, as the reference does.
  ``--profile-dir DIR`` captures the job under ``torch.profiler``
  (`utils.tracing.profile_trace`) into ``DIR/trace.json``, a Chrome trace
  holding each phase as a ``dsort:<phase>`` range and the CUDA kernels;
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
  granularity under ``--spill-dir`` / ``--job-id``;
- ``coordinator [--workers N] [--port P] [--join-timeout S] [-o OUT]
  [--dtype D] [--conf F] [--journal J]``: the reference's master over TCP
  (`_coordinator`): the native coordinator (`runtime.NativeCoordinator`)
  waits for ``N`` workers (default 4), then each stdin line names a file,
  which is split into ``N`` chunks, sorted by the workers (a dead worker's
  chunk is reassigned) and merged into ``OUT``; ``exit`` or end of input
  ends the loop with exit 0.  ``--journal`` is rewritten after every job,
  failed ones included;
- ``worker [--host H] [--port P] [--conf F] [--dtype D] [--backend
  torch|numpy] [--kernel K] [--device cpu]``: one worker process
  (`runtime.worker`): it joins the coordinator and sorts each chunk on the
  card (``--backend torch``, the default) until the coordinator stops.
- ``fleet-agent [--workers N] [--host H] [--port P] [--agent-id ID]
  [--metrics-port P] [--prewarm [auto|all]] [--slice-devices S]
  [--queue-limit Q] [--tenant-limit T] [--journal J]``: one fleet
  execution agent (`_fleet_agent`): a `fleet.FleetAgent` over a
  `serve.SortService` of ``N`` virtual workers on the card, listening for
  a controller on ``H:P`` (``P`` 0 = any free port; the bound address is
  printed as ``fleet agent ID listening on H:P``).  SIGINT and SIGTERM
  drain it: the queued and in-flight jobs finish, new submits are refused
  with ``shutting_down``, and it exits 0;
- ``fleet --agents H:P,... [--state-dir D] [--routing
  locality|random|health] [--no-health-telemetry] [--dispatch-timeout S]
  [--max-in-flight N] [--queue-limit Q] [--tenant-limit T] [--weights W]
  [--slo-shed-ms MS] [--metrics-port P] [-o OUT] [--journal J]``: the
  fleet controller's REPL (`_fleet`): ``serve``'s loop, each stdin line
  ``[tenant=NAME] PATH`` submitted to a `fleet.FleetController` (conf
  ``FLEET_*`` keys under the flags), which routes it to an agent; with
  ``--state-dir`` a restarted controller loses no job.  The controller
  sorts nothing and never imports torch;
- ``bench [--n N] [--reps R] [MODE]``: the reference's benchmark
  (`cli_bench`): the plain mode (``--mode`` sorter over ``--n`` uniform
  keys), ``--suite``, ``--device-resident``, ``--exchange-ab``,
  ``--coded-ab``, ``--coded-v2-ab``, ``--hier-ab``, ``--autotune-ab``,
  ``--serve-mixed``, ``--analyze-smoke``, ``--external-wave``,
  ``--fleet-mixed``; JSON lines
  with the reference's names and keys, the exit code the mode's gates.

The sorting subcommands take ``--journal J``, ``--journal-rotate-mb N``
(the journal rotates to ``J.1``, ``J.2``, ... at N MiB; `_open_journal`)
and ``--memwatch`` (an ``hbm_watermark`` event at every phase boundary,
`obs.prof.MemWatch`; in ``serve`` on every admitted job).  The in-core
``terasort`` journals its `SampleSort.sort_kv` job too.  They also take ``--kernel`` (`JobConfig.local_kernel`,
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
yields.  They also take ``--tenant`` and ``--flight-dir``.  ``bench`` and
``coordinator`` take the reference's whole ``common()`` set (`_common_flags`),
folded into the config the same way; ``batch`` accepts its ``--mode``,
``--job-id`` and ``-o`` as the reference does, and reads none of them;
``terasort`` and ``external`` take ``--conf`` (the job's keys and the
``EXTERNAL_*`` keys, under the flags).  Two
host tools run no sort and touch no device, as ``dsort``'s do:

- ``validate INPUT [--against FILE] [--terasort|--binary] [--dtype D]``:
  order plus the permutation checksum (`models.validate`); prints one JSON
  line and exits 0 only when both hold;
- ``gen N -o FILE [--dist uniform|zipf|terasort] [--dtype D] [--zipf-a A]
  [--seed S] [--format text|bin]``: the reference's seeded inputs, byte for
  byte;
- ``report JOURNAL... [--merge] [--chrome-trace F] [--analyze]
  [--analyze-json F] [--link-mbps M] [--conform]``: renders journals of
  either package (`_report`): the timeline, or the why-slow verdict, or the
  trace-contract check (exit 1 on a violation);
- ``top [URL...] [--interval S] [--count N]``: the console view of
  ``serve --metrics-port`` endpoints (`_top`); exit 1 when none answers;
- ``lint [PATHS] [--format text|json|sarif] [--stats] [--baseline F]
  [--write-baseline] [--changed] [--no-cache] [--root R]``: the port's
  static analysis (`dsort_tpu_torch.analysis`, `_lint`) of
  ``dsort_tpu_torch/`` by default; exit 0 clean, 1 findings.  It parses
  the tree and never imports torch, so it needs no card;
- ``spec check [--agents A] [--jobs J] [--duplications D] [--deaths D]
  [--crashes C] [--max-states N] [--max-depth D] [--seam S]
  [--dump-fixture F]`` / ``spec replay --fixture F``: the fleet protocol's
  model checker (`analysis.spec.model`, `_spec`) over the port's
  `ControlPolicy`; ``check`` exits 0 when no invariant is violated in the
  explored space and 1 on a violation (printed with its minimized
  schedule, written as a fixture with ``--dump-fixture``), ``replay`` exits
  0 when the fixture still reproduces its violation.  It imports numpy,
  never torch.
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


def _knobs(p: argparse.ArgumentParser, device: bool = True,
           workers_help: str = "virtual mesh shards (default 8; conf NUM_WORKERS)") -> None:
    """The mesh, exchange and kernel flags every sorting subcommand takes
    (``--device`` where the subcommand sorts in this process)."""
    p.add_argument("--workers", type=int, default=None, help=workers_help)
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
    if device:
        p.add_argument("--device", default=None, help="cuda (default) or cpu")


def _introspection_flags(p: argparse.ArgumentParser) -> None:
    """``--journal-rotate-mb`` and ``--memwatch``, on every sorting subcommand."""
    p.add_argument("--journal-rotate-mb", type=float,
                   help="rotate the journal to PATH.N at this size (MiB), so a long "
                        "session never grows one unbounded file; `report` stitches the "
                        "set back")
    p.add_argument("--memwatch", action="store_true",
                   help="snapshot device memory at every phase boundary into "
                        "hbm_watermark journal events (obs.prof)")


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


def _common_flags(p: argparse.ArgumentParser, device: bool = True, **knob_kw) -> None:
    """The reference's ``common()`` flags (``bench``, ``coordinator``): the
    knobs, the config flags, ``--dtype``, ``--mode``, the checkpoint and
    journal flags and ``-o``, folded into the config by `_load_config`."""
    _knobs(p, device, **knob_kw)
    _config_flags(p)
    p.add_argument("--dtype", default=None, help="key dtype (default int32, conf KEY_DTYPE)")
    p.add_argument("--mode", choices=MODES, default="spmd",
                   help="spmd (fused route under 2^20 keys, else the SPMD scheduler), "
                        "taskpool or local")
    p.add_argument("--checkpoint-dir",
                   help="persist per-shard/range progress here (conf CHECKPOINT_DIR)")
    p.add_argument("--job-id", help="checkpoint namespace")
    p.add_argument("--journal", default=None,
                   help="write the structured event journal (JSONL) here")
    p.add_argument("--journal-rotate-mb", type=float,
                   help="rotate the journal to PATH.N at this size (MiB)")
    p.add_argument("-o", "--output", default=None,
                   help="where sorted keys go (default output.txt, conf OUTPUT_PATH)")


def _bench_flags(p: argparse.ArgumentParser) -> None:
    """``bench``'s own flags: the size, the reps and one flag a mode
    (`cli_bench`)."""
    p.add_argument("--n", type=int, default=1 << 22)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--memwatch", action="store_true",
                   help="snapshot device memory at phase boundaries into hbm_watermark "
                        "journal events")
    p.add_argument("--suite", action="store_true",
                   help="run the BASELINE config ladder (one JSON line each)")
    p.add_argument("--device-resident", action="store_true",
                   help="time the sort that keeps its result on the device and the "
                        "on-device validation, one JSON line each")
    p.add_argument("--exchange-ab", action="store_true",
                   help="alltoall / ring / fused exchange A/B on the mesh (uniform, zipf, "
                        "records; bit-identical gate, bytes_on_wire a schedule)")
    p.add_argument("--serve-mixed", action="store_true",
                   help="multi-tenant serving benchmark: a mixed small/large three-tenant "
                        "workload through admission with slice packing; jobs/s, p95 queue "
                        "wait, fairness, variant-cache hit rate, packed against serial")
    p.add_argument("--analyze-smoke", action="store_true",
                   help="the introspection plane's price: the same ring sort with and "
                        "without the journal and ledger (overhead_frac < 5%% from 2^20 "
                        "keys), plus the zipf-against-uniform skew margin")
    p.add_argument("--coded-ab", action="store_true",
                   help="coded-redundancy failure A/B: zipf at redundancy 1 against 2, "
                        "healthy against one injected worker loss (bit-identical gate)")
    p.add_argument("--coded-v2-ab", action="store_true",
                   help="replicate against parity at redundancy 2: the wire premium "
                        "(parity < 0.75x replicate), one loss a mode (local recovery), "
                        "the straggler drill (p99 serve beats waiting on the owner)")
    p.add_argument("--autotune-ab", action="store_true",
                   help="planner A/B: zipf + uniform with the exchange hand-set to "
                        "alltoall, to ring, and planner-chosen; gates the pick and "
                        "autotune >= 0.95x the best hand-set arm from 2^20 keys")
    p.add_argument("--hier-ab", action="store_true",
                   help="flat ring against the two-level exchange at every HxD grouping "
                        "of the mesh, plus the worker-loss and host-loss drills")
    p.add_argument("--external-wave", action="store_true",
                   help="the wave pipeline on a dataset 8x its per-wave budget: overlap "
                        "on against off, and a mid-wave loss with run-granular repair")
    p.add_argument("--fleet-mixed", action="store_true",
                   help="fleet benchmark: two in-process agents, each a SortService over "
                        "half the workers, behind a FleetController over loopback TCP; "
                        "locality against random routing (cache hit rates), the health "
                        "plane's overhead and a health-routing arm (bit-identical gate)")


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
    _introspection_flags(run)
    run.add_argument("--device-resident", action="store_true",
                     help="keep the sorted keys on the device and validate them there "
                          "(order + multiset checksum); the output file write is the "
                          "only device-to-host copy of keys")
    run.add_argument("--checkpoint-dir",
                     help="persist per-shard/range progress here; a re-run of the same "
                          "input resumes instead of re-sorting")
    run.add_argument("--job-id", help="checkpoint namespace (default: input basename)")
    run.add_argument("--profile-dir",
                     help="capture a torch.profiler trace of the job here (trace.json: "
                          "host ranges dsort:<phase> and the CUDA kernels)")
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
    _introspection_flags(serve)
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
    _introspection_flags(batch)
    batch.add_argument("--checkpoint-dir",
                       help="persist each finished file's result here; a re-run restores "
                            "them and sorts only the rest")
    batch.add_argument("--mode", choices=MODES, default="spmd",
                       help="accepted as the reference's batch accepts it; a batch is one "
                            "BatchSampleSort program")
    batch.add_argument("--job-id", help="accepted as the reference's batch accepts it; each "
                                        "file checkpoints under its own basename")
    batch.add_argument("-o", "--output", help="accepted as the reference's batch accepts it; "
                                              "each file goes to OUTDIR/<basename>")
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
    tera.add_argument("--conf", help="KEY=value conf file (EXCHANGE, HIER_HOSTS, EXTERNAL_* "
                                     "keys; flags win)")
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
    ext.add_argument("--conf", help="KEY=value conf file (EXTERNAL_* keys; flags win)")
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
    rep = sub.add_parser("report", help="render event journal(s): timeline, phases, counters")
    rep.add_argument("journal", nargs="+",
                     help="journal JSONL(s) from --journal; several merge into one "
                          "clock-aligned timeline; a directory or glob expands to the "
                          "journals inside; a rotated set is given by its base path")
    rep.add_argument("--merge", action="store_true",
                     help="merge the journals into one aligned trace (implied when more "
                          "than one is given)")
    rep.add_argument("--chrome-trace",
                     help="also export a Perfetto trace_event JSON here (one pid per "
                          "source journal, one tid per job)")
    rep.add_argument("--analyze", action="store_true",
                     help="replay the journal(s) into a why-slow verdict: phase waterfall "
                          "and critical path, straggler, queue/first-call/execute split, "
                          "wire bytes, skew, memory watermark")
    rep.add_argument("--analyze-json", help="also write the machine-readable verdict here")
    rep.add_argument("--link-mbps", type=float,
                     help="link bandwidth (Mbit/s): prices the journal's wire bytes into "
                          "expected seconds in the verdict")
    rep.add_argument("--conform", action="store_true",
                     help="replay the journal(s) against the declared trace contracts and "
                          "exit 1 on any violation")
    coord = sub.add_parser("coordinator", help="the native TCP coordinator: file names on "
                                               "stdin, sorted by a cluster of workers")
    # The reference's common() flags; the coordinator reads the key dtype,
    # the heartbeat timeout, the port and the output path of the config.
    _common_flags(coord, device=False,
                  workers_help="workers to wait for; each job is split into this many "
                               "chunks (default 4)")
    coord.add_argument("--port", type=int, help="listening port (default 9008, conf "
                                                "SERVER_PORT; 0 = any free port)")
    coord.add_argument("--join-timeout", type=float, default=60.0,
                       help="seconds to wait for the workers to join")
    agent = sub.add_parser("fleet-agent", help="fleet execution agent: a SortService on the "
                                               "card served to a fleet controller")
    _common_flags(agent)
    agent.add_argument("--host", default="127.0.0.1",
                       help="bind address for the fleet protocol endpoint")
    agent.add_argument("--port", type=int, default=0,
                       help="fleet protocol port (0 = any free port, printed at startup)")
    agent.add_argument("--agent-id",
                       help="stable agent identity (default: generated); a restarted agent "
                            "keeps its routing identity by reusing the id")
    agent.add_argument("--metrics-port", type=int,
                       help="serve this agent's live telemetry on this localhost port "
                            "(render the fleet with `top URL...`)")
    agent.add_argument("--prewarm", nargs="?", const="auto", choices=("auto", "all"),
                       help="run the fused rungs once on every slice at startup, advertised "
                            "to the controller for locality routing: 'auto' the planner's "
                            "predicted set, 'all' the exhaustive ladder")
    agent.add_argument("--slice-devices", type=int,
                       help="virtual workers per small-job slice")
    agent.add_argument("--queue-limit", type=int, help="this agent's local queue bound")
    agent.add_argument("--tenant-limit", type=int, help="this agent's local per-tenant bound")
    agent.add_argument("--weights", help=argparse.SUPPRESS)
    agent.add_argument("--slo-shed-ms", type=float, help=argparse.SUPPRESS)
    agent.add_argument("--max-in-flight", type=int, help=argparse.SUPPRESS)
    fleet = sub.add_parser("fleet", help="fleet controller REPL: route jobs over fleet agents; "
                                         "restart-safe")
    # The controller sorts nothing: no --device.
    _common_flags(fleet, device=False)
    fleet.add_argument("--agents", help="agent endpoints host:port,host:port (conf "
                                        "FLEET_AGENTS)")
    fleet.add_argument("--state-dir",
                       help="persist the control-plane state here so a controller restart "
                            "loses no job (conf FLEET_STATE_DIR)")
    fleet.add_argument("--routing", choices=["locality", "random", "health"],
                       help="variant-cache-locality routing (default), the random A/B "
                            "baseline, or health: locality for small jobs plus big jobs "
                            "placed by the live straggler verdicts (conf FLEET_ROUTING)")
    fleet.add_argument("--no-health-telemetry", action="store_true",
                       help="heartbeats only: do not opt agents into the health plane's "
                            "delta stream (conf FLEET_TELEMETRY=0)")
    fleet.add_argument("--dispatch-timeout", type=float,
                       help="per-agent send deadline in seconds: a stuck-but-connected agent "
                            "fails over after this long (conf FLEET_DISPATCH_TIMEOUT_S; "
                            "default: the request timeout)")
    fleet.add_argument("--metrics-port", type=int,
                       help="serve the controller's telemetry on this localhost port")
    fleet.add_argument("--max-in-flight", type=int, default=1,
                       help="REPL jobs in flight at once (as serve's)")
    fleet.add_argument("--queue-limit", type=int,
                       help="admission control: most jobs queued fleet-wide")
    fleet.add_argument("--tenant-limit", type=int,
                       help="admission control: most queued + running jobs a tenant")
    fleet.add_argument("--weights", help="fair-scheduler tenant weights, e.g. acme=2,blue=1")
    fleet.add_argument("--slo-shed-ms", type=float,
                       help="admission shedding target (ms, a tenant's live p95 queue wait)")
    bench = sub.add_parser("bench", help="throughput benchmark: JSON lines a mode (cli_bench)")
    _common_flags(bench)
    _bench_flags(bench)
    from dsort_tpu_torch.runtime.worker import add_worker_args

    add_worker_args(sub.add_parser("worker", help="a worker process: joins a coordinator "
                                                  "and sorts its chunks on the card"))
    lint = sub.add_parser("lint", help="project-native static analysis of the port's tree "
                                       "(dsort_tpu_torch.analysis; never imports torch)")
    lint.add_argument("paths", nargs="*",
                      help="files/directories to check (default: dsort_tpu_torch/)")
    lint.add_argument("--format", default="text", choices=["text", "json", "sarif"],
                      help="output format (sarif: SARIF 2.1.0 for code-scanning upload)")
    lint.add_argument("--stats", action="store_true",
                      help="print a per-checker wall-time/findings table (file vs "
                           "project phase) to stderr")
    lint.add_argument("--baseline",
                      help="baseline JSON path (default: the port's, "
                           "dsort_tpu_torch/analysis/lint-baseline.json)")
    lint.add_argument("--write-baseline", action="store_true",
                      help="record the current findings as tolerated (the shipped "
                           "tree keeps this file empty)")
    lint.add_argument("--changed", action="store_true",
                      help="lint only files under dsort_tpu_torch/ changed vs git HEAD "
                           "(plus untracked)")
    lint.add_argument("--no-cache", action="store_true",
                      help="skip the content-hash result cache (.lint-cache.torch.json)")
    lint.add_argument("--root",
                      help="project root (default: nearest directory holding "
                           "dsort_tpu_torch/)")
    spec = sub.add_parser("spec", help="the fleet protocol's model checker over the port's "
                                       "ControlPolicy, or replay of a violation fixture")
    spec.add_argument("action", choices=["check", "replay"],
                      help="check: explore bounded interleavings against the invariant "
                           "catalog; replay: re-execute a dumped violation fixture "
                           "deterministically")
    spec.add_argument("--fixture", help="fixture JSON for `replay`")
    spec.add_argument("--agents", type=int, default=2, help="modeled fleet size (default 2)")
    spec.add_argument("--jobs", type=int, default=3,
                      help="jobs submitted in the model (default 3)")
    spec.add_argument("--duplications", type=int, default=1,
                      help="frame retransmission budget (default 1)")
    spec.add_argument("--deaths", type=int, default=1, help="link-death budget (default 1)")
    spec.add_argument("--crashes", type=int, default=1,
                      help="controller crash+restore budget (default 1)")
    spec.add_argument("--max-states", type=int, default=12_000,
                      help="distinct-state exploration bound (default 12000, the smoke bound)")
    spec.add_argument("--max-depth", type=int, default=40,
                      help="schedule depth bound (default 40)")
    spec.add_argument("--seam", action="append",
                      choices=["ack_before_persist", "nonatomic_reserve"],
                      help="re-introduce a known-bad mutation (test seam); repeatable: the "
                           "checker must find a violation")
    spec.add_argument("--dump-fixture",
                      help="write the minimized violating schedule as a replayable JSON "
                           "fixture here")
    top = sub.add_parser("top", help="console view of running metrics endpoint(s)")
    top.add_argument("url", nargs="*",
                     help="metrics endpoint URL(s) (default http://127.0.0.1:9100/metrics; "
                          "several render the per-source view with combined tables)")
    top.add_argument("--interval", type=float,
                     help="refresh every N seconds (default: one-shot)")
    top.add_argument("--count", type=int, help="stop after N refreshes (with --interval)")
    return ap


def _store_flags(p: argparse.ArgumentParser, job_id: str) -> None:
    """The run store and journal flags of the out-of-core subcommands."""
    p.add_argument("--spill-dir", help="where spilled runs live (default: a temp dir)")
    p.add_argument("--job-id", default=job_id)
    p.add_argument("--no-resume", action="store_true",
                   help="discard checkpointed runs and start fresh")
    p.add_argument("--journal", default=None,
                   help="write the job's structured event journal (JSONL) here")
    _introspection_flags(p)


def _open_journal(args):
    """An `EventLog` when ``--journal`` was given, else None; with
    ``--journal-rotate-mb N`` it rotates at N MiB (`EventLog` docs)."""
    if not getattr(args, "journal", None):
        return None
    from dsort_tpu_torch.utils.events import EventLog

    mb = getattr(args, "journal_rotate_mb", None)
    return EventLog(rotate_bytes=int(mb * (1 << 20)) if mb else None)


def _maybe_memwatch(args, metrics) -> None:
    """Attach the watermark tap (``--memwatch``) to a job's metrics."""
    if getattr(args, "memwatch", False):
        from dsort_tpu_torch.obs.prof import MemWatch

        MemWatch().attach(metrics)


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

    journal = _open_journal(args)
    try:
        keys = ingest.read_ints_file(args.input, job.key_dtype)
        metrics = Metrics(journal=journal)
        _maybe_memwatch(args, metrics)
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
    if getattr(args, "weights", None):
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
    if getattr(args, "memwatch", False):
        from dsort_tpu_torch.obs.prof import MemWatch

        service.job_taps.append(MemWatch())
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

    journal = _open_journal(args)
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


def _fleet_agent(args, cfg: SortConfig) -> int:
    """``fleet-agent``: one execution agent (`fleet.FleetAgent`) over the
    serving core on the card (`_make_serve_service`: ``--workers`` virtual
    workers in slices), serving jobs a ``fleet`` controller routes to it.
    It advertises its variant-cache keys and first-call ledger labels in
    heartbeats, for the controller's locality routing; ``--metrics-port``
    serves its live telemetry (``top URL1 URL2 ...`` renders the fleet).
    SIGINT / SIGTERM drain: queued and in-flight jobs complete (results
    held for the controller), new fleet submits are refused with
    ``shutting_down``, and the agent exits 0."""
    import signal

    from dsort_tpu_torch.fleet.agent import FleetAgent

    journal = _open_journal(args)
    telemetry = server = None
    if args.metrics_port is not None:
        from dsort_tpu_torch.obs import MetricsServer, Telemetry

        telemetry = Telemetry()
        server = MetricsServer(telemetry, port=args.metrics_port)
        log.info("agent metrics endpoint: %s", server.url)
    service = _make_serve_service(args, cfg, journal, telemetry)
    agent = FleetAgent(service=service, host=args.host, port=args.port,
                       agent_id=args.agent_id, journal=journal, journal_path=args.journal)
    print(f"fleet agent {agent.agent_id} listening on {agent.addr}", flush=True)
    stop = threading.Event()
    old = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old[sig] = signal.signal(sig, lambda signum, frame: stop.set())
        except ValueError:
            pass  # not the main thread
    try:
        stop.wait()
        log.warning("agent %s draining before exit", agent.agent_id)
        agent.close(drain=True)
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        if journal is not None:
            journal.flush_jsonl(args.journal)
        if server is not None:
            server.close()
    return 0


def _fleet(args, cfg: SortConfig) -> int:
    """``fleet``: ``serve``'s REPL over a `fleet.FleetController`, which
    routes each job to one of ``--agents`` (conf ``FLEET_AGENTS``).  The
    controller is a pure control plane (admission, weighted-DRR fairness,
    SLO shedding, locality routing) and imports no torch.  With
    ``--state-dir`` every transition persists, so a restarted controller
    loses no job: in-flight work keeps running on its agents and
    re-attaches through the journaled job ids, queued jobs drain in the
    same DRR order.  SIGINT / SIGTERM drain as ``serve``'s."""
    import dataclasses
    import signal

    from dsort_tpu_torch.fleet.controller import FleetController
    from dsort_tpu_torch.serve.fair import parse_weights

    journal = _open_journal(args)
    over: dict = {}
    for flag, field in (("state_dir", "state_dir"), ("routing", "routing"),
                        ("dispatch_timeout", "dispatch_timeout_s")):
        if getattr(args, flag, None):
            over[field] = getattr(args, flag)
    if args.no_health_telemetry:
        over["telemetry"] = False
    fleet_cfg = dataclasses.replace(cfg.fleet, **over)
    agents = args.agents or ",".join(fleet_cfg.agents)
    if not agents:
        raise SystemExit("fleet needs --agents host:port,... (or conf FLEET_AGENTS)")
    telemetry = server = None
    if args.metrics_port is not None:
        from dsort_tpu_torch.obs import MetricsServer, Telemetry

        telemetry = Telemetry()
        server = MetricsServer(telemetry, port=args.metrics_port)
        log.info("controller metrics endpoint: %s", server.url)
    job = cfg.job
    controller = FleetController(
        agents,
        state_dir=fleet_cfg.state_dir,
        max_queue_depth=args.queue_limit or cfg.serve.max_queue_depth,
        max_tenant_inflight=args.tenant_limit or cfg.serve.max_tenant_inflight,
        drr_quantum_keys=cfg.serve.drr_quantum_keys,
        tenant_weights=(parse_weights(args.weights) if args.weights
                        else dict(cfg.serve.tenant_weights)),
        slo_shed_ms=args.slo_shed_ms or cfg.serve.slo_shed_ms,
        routing=fleet_cfg.routing,
        heartbeat_s=fleet_cfg.heartbeat_s,
        dispatch_timeout_s=fleet_cfg.dispatch_timeout_s,
        default_tenant=job.tenant,
        journal=journal,
        journal_path=args.journal,
        telemetry=telemetry,
        health_telemetry=fleet_cfg.telemetry,
        flight_dir=job.flight_recorder_dir,
        # The planner's redundancy per dispatch (obs.plan): an explicit
        # --redundancy / conf REDUNDANCY is forwarded as it is and journals
        # a plan_override per dispatch.
        autotune=job.autotune,
        redundancy=job.redundancy if job.is_explicit("redundancy") else None,
        redundancy_mode=job.redundancy_mode if job.is_explicit("redundancy_mode") else None,
    )
    if controller.stats()["agents"] == 0:
        log.warning(
            "no agents reachable: submissions are rejected with the verdict 'no_capacity' "
            "until one connects (heartbeat retries every %.1fs)", fleet_cfg.heartbeat_s,
        )
    old_term = None
    try:
        old_term = signal.signal(signal.SIGTERM, _sigterm_to_interrupt)
    except ValueError:
        pass
    try:
        # The controller has the service's REPL surface (submit, stats,
        # shutdown, future-style tickets): serve's loop drives it as it is.
        return _serve_loop(args, cfg, controller)
    finally:
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if server is not None:
            server.close()


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


def _report(args) -> int:
    """``report``: journals of either package as one record list — each
    argument a file, a directory or a glob, each journal's rotated pieces
    stitched back in write order (`obs.merge.group_rotated`), several
    journals merged onto one clock (`obs.merge.merge_records`) — rendered
    as the timeline (`utils.events.format_report`), the why-slow verdict
    (``--analyze``, `obs.analyze`) and/or the trace-contract check
    (``--conform``, exit 1 on a violation); ``--chrome-trace`` also writes
    a Perfetto trace.  Torn lines are skipped and counted, never fatal."""
    from dsort_tpu_torch.obs.merge import (
        expand_path_args,
        group_rotated,
        merge_records,
        read_journal_set,
    )
    from dsort_tpu_torch.utils.events import format_report, to_chrome_trace

    try:
        paths = expand_path_args(args.journal)
    except ValueError as e:
        raise SystemExit(f"report: {e}")
    journals, skipped = [], 0
    for group in group_rotated(paths):
        recs, sk = read_journal_set(group)
        journals.append(recs)
        skipped += sk
    records = merge_records(journals) if len(journals) > 1 or args.merge else journals[0]
    if skipped:
        log.warning("skipped %d malformed journal line(s)", skipped)
    rc = 0
    if args.conform:
        from dsort_tpu_torch.analysis.spec.contracts import (
            conformance_report,
            format_conformance,
        )

        conf = conformance_report(records)
        print(format_conformance(conf), end="")
        if not conf["ok"]:
            rc = 1
    if args.analyze or args.analyze_json:
        from dsort_tpu_torch.obs.analyze import analyze_records, format_analysis

        link = args.link_mbps * 1e6 / 8 if args.link_mbps else None
        verdict = analyze_records(records, link_bytes_per_s=link)
        print(format_analysis(verdict), end="")
        if args.analyze_json:
            with open(args.analyze_json, "w", encoding="utf-8") as f:
                json.dump(verdict, f, indent=1)
            log.info("analysis verdict written to %s", args.analyze_json)
    elif not args.conform:
        print(format_report(records), end="")
    if args.chrome_trace:
        with open(args.chrome_trace, "w", encoding="utf-8") as f:
            json.dump(to_chrome_trace(records), f)
        log.info("chrome trace written to %s", args.chrome_trace)
    return rc


def _top(args) -> int:
    """``top``: one (or, with ``--interval``, a refreshing) console view of
    metrics endpoints; several URLs render the per-source view, with the
    unreachable ones named.  Exit 1 when no endpoint answers."""
    from dsort_tpu_torch.obs.top import fetch_metrics, render_fleet, render_top

    urls = args.url or ["http://127.0.0.1:9100/metrics"]
    shown = 0
    while True:
        scrapes, unreachable = [], []
        for url in urls:
            try:
                scrapes.append((url, fetch_metrics(url)))
            except (OSError, ValueError) as e:
                log.error("scrape of %s failed: %s", url, e)
                unreachable.append(url)
        if not scrapes:
            return 1
        if shown:
            print()
        if len(urls) == 1:
            print(f"dsort top — {urls[0]}")
            print(render_top(scrapes[0][1]), end="")
        else:
            print(f"dsort top — {len(scrapes)}/{len(urls)} sources")
            print(render_fleet(scrapes), end="")
            for url in unreachable:
                print(f"  (unreachable: {url})")
        shown += 1
        if args.interval is None or (args.count and shown >= args.count):
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            print()
            return 0


def _journaled(args, run, what: str | None = None) -> int:
    """``run(metrics)`` with the job's journal written to ``args.journal``
    once it ends, also when it failed; logs the wall time and phases of
    ``what`` (default ``INPUT -> OUTPUT``)."""
    from dsort_tpu_torch.utils.metrics import Metrics

    journal = _open_journal(args)
    metrics = Metrics(journal=journal)
    _maybe_memwatch(args, metrics)
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


def _coordinator(args) -> int:
    """``coordinator``: the reference's master loop over a worker cluster."""
    import numpy as np

    from dsort_tpu_torch.data.ingest import read_ints_file, write_ints_file
    from dsort_tpu_torch.runtime import NativeCoordinator
    from dsort_tpu_torch.utils.metrics import Metrics

    cfg = _load_config(args)
    dtype = np.dtype(cfg.job.key_dtype)
    nworkers = args.workers or 4
    with NativeCoordinator(
        port=args.port if args.port is not None else cfg.server_port,
        heartbeat_timeout_s=cfg.job.heartbeat_timeout_s,
    ) as coord:
        log.info("coordinator listening on port %d", coord.port)
        coord.wait_workers(nworkers, timeout_s=args.join_timeout)
        log.info("%d workers joined", nworkers)
        journal = _open_journal(args)
        while True:
            try:
                line = input("Enter the filename to sort (or 'exit' to quit): ")
            except EOFError:
                return 0
            except KeyboardInterrupt:
                # The reference closes its sockets on Ctrl-C (server.c:51-59):
                # leaving the context shuts the cluster down.
                print()
                return 0
            name = line.strip()
            if name == "exit":
                return 0
            if not name:
                continue
            try:
                data = read_ints_file(name, dtype=dtype)
                out = coord.run_job(data, num_shards=nworkers, metrics=Metrics(journal=journal))
                write_ints_file(args.output or cfg.output_path, out)
                log.info("sorted %d keys | live workers %d | reassignments %d",
                         len(data), coord.num_live, coord.reassignments)
            except Exception as e:  # a bad job must not kill the coordinator
                log.error("job failed: %s", e)
            finally:
                # The cluster's fault timeline reaches the disk after every
                # job, failed ones included.
                if journal is not None:
                    journal.flush_jsonl(args.journal)


def _external(args) -> int:
    """``external``: `ExternalSort`, or `ExternalWaveSort` with ``--mesh``."""
    import numpy as np

    # Flags win over the conf's EXTERNAL_* keys, which win over the defaults.
    conf = SortConfig.from_conf_file(args.conf).external if args.conf else ExternalConfig()
    ext = ExternalConfig(
        run_elems=args.run_elems if args.run_elems is not None else conf.run_elems,
        wave_elems=args.wave_elems if args.wave_elems is not None else conf.wave_elems,
        mesh=args.mesh if args.mesh is not None else conf.mesh,
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


def _project_root(start: str) -> str:
    """Nearest ancestor holding the port's package (fallback: ``start``)."""
    d = os.path.abspath(start)
    while True:
        if os.path.isfile(os.path.join(d, "dsort_tpu_torch", "__init__.py")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def _git_changed_files(root: str) -> list[str]:
    """Lintable files changed vs HEAD (worktree + index) plus untracked
    ones, absolute paths.  Loud on any git failure: a broken ``--changed``
    must never pass as "0 files changed"."""
    import subprocess

    from dsort_tpu_torch.analysis.engine import _LINTABLE

    def git(*argv):
        r = subprocess.run(["git", "-C", root, *argv], capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(
                f"lint --changed: git {' '.join(argv)} failed: "
                f"{r.stderr.strip() or r.returncode}"
            )
        return r.stdout.splitlines()

    # --relative anchors diff paths at `root` (not the git toplevel).
    names = set(git("diff", "--name-only", "--relative", "HEAD"))
    names.update(git("ls-files", "--others", "--exclude-standard"))
    return [
        os.path.join(root, name) for name in sorted(names)
        if name.endswith(_LINTABLE) and os.path.exists(os.path.join(root, name))
    ]


def _lint(args) -> int:
    """The port's static analysis (`dsort_tpu_torch.analysis`), the
    reference's ``cmd_lint``: exit 0 clean (modulo baseline), 1 findings.
    It parses the tree and never imports it: no torch, no device."""
    from dsort_tpu_torch.analysis import (
        CACHE_NAME,
        LintStats,
        format_json,
        format_sarif,
        format_text,
        lint_paths,
        load_config,
        write_baseline,
    )

    root = args.root or _project_root(os.getcwd())
    cfg = load_config(root)
    if args.baseline:
        cfg.baseline = args.baseline
    cache_path = None if args.no_cache else os.path.join(root, CACHE_NAME)
    target = os.path.join(root, "dsort_tpu_torch")
    if args.changed:
        if args.paths:
            raise SystemExit("lint: --changed and explicit paths are exclusive")
        if args.write_baseline:
            # The baseline is a whole-tree record: regenerating it from a
            # changed-files subset would drop every tolerated entry of the
            # unchanged files.
            raise SystemExit(
                "lint: --changed and --write-baseline are exclusive "
                "(the baseline must be regenerated from the full tree)"
            )
        # The port's tree only: a touched test fixture is bad by design, and
        # the JAX package has its own linter.
        paths = [p for p in _git_changed_files(root) if p.startswith(target + os.sep)]
        if not paths:
            sys.stdout.write("lint: no changed lintable files\n")
            return 0
    else:
        # User-given paths resolve against the working directory; a missing
        # one is loud — a typo'd invocation must never pass as "0 findings".
        paths = [os.path.abspath(p) for p in args.paths] or [target]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise SystemExit(f"lint: no such path(s): {missing}")
    if args.write_baseline:
        # Capture everything the tree shows now: linting through the old
        # baseline would drop tolerated findings, so regenerating is
        # idempotent.
        path = cfg.abspath(cfg.baseline)
        cfg.baseline = None
        diags = lint_paths(paths, cfg, cache_path=cache_path)
        write_baseline(path, diags)
        log.info("baseline written to %s (%d entries)", path, len(diags))
        return 0
    stats = LintStats() if args.stats else None
    diags = lint_paths(paths, cfg, cache_path=cache_path, stats=stats)
    formatter = {"json": format_json, "sarif": format_sarif}.get(args.format, format_text)
    sys.stdout.write(formatter(diags))
    if stats is not None:
        # stderr, so `--format sarif > out.sarif` stays one SARIF document.
        sys.stderr.write(stats.format())
    return 1 if any(d.severity == "error" for d in diags) else 0


def _spec(args) -> int:
    """The fleet protocol's model checker (`analysis.spec.model`), the
    reference's ``cmd_spec``: ``check`` exits 0 when the explored space
    violates no invariant, 1 on a violation; ``replay`` exits 0 when the
    fixture still reproduces its violation, 1 when it no longer does.  The
    model is control-plane state only: no torch, no device."""
    from dsort_tpu_torch.analysis.spec.model import (
        ModelConfig,
        check_model,
        dump_fixture,
        format_result,
        load_fixture,
        replay_schedule,
    )

    seams = tuple(args.seam or ())
    if args.action == "replay":
        if not args.fixture:
            raise SystemExit("spec replay: --fixture is required")
        schedule, cfg, fseams = load_fixture(args.fixture)
        violation = replay_schedule(schedule, cfg, fseams)
        if violation is None:
            print(f"{args.fixture}: schedule no longer violates anything")
            return 1
        print(f"{args.fixture}: reproduces {violation.invariant} after "
              f"{len(violation.schedule)} action(s): {violation.detail}")
        return 0
    cfg = ModelConfig(n_agents=args.agents, n_jobs=args.jobs,
                      max_duplications=args.duplications, max_deaths=args.deaths,
                      max_crashes=args.crashes)
    result = check_model(cfg, seams=seams, max_states=args.max_states,
                         max_depth=args.max_depth)
    print(format_result(result, seams), end="")
    if result.violation is not None and args.dump_fixture:
        dump_fixture(args.dump_fixture, result.violation, cfg, seams)
        log.info("violation fixture written to %s", args.dump_fixture)
    return 0 if result.ok else 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "lint":
        return _lint(args)
    if args.cmd == "spec":
        return _spec(args)
    if args.cmd == "gen":
        return _gen(args)
    if args.cmd == "validate":
        return _validate(args)
    if args.cmd == "report":
        return _report(args)
    if args.cmd == "top":
        return _top(args)
    if args.cmd == "worker":
        from dsort_tpu_torch.runtime.worker import run as run_worker

        return run_worker(args)
    if args.cmd == "coordinator":
        return _coordinator(args)
    if args.cmd == "bench":
        from dsort_tpu_torch.cli_bench import cmd_bench

        return cmd_bench(args)
    knobs = {"exchange": args.exchange, "hier_hosts": args.hier_hosts,
             "redundancy": args.redundancy, "redundancy_mode": args.redundancy_mode}
    if args.cmd == "external":
        return _external(args)
    if args.cmd == "fleet":
        return _fleet(args, _load_config(args))
    if args.cmd in ("run", "batch", "serve", "fleet-agent"):
        cfg = _load_config(args)
        args.workers = cfg.mesh.num_workers or 8
        if args.cmd == "fleet-agent":
            return _fleet_agent(args, cfg)
        if args.cmd == "run":
            from dsort_tpu_torch.utils.tracing import profile_trace

            # The capture records every thread of the process, the lane
            # threads the job runs on among them.
            with profile_trace(args.profile_dir):
                rc = _run(args, cfg.job)
            if args.profile_dir:
                log.info("profiler trace written to %s", args.profile_dir)
            return rc
        if args.cmd == "serve":
            return _serve(args, cfg)
        args.dp = args.dp or cfg.mesh.dp
        return _batch(args, cfg.job)
    knobs.update(local_kernel=args.kernel, merge_kernel=args.merge_kernel)
    knobs = {k: v for k, v in knobs.items() if v}
    if args.conf:
        # The conf's job keys (EXCHANGE, HIER_HOSTS, ...) under the flags, and
        # EXTERNAL_MESH where --mesh is not given, as the reference reads them.
        import dataclasses

        conf = SortConfig.from_conf_file(args.conf)
        job = dataclasses.replace(conf.job, **knobs)
        if args.mesh is None:
            args.mesh = conf.external.mesh
    else:
        job = JobConfig(**knobs)
    args.workers = args.workers or 8
    if args.external:
        return _terasort_external(args, job)
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    ss = SampleSort(VirtualMesh(args.workers, args.device), job)

    def run(metrics):
        keys, payload = ingest.read_terasort_file(args.input)
        metrics.event("job_start", mode="terasort", n_keys=len(keys))
        sk, sv = ss.sort_kv(
            keys, payload, metrics=metrics, secondary=ingest.terasort_secondary(payload),
            exchange=args.exchange,
        )
        ingest.write_terasort_file(args.output, sk, sv)
        metrics.event("job_done", n_keys=len(keys), counters=dict(metrics.counters))

    return _journaled(args, run)


if __name__ == "__main__":
    sys.exit(main())
