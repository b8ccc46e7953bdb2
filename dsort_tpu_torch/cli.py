"""Command line: ``python -m dsort_tpu_torch.cli {run,terasort} ...``.

Counterparts of ``dsort run`` in the default SPMD mode and of the in-core
``dsort terasort``, over a `VirtualMesh` of ``--workers`` shards on the GPU
unless ``--device cpu``:

- ``run INPUT -o OUTPUT [--exchange E] [--dtype D] [--journal J]``: one key
  per line in and out, read and written as ``D`` (default int32; signed and
  unsigned ints, and floats through the order-preserving key mapping), as
  ``dsort run --dtype`` reads it.  It sorts through `SpmdScheduler` (failure
  detection, bounded waits, probes, re-form over the survivors), as ``dsort
  run --mode spmd`` does; the reference's fused small-job route (below 2^20
  keys) is not ported yet, so every size goes through the scheduler.
  ``--journal J`` writes the job's `EventLog` as JSONL once the job ends,
  also when it failed;
- ``terasort INPUT -o OUTPUT [--exchange E]``: 100-byte TeraSort records
  through `SampleSort.sort_kv` (the reference's ``cmd_terasort`` does not
  use the scheduler either), ordered by the full 10-byte key (8-byte
  prefix, then key bytes 8-9 as the secondary key — which keeps the
  ``alltoall`` exchange); its keys are always the uint64 prefix, so it
  takes no ``--dtype``, as in the reference.

Both take ``--kernel`` (`JobConfig.local_kernel`) and ``--merge-kernel``
(`JobConfig.merge_kernel`), as the JAX package's common flags do.
"""

from __future__ import annotations

import argparse
import sys

from dsort_tpu_torch.config import _LOCAL_PORTED, _MERGE_PORTED, JobConfig

EXCHANGES = ("alltoall", "ring", "fused")


def _common(p: argparse.ArgumentParser, default_output: str) -> None:
    p.add_argument("input")
    p.add_argument("-o", "--output", default=default_output)
    p.add_argument("--workers", type=int, default=8, help="virtual mesh shards")
    p.add_argument("--exchange", choices=EXCHANGES, default=None,
                   help="bucket exchange schedule (default: JobConfig's)")
    p.add_argument("--kernel", choices=_LOCAL_PORTED, default="auto", help="local sort kernel")
    p.add_argument("--merge-kernel", choices=_MERGE_PORTED, default="auto",
                   help="post-exchange combine (default auto: block_merge wherever "
                        "the block kernel applies)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsort_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="sort a one-int-per-line text file")
    _common(run, "output.txt")
    run.add_argument("--dtype", default="int32",
                     help="key dtype of the file (int32, int64, uint32, uint64, float32, ...)")
    run.add_argument("--journal", default=None,
                     help="write the job's structured event journal (JSONL) here")
    _common(
        sub.add_parser("terasort", help="sort a binary 100-byte-record file"),
        "terasort_out.bin",
    )
    return ap


def _run(args, job: JobConfig) -> int:
    from dsort_tpu_torch.data import ingest
    from dsort_tpu_torch.scheduler import SpmdScheduler
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    sched = SpmdScheduler(args.workers, args.device, job)
    journal = EventLog() if args.journal else None
    try:
        keys = ingest.read_ints_file(args.input, args.dtype)
        metrics = Metrics(journal=journal)
        try:
            out = sched.sort(keys, metrics=metrics, exchange=args.exchange)
        except BaseException as e:
            # The scheduler journals job_failed only on its clean failure
            # path (no live worker); close the job on any other escape too.
            metrics.event(
                "job_failed", reason=(str(e).splitlines() or [repr(e)])[0][:120],
                counters=dict(metrics.counters),
            )
            raise
        metrics.event("result_fetch", n_keys=len(out))
        ingest.write_ints_file(args.output, out)
    finally:
        # The journal exists to answer "what happened": a failed job's
        # fault timeline lands on disk too.
        if journal is not None:
            journal.flush_jsonl(args.journal)
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    job = JobConfig(local_kernel=args.kernel, merge_kernel=args.merge_kernel)
    if args.cmd == "run":
        return _run(args, job)
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
