"""Command line: ``python -m dsort_tpu_torch.cli run INPUT -o OUTPUT``.

Counterpart of ``dsort run`` in the default SPMD mode: read one int per
line, sort with `SampleSort` over a `VirtualMesh` of ``--workers`` shards,
write one int per line.  Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsort_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="sort a one-int-per-line text file")
    run.add_argument("input")
    run.add_argument("-o", "--output", default="output.txt")
    run.add_argument("--workers", type=int, default=8, help="virtual mesh shards")
    run.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from dsort_tpu_torch.data.ingest import read_ints_file, write_ints_file
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    mesh = VirtualMesh(args.workers, args.device)
    write_ints_file(args.output, SampleSort(mesh).sort(read_ints_file(args.input)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
