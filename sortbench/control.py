"""The control of the comparison: the reference one precision lower, put
in the program's place, has to come out not correct.

    python3 -m sortbench.control --workload W --seeds S [S ...] [--items N]

For each seed it makes the cell's pool of inputs as a run does (on the
card where there is one), answers as many jobs as a run compares with
`reference.control` (the key order taken from a float32 of the key), and
holds them to the run's comparison.  One JSON line a seed: the numbers
compared, their limits, and ``correct`` (false for a sound comparison).
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from sortbench import manifest, reference
from sortbench.run import ANSWER_BYTES, MAX_ANSWERS, ROOT


def control_run(cell, seed: int, device: str, items: int | None = None) -> dict:
    kind = cell.entry().KIND
    pool = cell.generator().make_pool(cell.traffic, cell.config, seed, device, items)
    n = len(pool[0]) if kind == "keys" else len(pool[0][0])
    answers = max(1, min(MAX_ANSWERS, ANSWER_BYTES // (n * int(cell.config["item_bytes"]))))
    uses = Counter(j % len(pool) for j in range(answers))
    wrong = 0
    for i, times in uses.items():
        ref = reference.reference(kind, pool[i], cell.config)
        out = reference.control(kind, pool[i], cell.config)
        wrong += times * reference.mismatched(kind, out, ref, cell.config)
    checks = {f"mismatched_{kind}": {"value": wrong, "limit": 0}}
    return {
        "workload": cell.name, "seed": seed, "items": n, "answers": answers,
        "correct": all(c["value"] <= c["limit"] for c in checks.values()), "checks": checks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sortbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--items", type=int, default=None, help="job size (default: the config's)")
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = manifest.cell(Path(ROOT), args.workload)
    for seed in args.seeds:
        print(json.dumps(control_run(cell, seed, device, args.items)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
