"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one entry of ``workloads``) resolves to its configuration file,
its traffic file, the entry module its configuration names, and a reader
module for each metric it reports.  Nothing here knows a cell, a
configuration or a metric by name: a later benchmark adds one by adding
its files and its manifest entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
MANIFEST = "BENCHMARK.json"


def load_module(path: Path) -> ModuleType:
    """Import the Python file ``path`` on its own (metric names hold dots,
    so readers are loaded by path, not by module name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"sortbench._by_path.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(pkg: Path, metric: str) -> Path:
    """``metrics/<metric>.py``, else ``metrics/<stem>.py`` where ``stem`` is
    the name before its first dot: ``partition_ms.keys`` and
    ``partition_ms.records`` share ``partition_ms.py``."""
    own = pkg / "metrics" / f"{metric}.py"
    return own if own.is_file() else pkg / "metrics" / f"{metric.split('.', 1)[0]}.py"


@dataclasses.dataclass
class Cell:
    """One workload with everything its run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    pkg: Path

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics a run reports: per-layer with a trace, else end to end."""
        return self.per_layer if trace else self.end_to_end

    def entry(self) -> ModuleType:
        return load_module(self.pkg / "entries" / f"{self.config['entry']}.py")

    def generator(self) -> ModuleType:
        return load_module(self.pkg / "traffic" / f"{self.traffic['generator']}.py")

    def readers(self, trace: bool) -> dict[str, ModuleType]:
        return {m["name"]: load_module(reader_path(self.pkg, m["name"]))
                for m in self.metrics(trace)}


def load(root: Path) -> dict:
    with open(Path(root) / MANIFEST, encoding="utf-8") as f:
        return json.load(f)


def cell(root: Path, workload: str, pkg: Path = PKG) -> Cell:
    """The cell ``workload`` of the manifest under ``root``."""
    root = Path(root)
    man = load(root)
    w = next((w for w in man["workloads"] if w["name"] == workload), None)
    if w is None:
        names = ", ".join(x["name"] for x in man["workloads"])
        raise KeyError(f"no workload {workload!r} in {MANIFEST} (have {names})")
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    with open(root / conf["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(pkg / "traffic" / f"{w['traffic']}.json", encoding="utf-8") as f:
        traffic = json.load(f)
    e2e = [m for m in man["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in man["per_layer"]
        if (w["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return Cell(w["name"], int(w["chips"]), config, traffic, e2e, per_layer, pkg)
