"""Lint-engine core: diagnostics, suppressions, baseline, configuration.

Counterpart of ``dsort_tpu/analysis/core.py``, its own copy.  A
`Diagnostic` is one finding — stable ``code`` (``DSxxx``), severity,
file/line/column span, message.  Suppression is per-line (``# dsort:
ignore[DS201]`` in Python, ``// dsort: ignore[...]`` in C++ — bare
``ignore`` silences every code on that line).  The baseline records
findings tolerated for now; matching ignores line numbers so unrelated
edits above a baselined site do not resurrect it.  The port's baseline
(`BASELINE`) ships EMPTY.

The port keeps its configuration here, in its own package: the enabled
checkers (`ENABLE`), the baseline path (`BASELINE`) and the import-layer
contracts (`LAYERS`).  ``pyproject.toml``'s ``[tool.dsort.lint]`` table
names the JAX package's modules and is never read: both linters run from
the same root, each with its own vocabulary, baseline and result cache.

Everything in the analysis package is stdlib-only (``ast``, ``json``,
``re``): linting a tree never imports torch, numpy or the tree itself.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

#: Severity levels, in increasing order of badness.  ``error`` fails the
#: lint run; ``warning`` is reported but does not affect the exit code.
SEVERITIES = ("warning", "error")


@dataclasses.dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding: a stable code anchored to a source span."""

    path: str  # repo-relative, '/'-separated (stable across platforms)
    line: int  # 1-based
    col: int  # 0-based (ast convention)
    code: str  # "DS101" etc. — see `checkers.checker_catalog`
    message: str
    severity: str = "error"

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
        }

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col + 1}: "
            f"{self.code} [{self.severity}] {self.message}"
        )

    @property
    def baseline_key(self) -> tuple:
        """Line-independent identity: edits above a site must not churn the
        baseline, so only (path, code, message) participate."""
        return (self.path, self.code, self.message)


# -- suppression comments ---------------------------------------------------

#: ``# dsort: ignore`` or ``# dsort: ignore[DS101,DS202]`` (Python), same
#: after ``//`` in C++.  Matching is per physical line.
_SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*dsort:\s*ignore(?:\[(?P<codes>[A-Z0-9, ]+)\])?"
)


def suppressions(source: str) -> dict[int, set[str] | None]:
    """Map of 1-based line -> suppressed codes (None = all codes)."""
    out: dict[int, set[str] | None] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        out[i] = (
            None
            if codes is None
            else {c.strip() for c in codes.split(",") if c.strip()}
        )
    return out


def is_suppressed(diag: Diagnostic, supp: dict[int, set[str] | None]) -> bool:
    codes = supp.get(diag.line, ...)
    if codes is ...:
        return False
    return codes is None or diag.code in codes


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str | None) -> set[tuple]:
    """Baseline keys from a JSON file (missing file = empty baseline)."""
    if not path or not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {
        (e["path"], e["code"], e["message"])
        for e in data.get("entries", [])
    }

def write_baseline(path: str, diags: list[Diagnostic]) -> None:
    entries = [
        {"path": d.path, "code": d.code, "message": d.message}
        for d in sorted(diags)
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1)
        f.write("\n")


# -- configuration ----------------------------------------------------------

#: Every checker of the catalog runs (an empty tuple would mean the same).
ENABLE = (
    "registry", "concurrency", "tracing", "exceptions", "layers",
    "durability", "protocol", "lifecycle", "spec", "spmd", "caps",
)

#: The port's baseline, root-relative; it ships with no entries.
BASELINE = "dsort_tpu_torch/analysis/lint-baseline.json"

#: Import roots no layered module may reach: the port's device stack, the
#: JAX package's and JAX itself.
_NO_BACKEND = ("torch", "jax", "dsort_tpu")

#: Import-layer purity contracts (DS6xx): each module (or ``pkg.*``
#: subtree) must never reach the listed import roots transitively at
#: module import time.  The fleet control plane runs without torch (the
#: ``fleet`` REPL), the planner decides from journaled signals only, the
#: journal/metrics spine rides every process, and the analysis package is
#: stdlib-only — linting never touches a device, not even numpy.
LAYERS = {
    "dsort_tpu_torch.fleet.proto": _NO_BACKEND,
    "dsort_tpu_torch.fleet.controller": _NO_BACKEND,
    "dsort_tpu_torch.serve.policy": _NO_BACKEND,
    "dsort_tpu_torch.serve.admission": _NO_BACKEND,
    "dsort_tpu_torch.serve.fair": _NO_BACKEND,
    "dsort_tpu_torch.serve.variants": _NO_BACKEND,
    "dsort_tpu_torch.obs.plan": _NO_BACKEND,
    "dsort_tpu_torch.utils.events": _NO_BACKEND + ("numpy",),
    "dsort_tpu_torch.utils.metrics": _NO_BACKEND + ("numpy",),
    "dsort_tpu_torch.utils.logging": _NO_BACKEND + ("numpy",),
    "dsort_tpu_torch.utils.tracing": _NO_BACKEND + ("numpy",),
    "dsort_tpu_torch.analysis.*": _NO_BACKEND + ("numpy",),
}

#: Where `LAYERS` is declared: a DS602 (a contract naming no module)
#: anchors here.
LAYERS_SOURCE = "dsort_tpu_torch/analysis/core.py"


@dataclasses.dataclass
class LintConfig:
    """Engine configuration.

    ``root`` anchors every relative path: scope globs match against
    root-relative file paths, and the ``*_path`` fields default to the
    port's own registry sources so the registry checkers read THE
    vocabulary, not a copy.  ``layers`` maps a module pattern (``pkg.mod``
    or ``pkg.sub.*``) to the import roots that module must never reach
    (`LAYERS` for the shipped tree).
    """

    root: str = "."
    enable: tuple[str, ...] = ()  # empty = every registered checker
    baseline: str | None = None
    registry_path: str = "dsort_tpu_torch/utils/events.py"
    native_map_path: str = "dsort_tpu_torch/runtime/native.py"
    proto_registry_path: str = "dsort_tpu_torch/fleet/proto.py"
    admission_registry_path: str = "dsort_tpu_torch/serve/admission.py"
    spec_registry_path: str = "dsort_tpu_torch/analysis/spec/machines.py"
    contracts_registry_path: str = "dsort_tpu_torch/analysis/spec/contracts.py"
    spmd_registry_path: str = "dsort_tpu_torch/analysis/spmd/registry.py"
    layers: dict = dataclasses.field(default_factory=dict)

    def abspath(self, rel: str | None) -> str | None:
        if rel is None:
            return None
        return rel if os.path.isabs(rel) else os.path.join(self.root, rel)


def load_config(root: str) -> LintConfig:
    """The shipped tree's configuration, anchored at ``root``."""
    return LintConfig(
        root=root, enable=ENABLE, baseline=BASELINE, layers=dict(LAYERS)
    )
