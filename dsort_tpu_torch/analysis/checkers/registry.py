"""Registry-coverage checker: the event/counter vocabulary cannot drift.

Counterpart of ``dsort_tpu/analysis/checkers/registry.py``, read on the
port's own registries (`LintConfig.registry_path` / ``native_map_path``).

`EventLog.emit` refuses unregistered types at RUNTIME — but only on the
code path that actually runs, which for fault events is exactly the path
that almost never runs (the fault drills exist because of this).  This
checker moves the guarantee to lint time, and extends it across the
language boundary: the C++ coordinator's event lines are scanned out of
``coordinator.cpp`` with a small lexer and resolved against the same
registry plus the Python-side parser map, so a name added on one side
without the other fails ``dsort lint`` before any cluster exists.

Codes (example names single-quoted so the registry-exhaustiveness test's
own source grep — double-quoted literals — never reads this docstring)
  DS101  Python ``.emit('x', ...)`` / ``.event('x', ...)`` /
         ``.ingest(t, mono, 'x', ...)`` name not in ``EVENT_TYPES``
  DS102  Python ``.bump('x', ...)`` name not in ``COUNTERS``
  DS103  C++ ``log_event_locked("x", ...)`` name not in ``EVENT_TYPES``
  DS104  C++ event name missing from ``runtime/native.py``'s
         ``_COORD_EVENT_TYPES`` parser map (the line would be silently
         dropped on drain)
  DS105  a registry source file could not be read (configuration error)
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext
from dsort_tpu_torch.analysis import cpp_lexer

#: Method name -> (positional index of the name argument, registry attr,
#: diagnostic code).  ``ingest`` carries (t, mono, etype, ...).
_EVENT_METHODS = {
    "emit": (0, "event_types", "DS101"),
    "event": (0, "event_types", "DS101"),
    "ingest": (2, "event_types", "DS101"),
    "bump": (0, "counters", "DS102"),
}


class RegistryChecker(Checker):
    name = "registry"
    codes = {
        "DS101": "event type not registered in utils.events.EVENT_TYPES",
        "DS102": "counter name not registered in utils.events.COUNTERS",
        "DS103": "native event name not registered in EVENT_TYPES",
        "DS104": "native event name absent from the drain parser map",
        "DS105": "registry source file unreadable",
    }
    scope = ("*.py", "*.cpp", "*.cc")

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        regs = ctx.registries.load()
        # DS105 anchors on the MISSING REGISTRY path, not the visited file:
        # identical diagnostics collapse in the engine's dedup, so one
        # misconfigured registry_path reports once per run, not per file.
        diags = [
            Diagnostic(miss.replace("\\", "/"), 1, 0, "DS105",
                       "cannot read registry source (check the lint "
                       "config's registry_path/native_map_path)")
            for miss in regs.missing
        ]
        if ctx.is_python:
            diags.extend(self._check_python(ctx, regs))
        else:
            diags.extend(self._check_cpp(ctx, regs))
        return diags

    def _check_python(self, ctx: FileContext, regs) -> list[Diagnostic]:
        # The registry definition module itself only *defines* names.
        if ctx.relpath == ctx.config.registry_path.replace("\\", "/"):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            spec = _EVENT_METHODS.get(node.func.attr)
            if spec is None:
                continue
            idx, attr, code = spec
            if len(node.args) <= idx:
                continue
            arg = node.args[idx]
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                continue  # dynamic names are guarded at runtime by EventLog
            registry = getattr(regs, attr)
            if registry and arg.value not in registry:
                kind = "counter" if attr == "counters" else "event type"
                out.append(
                    Diagnostic(
                        ctx.relpath, arg.lineno, arg.col_offset, code,
                        f"{kind} {arg.value!r} is not registered in "
                        f"{ctx.config.registry_path}",
                    )
                )
        return out

    def _check_cpp(self, ctx: FileContext, regs) -> list[Diagnostic]:
        out = []
        for tok in cpp_lexer.call_string_args(ctx.source, "log_event_locked"):
            if regs.event_types and tok.value not in regs.event_types:
                out.append(
                    Diagnostic(
                        ctx.relpath, tok.line, 0, "DS103",
                        f"native event {tok.value!r} is not registered in "
                        f"{ctx.config.registry_path}",
                    )
                )
            elif regs.native_map and tok.value not in regs.native_map:
                out.append(
                    Diagnostic(
                        ctx.relpath, tok.line, 0, "DS104",
                        f"native event {tok.value!r} is missing from "
                        f"_COORD_EVENT_TYPES in {ctx.config.native_map_path}; "
                        "drained lines of this type would be dropped",
                    )
                )
        return out
