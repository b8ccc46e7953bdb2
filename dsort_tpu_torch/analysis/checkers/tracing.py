"""Capture-hygiene checker for functions PyTorch compiles or captures.

Counterpart of ``dsort_tpu/analysis/checkers/tracing.py``, whose traced set
is what ``jit`` / ``shard_map`` / ``pallas_call`` trace.  PyTorch's
counterparts run a function's Python once and replay what it recorded:
``torch.compile`` traces it into a graph, ``torch.jit.script`` /
``torch.jit.trace`` into TorchScript, and ``torch.cuda.graph`` /
``torch.cuda.make_graphed_callables`` capture its launches into a CUDA
graph.  A host side effect there does not do what its author meant: it
fires once, at capture (then never again, however many times the graph
replays), or — for journal emits — records an event that claims the card
did work it may never do.

The checker builds each module's CAPTURED SET — functions decorated with
``torch.compile`` (bare or called, or through ``functools.partial``) or
``torch.jit.script``; functions handed to ``torch.compile``,
``torch.jit.script``, ``torch.jit.trace`` or
``torch.cuda.make_graphed_callables`` (directly, via a local alias, or
wrapped in ``functools.partial``); lambdas handed to them inline; the body
of every ``with torch.cuda.graph(...)`` block; plus the transitive closure
over same-module calls — and flags:

  DS301  host side effect under capture: ``print``/``open``/``input``,
         ``time.*`` clock reads, journal/metrics emission (``.emit`` /
         ``.bump`` / ``.event`` / ``.ingest``), logging calls, host
         randomness (``random.*`` / ``np.random.*``), or ``global``/
         ``nonlocal`` declarations

The port's tree uses none of these entry points today, so on the shipped
tree the rule guards future code.  The reference's DS302 (a traced value
in a Pallas grid) has no counterpart: the port's launch geometry is
computed in C++ from tensor shapes (`checkers.SKIPPED`).  Cross-module
calls are not followed (each module is checked on its own terms).
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename as _callee_basename
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext

#: (receiver name, attribute) pairs of the calls that compile or capture
#: their first positional argument: ``torch.compile``, ``torch.jit.script``
#: / ``.trace``, ``torch.cuda.make_graphed_callables``.
_CAPTURE_ENTRY = {
    ("torch", "compile"),
    ("jit", "script"),
    ("jit", "trace"),
    ("cuda", "make_graphed_callables"),
}

#: Context managers whose body is captured: ``torch.cuda.graph(g)``.
_CAPTURE_BLOCKS = {("cuda", "graph")}

#: Receiver attribute calls that emit/journal (side effects under capture).
_EMIT_ATTRS = {"emit", "bump", "event", "ingest"}
_LOG_ATTRS = {"debug", "info", "warning", "error", "exception", "critical"}
_LOG_RECEIVERS = {"log", "logger", "logging"}
_CLOCK_ATTRS = {"time", "monotonic", "perf_counter", "process_time", "sleep"}
_BUILTIN_EFFECTS = {"print", "open", "input"}


def _dotted_tail(func: ast.expr) -> tuple[str, str] | None:
    """``(receiver, attr)`` of ``a.b.receiver.attr``, else None."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr, func.attr
    if isinstance(recv, ast.Name):
        return recv.id, func.attr
    return None


def _is_capture_entry(func: ast.expr) -> bool:
    return _dotted_tail(func) in _CAPTURE_ENTRY


def _is_partial(call: ast.expr) -> bool:
    return isinstance(call, ast.Call) and _callee_basename(call.func) == "partial"


def _target_of(expr: ast.expr, local_aliases: dict) -> ast.expr | None:
    """Resolve a captured-callable expression to a Name/Lambda if possible."""
    for _ in range(8):
        if _is_partial(expr):
            if not expr.args:
                return None
            expr = expr.args[0]
        elif isinstance(expr, ast.Name) and expr.id in local_aliases:
            expr = local_aliases[expr.id]
        else:
            break
    return expr if isinstance(expr, (ast.Name, ast.Lambda)) else None


def _is_capture_decorator(deco: ast.expr) -> bool:
    """``@torch.compile``, ``@torch.compile(...)``, ``@torch.jit.script``,
    ``@functools.partial(torch.compile, ...)``."""
    if isinstance(deco, ast.Call):
        if _is_partial(deco):
            return bool(deco.args) and _is_capture_entry(deco.args[0])
        return _is_capture_entry(deco.func)
    return _is_capture_entry(deco)


class TracingChecker(Checker):
    name = "tracing"
    codes = {
        "DS301": "host side effect inside a compiled or captured "
                 "(torch.compile / torch.jit / CUDA graph) function",
    }
    scope = ("*.py",)

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        module_fns: dict[str, ast.FunctionDef] = {
            n.name: n
            for n in ast.walk(ctx.tree)
            if isinstance(n, ast.FunctionDef)
        }
        traced: dict[str, ast.FunctionDef] = {}
        # id() -> node: the module-wide and per-function seeding walks both
        # reach inline lambdas; keying by identity reports each once.
        traced_lambdas: dict[int, ast.Lambda] = {}
        blocks: dict[int, ast.With] = {}

        # Seed 1: decorated functions.
        for fn in module_fns.values():
            if any(_is_capture_decorator(d) for d in fn.decorator_list):
                traced[fn.name] = fn

        # Seed 2: callables handed to a capture entry anywhere, and the
        # bodies of capture blocks.  Local aliases (fn = functools.partial(
        # F, ...)) resolve per enclosing function body.
        def seed(owner, local_aliases):
            for node in ast.walk(owner):
                if isinstance(node, ast.With) and any(
                    isinstance(item.context_expr, ast.Call)
                    and _dotted_tail(item.context_expr.func) in _CAPTURE_BLOCKS
                    for item in node.items
                ):
                    blocks[id(node)] = node
                if not (
                    isinstance(node, ast.Call)
                    and _is_capture_entry(node.func)
                    and node.args
                ):
                    continue
                tgt = _target_of(node.args[0], local_aliases)
                if isinstance(tgt, ast.Lambda):
                    traced_lambdas[id(tgt)] = tgt
                elif isinstance(tgt, ast.Name) and tgt.id in module_fns:
                    traced.setdefault(tgt.id, module_fns[tgt.id])

        def simple_assigns(owner) -> dict[str, ast.expr]:
            out: dict[str, ast.expr] = {}
            for node in ast.walk(owner):
                if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name
                ):
                    out.setdefault(node.targets[0].id, node.value)
            return out

        module_aliases = {
            t.id: n.value
            for n in ctx.tree.body
            if isinstance(n, ast.Assign)
            for t in n.targets
            if isinstance(t, ast.Name)
        }
        seed(ctx.tree, module_aliases)
        for fn in module_fns.values():
            # Re-seed with the function's OWN aliases so a local
            # `f = functools.partial(step, ...)` resolves correctly even
            # when another function reuses the name for something else.
            seed(fn, {**module_aliases, **simple_assigns(fn)})

        # Transitive closure over same-module calls from captured code.
        work = list(traced.values()) + list(blocks.values())
        while work:
            owner = work.pop()
            for node in ast.walk(owner):
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name
                ):
                    callee = module_fns.get(node.func.id)
                    if callee is not None and callee.name not in traced:
                        traced[callee.name] = callee
                        work.append(callee)

        diags: list[Diagnostic] = []
        for name, fn in traced.items():
            diags.extend(self._effects(ctx, fn, f"captured function {name!r}"))
        for lam in traced_lambdas.values():
            diags.extend(self._effects(ctx, lam, "captured lambda"))
        for block in blocks.values():
            for stmt in block.body:
                diags.extend(self._effects(ctx, stmt, "a CUDA graph capture"))
        return diags

    def _effects(self, ctx, fn, label) -> list[Diagnostic]:
        out = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = "global" if isinstance(node, ast.Global) else "nonlocal"
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS301",
                        f"{kind} state mutation inside {label} runs at "
                        "capture time, not per replay",
                    )
                )
            if not isinstance(node, ast.Call):
                continue
            what = self._effect_call(node)
            if what is not None:
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS301",
                        f"{what} inside {label} fires once at capture time "
                        "(and journals capture-time state, not execution)",
                    )
                )
        return out

    @staticmethod
    def _effect_call(node: ast.Call) -> str | None:
        f = node.func
        if isinstance(f, ast.Name) and f.id in _BUILTIN_EFFECTS:
            return f"call to {f.id}()"
        if not isinstance(f, ast.Attribute):
            return None
        recv = f.value
        recv_name = recv.id if isinstance(recv, ast.Name) else None
        if recv_name == "time" and f.attr in _CLOCK_ATTRS:
            return f"clock read time.{f.attr}()"
        if f.attr in _EMIT_ATTRS and recv_name != "self":
            # metrics.event / journal.emit / metrics.bump — journaling.
            return f"journal emission .{f.attr}()"
        if recv_name in _LOG_RECEIVERS and f.attr in _LOG_ATTRS:
            return f"logging call {recv_name}.{f.attr}()"
        if recv_name == "random":
            return f"host randomness random.{f.attr}()"
        if (
            isinstance(recv, ast.Attribute)
            and recv.attr == "random"
            and isinstance(recv.value, ast.Name)
            and recv.value.id in ("np", "numpy")
        ):
            return f"host randomness {recv.value.id}.random.{f.attr}()"
        return None
