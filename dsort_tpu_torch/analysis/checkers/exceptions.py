"""Recovery-path exception hygiene.

Counterpart of ``dsort_tpu/analysis/checkers/exceptions.py``, scoped to the
port's recovery paths.

The reference detects failure exclusively through error returns (PAPER.md
§5.3 — ``send()/recv() <= 0``); the rebuild routes failures through typed
exceptions, which means one overbroad ``except`` in a recovery path can
silently eat the very signal the fault machinery exists to observe.  On the
files that implement recovery (schedulers, fault classification, checkpoint
store, multihost resume, the CLI's job loops) this checker enforces: catch
narrowly, or visibly account for what you swallowed.

  DS401  bare ``except:`` — also catches ``KeyboardInterrupt``/
         ``SystemExit``; allowed only when the body re-raises
  DS402  ``except Exception``/``BaseException`` whose handler neither
         re-raises, nor returns/continues control flow deliberately
         (``return``/``continue``/``break``), nor reports (journal
         ``.event``/``.emit``/``.bump``, ``log.*``, ``warnings.warn``,
         raising a new error)

``__del__`` bodies are exempt: swallowing during interpreter teardown is
the documented idiom there.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext

_BROAD = {"Exception", "BaseException"}
_REPORT_ATTRS = {
    "emit", "bump", "event", "debug", "info", "warning", "error",
    "exception", "critical", "warn", "print_exc",
}


def _is_broad(type_expr: ast.expr | None) -> bool:
    if type_expr is None:
        return False  # bare except handled separately
    exprs = (
        type_expr.elts if isinstance(type_expr, ast.Tuple) else [type_expr]
    )
    for e in exprs:
        name = e.attr if isinstance(e, ast.Attribute) else getattr(e, "id", None)
        if name in _BROAD:
            return True
    return False


def _handles(handler: ast.ExceptHandler) -> bool:
    """True when the handler visibly deals with the error: re-raises,
    changes control flow on purpose, reports it, or propagates the bound
    exception VALUE somewhere (``box["e"] = e`` — the lane-thread error
    relay pattern)."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Continue, ast.Break)):
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _REPORT_ATTRS
        ):
            return True
        if (
            handler.name is not None
            and isinstance(node, ast.Name)
            and node.id == handler.name
            and isinstance(node.ctx, ast.Load)
        ):
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


class ExceptionsChecker(Checker):
    name = "exceptions"
    codes = {
        "DS401": "bare except in a recovery path",
        "DS402": "overbroad except swallows errors without reporting",
    }
    scope = (
        "dsort_tpu_torch/scheduler/*.py",
        "dsort_tpu_torch/checkpoint.py",
        "dsort_tpu_torch/parallel/distributed.py",
        "dsort_tpu_torch/cli.py",
        "dsort_tpu_torch/runtime/*.py",
    )

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        exempt: set[int] = set()  # handler nodes inside __del__
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef) and node.name == "__del__":
                for inner in ast.walk(node):
                    if isinstance(inner, ast.ExceptHandler):
                        exempt.add(id(inner))
        out: list[Diagnostic] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler) or id(node) in exempt:
                continue
            if node.type is None and not _reraises(node):
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS401",
                        "bare 'except:' in a recovery path catches "
                        "KeyboardInterrupt/SystemExit too; name the "
                        "exception types (and report what you swallow)",
                    )
                )
            elif _is_broad(node.type) and not _handles(node):
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS402",
                        "broad 'except Exception' swallows the error with no "
                        "re-raise, no fault event, and no log — a failure "
                        "here would vanish from the fault timeline",
                    )
                )
        return out
