"""Shared AST helpers for the checkers (stdlib-only, like everything
in `dsort_tpu_torch.analysis`).  One copy: a fix to callee resolution or scope
walking must not silently diverge between checker modules."""

from __future__ import annotations

import ast


def callee_basename(func: ast.expr) -> str | None:
    """Rightmost name of a call target: ``torch.compile`` -> ``compile``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def own_nodes(fn):
    """Every node of ``fn``'s body that is not inside a nested def (nested
    functions run on other stacks and are scanned as their own scopes)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
