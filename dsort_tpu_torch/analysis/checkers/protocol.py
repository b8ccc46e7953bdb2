"""Protocol/state-machine coverage checker for the fleet wire plane.

Counterpart of ``dsort_tpu/analysis/checkers/protocol.py``, scoped to the
port's fleet and serve planes.

`fleet.proto.FRAME_TYPES` is the wire vocabulary (send_frame refuses
unregistered types at RUNTIME — but only on the path that runs, the DS101
argument all over again), and `serve.admission.ADMISSION_REASONS` is the
typed verdict vocabulary.  This checker moves both guarantees to lint
time, mirroring the DS101-105 registry-coverage design: the registries
are read by PARSING their sources (`fleet/proto.py`,
`serve/admission.py` — configurable as ``proto_registry`` /
``proto_registry_path`` / ``admission_registry_path`` in the lint
config), never imported.

Codes
  DS801  a frame literal — a ``{"type": "x", ...}`` header dict or a
         ``header["type"] == "x"`` / ``.get("type") == "x"`` comparison —
         names a type absent from ``FRAME_TYPES``: the send would raise
         at runtime, the comparison is a dead branch hiding a typo
  DS802  a receive dispatch (an ``==``-chain of two or more arms over a
         frame's ``type``; a lone equality test is a reply guard, not a
         dispatch) covers only part of the registered vocabulary and has
         NO default branch: a frame type added to the registry would be
         silently dropped here (every dispatch must handle or explicitly
         default)
  DS803  an admission-reason literal — ``reason=`` in an `Admission`
         construction, or a comparison against ``.reason`` /
         ``.get("reason")`` — is absent from ``ADMISSION_REASONS``
  DS804  a protocol registry source could not be read (configuration
         error; mirrors DS105)

The frame rules (DS801/DS802) engage only in files that import
``fleet.proto`` — a ``{"type": ...}`` dict in unrelated code (a Chrome
trace event, a JSON schema) is not a frame.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext


def _type_key_expr(expr: ast.expr, key: str) -> bool:
    """True for ``X[key]`` or ``X.get(key, ...)``."""
    if (
        isinstance(expr, ast.Subscript)
        and isinstance(expr.slice, ast.Constant)
        and expr.slice.value == key
    ):
        return True
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "get"
        and bool(expr.args)
        and isinstance(expr.args[0], ast.Constant)
        and expr.args[0].value == key
    )


def _eq_literal(
    test: ast.expr, key: str, aliases: set[str] = frozenset()
) -> str | None:
    """The string literal of a ``X[key] == "lit"`` comparison (or
    ``alias == "lit"`` for a name bound from such an expression — the
    ``ftype = header["type"]`` idiom), else None."""
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Eq)
        and isinstance(test.comparators[0], ast.Constant)
        and isinstance(test.comparators[0].value, str)
    ):
        return None
    left = test.left
    if not (
        _type_key_expr(left, key)
        or (isinstance(left, ast.Name) and left.id in aliases)
    ):
        return None
    return test.comparators[0].value


def _key_aliases(tree: ast.AST, key: str) -> set[str]:
    """Names assigned from ``X[key]`` / ``X.get(key)`` anywhere in the
    module (the local rebind every dispatch loop uses)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and _type_key_expr(node.value, key)
        ):
            out.add(node.targets[0].id)
    return out


class ProtocolChecker(Checker):
    name = "protocol"
    codes = {
        "DS801": "frame type not registered in fleet.proto.FRAME_TYPES",
        "DS802": "receive dispatch misses registered frame types with no "
                 "default branch",
        "DS803": "admission reason not registered in "
                 "serve.admission.ADMISSION_REASONS",
        "DS804": "protocol registry source unreadable",
    }
    scope = ("dsort_tpu_torch/fleet/*.py", "dsort_tpu_torch/serve/*.py")

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        regs = ctx.registries.load()
        diags = [
            Diagnostic(miss.replace("\\", "/"), 1, 0, "DS804",
                       "cannot read protocol registry source (check the "
                       "lint config's proto_registry_path/"
                       "admission_registry_path)")
            for miss in regs.proto_missing
        ]
        if self._imports_proto(ctx):
            diags.extend(self._check_frames(ctx, regs))
        diags.extend(self._check_reasons(ctx, regs))
        return diags

    @staticmethod
    def _imports_proto(ctx: FileContext) -> bool:
        # The registry definition module itself only *defines* the types.
        if ctx.relpath == ctx.config.proto_registry_path.replace("\\", "/"):
            return False
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module and "fleet.proto" in node.module:
                    return True
            elif isinstance(node, ast.Import):
                if any("fleet.proto" in a.name for a in node.names):
                    return True
        return False

    # -- DS801 / DS802 -------------------------------------------------------

    def _check_frames(self, ctx, regs) -> list[Diagnostic]:
        if not regs.frame_types:
            return []
        out: list[Diagnostic] = []
        aliases = _key_aliases(ctx.tree, "type")
        chain_members: set[int] = set()  # If nodes consumed as elif arms
        for node in ast.walk(ctx.tree):
            # Header dict literals: {"type": "x", ...}
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (
                        isinstance(k, ast.Constant) and k.value == "type"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                        and v.value not in regs.frame_types
                    ):
                        out.append(
                            Diagnostic(
                                ctx.relpath, v.lineno, v.col_offset, "DS801",
                                f"frame type {v.value!r} is not registered "
                                f"in {ctx.config.proto_registry_path}",
                            )
                        )
            # == comparisons (chain arms handled below; lone compares too).
            elif isinstance(node, ast.Compare):
                lit = _eq_literal(node, "type", aliases)
                if lit is not None and lit not in regs.frame_types:
                    out.append(
                        Diagnostic(
                            ctx.relpath, node.lineno, node.col_offset,
                            "DS801",
                            f"comparison against unregistered frame type "
                            f"{lit!r} is a dead branch (not in "
                            f"{ctx.config.proto_registry_path})",
                        )
                    )
            # Dispatch chains: if t == "a": ... elif t == "b": ... [else]
            elif isinstance(node, ast.If) and id(node) not in chain_members:
                handled: list[str] = []
                cur: ast.If | None = node
                has_default = False
                while cur is not None:
                    lit = _eq_literal(cur.test, "type", aliases)
                    if lit is None:
                        # A non-frame test inside the chain acts as a
                        # default arm (it can route anything else).
                        has_default = bool(handled)
                        break
                    handled.append(lit)
                    if len(cur.orelse) == 1 and isinstance(
                        cur.orelse[0], ast.If
                    ):
                        cur = cur.orelse[0]
                        chain_members.add(id(cur))
                    else:
                        has_default = bool(cur.orelse)
                        cur = None
                # A dispatch is a chain of >= 2 arms; a lone equality test
                # is a guard (e.g. checking one expected reply type), not a
                # coverage surface.
                if len(handled) >= 2 and not has_default:
                    missing = sorted(
                        set(regs.frame_types) - set(handled)
                    )
                    if missing:
                        out.append(
                            Diagnostic(
                                ctx.relpath, node.lineno, node.col_offset,
                                "DS802",
                                "receive dispatch handles "
                                f"{sorted(set(handled))} but registered "
                                f"frame types {missing} fall through "
                                "silently; add the arms or an explicit "
                                "default (else) branch",
                            )
                        )
        return out

    # -- DS803 ---------------------------------------------------------------

    def _check_reasons(self, ctx, regs) -> list[Diagnostic]:
        if not regs.admission_reasons:
            return []
        # The vocabulary module itself only *defines* the reasons.
        if ctx.relpath == ctx.config.admission_registry_path.replace("\\", "/"):
            return []
        out: list[Diagnostic] = []
        for node in ast.walk(ctx.tree):
            lit = None
            if isinstance(node, ast.Compare) and len(node.ops) == 1:
                if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                    left, right = node.left, node.comparators[0]
                    is_reason = (
                        isinstance(left, ast.Attribute)
                        and left.attr == "reason"
                    ) or _type_key_expr(left, "reason")
                    if (
                        is_reason
                        and isinstance(right, ast.Constant)
                        and isinstance(right.value, str)
                    ):
                        lit = right.value
            elif isinstance(node, ast.Call):
                callee = node.func
                name = (
                    callee.attr if isinstance(callee, ast.Attribute)
                    else getattr(callee, "id", None)
                )
                if name == "Admission":
                    if len(node.args) >= 2 and isinstance(
                        node.args[1], ast.Constant
                    ) and isinstance(node.args[1].value, str):
                        lit = node.args[1].value
                    for kw in node.keywords:
                        if (
                            kw.arg == "reason"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)
                        ):
                            lit = kw.value.value
            if lit is not None and lit not in regs.admission_reasons:
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS803",
                        f"admission reason {lit!r} is not registered in "
                        f"{ctx.config.admission_registry_path}",
                    )
                )
        return out
