"""Concurrency-discipline checker for the lock-protected hot structures.

Counterpart of ``dsort_tpu/analysis/checkers/concurrency.py``, its own copy.

The reference's liveness array is read/written by every thread with no lock
(SURVEY.md §5.2 calls the race out); the rebuild's `WorkerTable`, `Metrics`,
`EventLog`, lane registries and C++-mirror host state are lock-protected
by construction — but nothing verified that every NEW mutation site kept the
discipline.  This checker infers each class's (and module's) lock-guarded
state and flags drift:

  DS201  a lock-guarded attribute (one that is mutated under ``with lock:``
         somewhere) is mutated OUTSIDE any lock block (``__init__``/module
         top level excluded — single-threaded construction)
  DS202  a blocking call (``sleep``/``join``/``recv``/``wait``/subprocess
         waits/``accept``/``select``/``input``) is made while holding a
         lock — the shape that turns one slow worker into a stalled
         scheduler.  ``.wait()`` on the held object itself (the condition-
         variable pattern) is allowed.
  DS203  two locks are acquired in both nesting orders in one module — the
         classic ABBA deadlock

Static inference has limits, stated here so suppressions stay honest: only
DIRECT calls inside a ``with`` block are seen (a helper that sleeps while
its caller holds a lock is invisible), and "mutation" means assignment,
augmented assignment, ``del``, or calling a known mutator method
(``append``/``pop``/``update``/...) on the attribute.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext

#: Expressions whose call constructs a lock-like object.
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: Method names that mutate their receiver in place.
_MUTATORS = {
    "append", "extend", "insert", "add", "discard", "remove", "clear",
    "update", "pop", "popleft", "popitem", "appendleft", "setdefault",
}

#: Callee names that block the calling thread.
_BLOCKING_ATTRS = {
    "sleep", "join", "recv", "recv_into", "accept", "wait", "wait_for",
    "communicate", "select",
}
_BLOCKING_NAMES = {"input", "sleep"}
_BLOCKING_DOTTED = {
    ("time", "sleep"), ("select", "select"), ("subprocess", "run"),
    ("subprocess", "call"), ("subprocess", "check_call"),
    ("subprocess", "check_output"),
}


def _is_lock_factory(value: ast.expr) -> bool:
    """True for ``threading.Lock()`` / ``Lock()`` / ``field(default_factory=
    threading.Lock)`` shapes."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    if name in _LOCK_FACTORIES:
        return True
    if name == "field":  # dataclasses.field(default_factory=threading.Lock)
        for kw in value.keywords:
            if kw.arg == "default_factory":
                g = kw.value
                gname = (
                    g.attr if isinstance(g, ast.Attribute)
                    else getattr(g, "id", None)
                )
                if gname in _LOCK_FACTORIES:
                    return True
    return False


def _expr_lock_id(
    expr: ast.expr, self_name: str | None, known: set, owner: str | None
) -> tuple | None:
    """Resolve a ``with`` context expression to a known lock identity.

    ``("attr", owner_class, name)`` for ``self.<name>`` — qualified by the
    owning class so two classes' same-named locks (every class calls its
    lock ``_lock``) never alias in the DS203 order graph; ``("global",
    name)`` for a module-level lock.  None when the expression is no known
    lock.
    """
    if (
        self_name is not None
        and isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == self_name
        and ("attr", owner, expr.attr) in known
    ):
        return ("attr", owner, expr.attr)
    if isinstance(expr, ast.Name) and ("global", expr.id) in known:
        return ("global", expr.id)
    return None


def _lock_label(lock: tuple) -> str:
    return lock[1] if lock[0] == "global" else f"self.{lock[2]}"


def _mutation_roots(node: ast.stmt, self_name: str | None, declared: set[str]):
    """Yield ``(kind, name, anchor)`` for state mutated by one statement.

    kind is "attr" (``self.<name>`` or a mutator-method call on it) or
    "global" (module-level name).  A bare-name rebind (``x = ...``) only
    counts as a global mutation when the function declared ``global x`` —
    otherwise it is a local variable.  Only the statement's own
    targets/calls are inspected — nested statements get their own visit.
    """

    def root(expr):
        # Peel subscripts: self.x[i] mutates x; NAME[i] mutates NAME.
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        if (
            self_name is not None
            and isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == self_name
        ):
            return ("attr", expr.attr, expr)
        if isinstance(expr, ast.Name):
            return ("global", expr.id, expr)
        return None

    targets: list[ast.expr] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    for t in targets:
        for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
            r = root(el)
            if r is None:
                continue
            if r[0] == "global" and isinstance(el, ast.Name):
                if el.id in declared:  # plain rebinds are locals otherwise
                    yield r
            else:
                yield r
    # Mutator-method calls in SIMPLE statements only: compound statements
    # (if/for/try) carry nested statement lists whose own visits would
    # double-report anything found by walking them from here.
    if isinstance(
        node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr,
               ast.Return, ast.Delete)
    ):
        for call in ast.walk(node):
            if (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in _MUTATORS
            ):
                r = root(call.func.value)
                if r:
                    yield r


def _blocking_call(call: ast.Call, held_exprs: list[ast.expr]) -> str | None:
    """Name of the blocking operation if ``call`` blocks, else None."""
    f = call.func
    if isinstance(f, ast.Name) and f.id in _BLOCKING_NAMES:
        return f.id
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and (f.value.id, f.attr) in _BLOCKING_DOTTED:
            return f"{f.value.id}.{f.attr}"
        if f.attr in _BLOCKING_ATTRS:
            # Condition-variable pattern: obj.wait() while holding obj.
            for held in held_exprs:
                if ast.dump(f.value) == ast.dump(held):
                    return None
            return f.attr
    return None


class _ScopeScan(ast.NodeVisitor):
    """Scan one function body tracking the stack of held locks."""

    def __init__(self, checker, ctx, self_name, known_locks, fn_name, sink,
                 declared=(), owner=None):
        self.checker = checker
        self.ctx = ctx
        self.self_name = self_name
        self.known = known_locks
        self.fn_name = fn_name
        self.sink = sink  # records (event, payload) tuples
        self.declared = set(declared)  # names under a `global` statement
        self.owner = owner  # owning class name for attr locks
        self.held: list[tuple] = []  # lock ids, outermost first
        self.held_exprs: list[ast.expr] = []

    # Nested defs run on other stacks (threads/late calls): their bodies are
    # scanned as separate scopes by the checker, not under this lock stack.
    def visit_FunctionDef(self, node):  # noqa: N802
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        return

    def visit_With(self, node):  # noqa: N802
        acquired = []
        for item in node.items:
            lock = _expr_lock_id(
                item.context_expr, self.self_name, self.known, self.owner
            )
            if lock is not None:
                for outer in self.held:
                    self.sink.append(
                        ("order", (outer, lock, self.ctx.relpath,
                                   item.context_expr.lineno))
                    )
                self.held.append(lock)
                self.held_exprs.append(item.context_expr)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()
            self.held_exprs.pop()

    def visit_Call(self, node):  # noqa: N802
        if self.held:
            op = _blocking_call(node, self.held_exprs)
            if op is not None:
                self.sink.append(
                    ("blocking", (op, self.held[-1], node.lineno,
                                  node.col_offset))
                )
        self.generic_visit(node)

    def generic_visit(self, node):
        if isinstance(node, ast.stmt):
            for kind, name, anchor in _mutation_roots(
                node, self.self_name, self.declared
            ):
                self.sink.append(
                    ("mutation", (kind, name, bool(self.held),
                                  anchor.lineno, anchor.col_offset,
                                  self.fn_name))
                )
        super().generic_visit(node)


class ConcurrencyChecker(Checker):
    name = "concurrency"
    codes = {
        "DS201": "lock-guarded attribute mutated outside its lock",
        "DS202": "blocking call while holding a lock",
        "DS203": "inconsistent lock acquisition order (ABBA)",
    }
    scope = ("*.py",)

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        order_edges: dict[tuple, tuple] = {}  # (A, B) -> first location
        module_locks = {
            ("global", t.id)
            for node in ctx.tree.body
            if isinstance(node, ast.Assign) and _is_lock_factory(node.value)
            for t in node.targets
            if isinstance(t, ast.Name)
        }
        # Module-level functions form one scope over the module locks;
        # each class forms a scope over self-attribute locks + module locks.
        scopes: list[tuple[list[ast.FunctionDef], set, str | None]] = []
        mod_fns = [
            n for n in ctx.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        scopes.append((mod_fns, module_locks, None))
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                scopes.append(self._class_scope(node, module_locks))
        for fns, locks, owner in scopes:
            diags.extend(
                self._scan_scope(ctx, fns, locks, owner, order_edges)
            )
        return diags

    def _class_scope(self, cls: ast.ClassDef, module_locks):
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        locks = set(module_locks)
        for stmt in cls.body:  # dataclass-style class-level lock fields
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                if (stmt.value is not None and _is_lock_factory(stmt.value)):
                    locks.add(("attr", cls.name, stmt.target.id))
        for m in methods:  # self.<x> = threading.Lock() anywhere
            self_name = m.args.args[0].arg if m.args.args else None
            if self_name is None:
                continue
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == self_name
                        ):
                            locks.add(("attr", cls.name, t.attr))
        return methods, locks, cls.name

    def _scan_scope(self, ctx, fns, locks, owner, order_edges):
        diags: list[Diagnostic] = []
        events: list[tuple] = []
        for fn in fns:
            self_name = (
                fn.args.args[0].arg if owner is not None and fn.args.args
                else None
            )
            declared = {
                name
                for n in ast.walk(fn)
                if isinstance(n, ast.Global)
                for name in n.names
            }
            scan = _ScopeScan(self, ctx, self_name, locks, fn.name, events,
                              declared, owner)
            for stmt in fn.body:
                scan.visit(stmt)
            # Nested function bodies (worker loops, closures) scan as their
            # own scopes: same guarded-attribute rules, fresh lock stack.
            inner = [
                n for outer in fn.body for n in ast.walk(outer)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            for g in inner:
                gscan = _ScopeScan(self, ctx, self_name, locks, fn.name,
                                   events, declared, owner)
                for stmt in g.body:
                    gscan.visit(stmt)
        guarded = {
            (k, n)
            for ev, p in events
            if ev == "mutation"
            for k, n, under, _l, _c, fname in [p]
            if under and fname not in ("__init__", "__new__")
        }
        for ev, p in events:
            if ev == "mutation":
                k, n, under, line, col, fname = p
                if (
                    not under
                    and (k, n) in guarded
                    and fname not in ("__init__", "__new__")
                ):
                    what = f"self.{n}" if k == "attr" else n
                    diags.append(
                        Diagnostic(
                            ctx.relpath, line, col, "DS201",
                            f"{what} is lock-guarded elsewhere but mutated "
                            f"here without holding the lock",
                        )
                    )
            elif ev == "blocking":
                op, lock, line, col = p
                diags.append(
                    Diagnostic(
                        ctx.relpath, line, col, "DS202",
                        f"blocking call {op!r} while holding {_lock_label(lock)}",
                    )
                )
            elif ev == "order":
                outer, inner_lock, rel, line = p
                key = (outer, inner_lock)
                rkey = (inner_lock, outer)
                if rkey in order_edges:
                    diags.append(
                        Diagnostic(
                            rel, line, 0, "DS203",
                            f"locks {_lock_label(outer)} and "
                            f"{_lock_label(inner_lock)} are acquired in both "
                            f"orders (other order at line {order_edges[rkey]});"
                            " pick one global order",
                        )
                    )
                order_edges.setdefault(key, line)
        return diags
