"""Durability-discipline checker for the persisted-state writers.

Counterpart of ``dsort_tpu/analysis/checkers/durability.py``, scoped to the
port's persisted-state writers.

The restart contracts (controller state+spool, checkpoint shards/ranges/
wave runs, flight bundles) all rest on one idiom: write to a tmp name,
fsync, then ``os.replace`` into place — so a reader never sees a torn
file and a rename never publishes bytes the disk may still lose.  The
shapes that break it (a torn non-atomic spool write, persist IO under the
controller lock) are easy to miss by eye; this checker pins them
statically for every future writer.

Codes
  DS701  a write-mode ``open()`` / ``np.save`` targets a final (non-tmp)
         path: a crash mid-write leaves a torn file where recovery
         expects a whole one.  Tmp-shaped targets — a name containing
         ``tmp`` or an expression building a ``".tmp"`` suffix — are the
         sanctioned first half of the idiom.  ``open(path, "wb").close()``
         (the create/truncate "touch") writes no payload and is exempt.
  DS702  ``os.replace``/``os.rename`` publishes a file this function wrote
         with no fsync in between: the rename can land while the data is
         still only in the page cache, so a listed-complete file may be
         empty after power loss.  Any call whose name contains ``fsync``
         (including project fsync helpers) satisfies the idiom.
  DS703  persist IO (write-open, ``np.save``, rename, fsync, journal
         ``flush_jsonl``) while holding a SHARED lock — one acquired in
         two or more functions of the module.  Disk latency must never
         serialize a control plane: snapshot under the lock, write
         outside it.  A dedicated single-function flush lock (the
         seq-guarded flusher pattern) is the sanctioned shape and is not
         flagged; nor does a fence — ``with lock: pass``, which waits out
         a write under way and holds the lock for no work (the port's
         `FleetController.kill`) — make the lock shared.

Static limits, stated so suppressions stay honest: only direct calls in
the inspected function are seen (a helper that writes for a lock-holding
caller is invisible — same doctrine as DS202), and tmp-ness is a naming
convention, not a data-flow proof.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename as _callee_basename
from dsort_tpu_torch.analysis.astutil import own_nodes as _own_nodes
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_WRITE_MODES = ("w", "x", "a")


def _is_write_open(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
        return False
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and any(ch in mode.value for ch in _WRITE_MODES)
    )


def _is_np_save(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == "save"
        and isinstance(f.value, ast.Name)
        and f.value.id in ("np", "numpy")
    )


def _is_rename(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr in ("replace", "rename")
        and isinstance(f.value, ast.Name)
        and f.value.id == "os"
    )


def _is_fsync(call: ast.Call) -> bool:
    name = _callee_basename(call.func)
    return name is not None and "fsync" in name


def _is_persist_io(call: ast.Call) -> bool:
    if _is_write_open(call) or _is_np_save(call) or _is_rename(call):
        return True
    if _is_fsync(call):
        return True
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr == "flush_jsonl"


def _expr_has_tmp(expr: ast.expr) -> bool:
    """True when the expression builds a tmp-shaped path: a name containing
    ``tmp`` or any string piece containing ``.tmp``."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and "tmp" in node.id.lower():
            return True
        if isinstance(node, ast.Attribute) and "tmp" in node.attr.lower():
            return True
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and ".tmp" in node.value
        ):
            return True
    return False


def _target_name(expr: ast.expr) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    return None


class DurabilityChecker(Checker):
    name = "durability"
    codes = {
        "DS701": "raw write to a persisted-state path (no tmp+rename)",
        "DS702": "rename publishes written data without a preceding fsync",
        "DS703": "persist IO while holding a shared lock",
    }
    #: The persisted-state writers.  `utils/events.py` (the journal) is
    #: deliberately out of scope: it is an append-structured log with its
    #: own rotation contract, not recovery state a resume trusts.
    scope = (
        "dsort_tpu_torch/checkpoint.py",
        "dsort_tpu_torch/fleet/*.py",
        "dsort_tpu_torch/serve/*.py",
        "dsort_tpu_torch/models/wave_sort.py",
        "dsort_tpu_torch/models/external_sort.py",
        "dsort_tpu_torch/obs/flight.py",
    )

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        fns = [
            n
            for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        shared_locks = self._shared_locks(ctx, fns)
        for fn in fns:
            diags.extend(self._check_function(ctx, fn, shared_locks))
        return diags

    # -- DS703 lock census ---------------------------------------------------

    def _shared_locks(self, ctx, fns) -> set[tuple]:
        """Lock identities acquired in >= 2 functions of this module (the
        coordination locks persist IO must never run under)."""
        known: set[tuple] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Call)
                and _callee_basename(node.value.func) in _LOCK_FACTORIES
            ):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    known.add(("global", t.id))
                elif isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name
                ):
                    known.add(("attr", t.attr))
        users: dict[tuple, set[str]] = {}
        for fn in fns:
            for node in _own_nodes(fn):
                if not isinstance(node, ast.With) or all(
                    isinstance(st, ast.Pass) for st in node.body
                ):
                    continue
                for item in node.items:
                    lock = self._lock_id(item.context_expr, known)
                    if lock is not None:
                        users.setdefault(lock, set()).add(fn.name)
        return {lock for lock, fns_using in users.items() if len(fns_using) >= 2}

    @staticmethod
    def _lock_id(expr: ast.expr, known: set[tuple]) -> tuple | None:
        if isinstance(expr, ast.Name) and ("global", expr.id) in known:
            return ("global", expr.id)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and ("attr", expr.attr) in known
        ):
            return ("attr", expr.attr)
        return None

    # -- per-function scan ---------------------------------------------------

    def _check_function(self, ctx, fn, shared_locks) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        writes: dict[str, int] = {}  # target name -> first write line
        fsync_lines: list[int] = []
        renames: list[tuple[str | None, int, int]] = []
        # Calls whose result is immediately .close()d write nothing (the
        # create/truncate touch idiom).
        touch_ids = {
            id(node.func.value)
            for node in _own_nodes(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "close"
            and isinstance(node.func.value, ast.Call)
        }
        # File handles bound from a write-open (`with open(tmp, "w") as f:`
        # or `f = open(tmp, "w")`): writes THROUGH the handle (np.save(f),
        # json.dump(..., f)) were already judged at the open site.
        handle_names: set[str] = set()
        for node in _own_nodes(fn):
            if isinstance(node, ast.withitem):
                if (
                    isinstance(node.context_expr, ast.Call)
                    and _is_write_open(node.context_expr)
                    and isinstance(node.optional_vars, ast.Name)
                ):
                    handle_names.add(node.optional_vars.id)
            elif isinstance(node, ast.Assign):
                if (
                    isinstance(node.value, ast.Call)
                    and _is_write_open(node.value)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    handle_names.add(node.targets[0].id)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if _is_write_open(node) or _is_np_save(node):
                target = node.args[0] if node.args else None
                if target is None:
                    continue
                name = _target_name(target)
                if name is not None and name in handle_names and _is_np_save(node):
                    continue  # np.save through an open handle: judged at open
                if name is not None:
                    writes.setdefault(name, node.lineno)
                if id(node) in touch_ids:
                    continue
                if not _expr_has_tmp(target):
                    what = "np.save" if _is_np_save(node) else "open"
                    diags.append(
                        Diagnostic(
                            ctx.relpath, node.lineno, node.col_offset, "DS701",
                            f"{what} writes a persisted-state path directly; "
                            "a crash mid-write leaves a torn file — write a "
                            "tmp name, fsync, then os.replace into place",
                        )
                    )
            elif _is_fsync(node):
                fsync_lines.append(node.lineno)
            elif _is_rename(node):
                src = node.args[0] if node.args else None
                renames.append(
                    (_target_name(src) if src is not None else None,
                     node.lineno, node.col_offset)
                )
        for src_name, line, col in renames:
            if src_name is None or src_name not in writes:
                continue  # renaming something this function did not write
            # The fsync must land BETWEEN this file's write and its rename:
            # an earlier fsync belonging to a previous publish in the same
            # function must not bless a later unsynced one.
            if not any(writes[src_name] <= fl < line for fl in fsync_lines):
                diags.append(
                    Diagnostic(
                        ctx.relpath, line, col, "DS702",
                        f"os.replace publishes {src_name!r} without a "
                        "preceding fsync — the rename can land before the "
                        "data is durable (tmp+fsync+rename)",
                    )
                )
        diags.extend(self._io_under_lock(ctx, fn, shared_locks))
        return diags

    def _io_under_lock(self, ctx, fn, shared_locks) -> list[Diagnostic]:
        diags: list[Diagnostic] = []

        def flag(node, held):
            label = held[1] if held[0] == "global" else f"self.{held[1]}"
            diags.append(
                Diagnostic(
                    ctx.relpath, node.lineno, node.col_offset, "DS703",
                    f"persist IO under shared lock {label}: disk latency "
                    "serializes every other holder — snapshot under the "
                    "lock, write outside it",
                )
            )

        def scan_expr(expr, held):
            if held is None:
                return
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) and _is_persist_io(node):
                    flag(node, held)

        def scan(nodes, held: tuple | None):
            for node in nodes:
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(node, ast.With):
                    inner_held = held
                    for item in node.items:
                        # The context expression itself (e.g. `with
                        # open(tmp, "w") as f:`) evaluates under the OUTER
                        # lock state.
                        scan_expr(item.context_expr, held)
                        lock = self._lock_id(item.context_expr, shared_locks)
                        if lock is not None:
                            inner_held = lock
                    scan(node.body, inner_held)
                    continue
                if isinstance(node, ast.expr):
                    scan_expr(node, held)
                    continue
                # Statements: flag their own expressions, recurse into
                # nested statement blocks (if/for/try bodies keep the
                # current lock state).
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.expr):
                        scan_expr(child, held)
                    elif isinstance(child, (ast.stmt, ast.excepthandler)):
                        scan([child], held)

        scan(fn.body, None)
        return diags
