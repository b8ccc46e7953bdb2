"""Thread lifecycle checker: no thread, timer or executor outlives its owner.

Counterpart of ``dsort_tpu/analysis/checkers/lifecycle.py``, with DS903
only.  The fleet/serve/obs planes start threads; a non-daemon thread that
is never joined outlives its owner and blocks interpreter exit — the shape
that turns a clean ``cli fleet`` Ctrl-C into a hang.

Codes
  DS903  a thread-like resource leaks past its owner: a
         ``threading.Thread`` created without ``daemon=True`` and never
         ``.join()``ed, a ``threading.Timer`` never ``.cancel()``ed /
         ``.join()``ed / marked daemon, or a ``concurrent.futures``
         executor neither used as a context manager nor ``.shutdown()``
         anywhere in the module

The reference's DS901/DS902 pair every started Pallas remote DMA
(``pltpu.make_async_remote_copy``) with its waits.  The port starts no
asynchronous copy inside a kernel: its ring exchange writes every remote
slot with plain stores inside one launch (``csrc/ring_exchange.cu``), and
no ``csrc`` source issues ``cp.async``, ``memcpy_async`` or a TMA copy.
So the two codes have nothing to read and are not in this catalog
(`checkers.SKIPPED`).

Join detection is module-wide by target name (threads are often created
in ``__init__`` and joined in ``shutdown``); timers pair with
``.cancel()``/``.join()`` or a ``.daemon = True`` attribute set,
executors with a ``with`` block or a module-wide ``.shutdown()``.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename as _callee_basename
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext

_DRAIN_ATTRS = ("join", "cancel", "shutdown")
_EXECUTORS = ("ThreadPoolExecutor", "ProcessPoolExecutor")


class LifecycleChecker(Checker):
    name = "lifecycle"
    codes = {
        "DS903": "thread/timer/executor leaks past its owner",
    }
    scope = ("*.py",)

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        # Module-wide drain census: receivers of .join()/.cancel()/
        # .shutdown() by name and by attribute.
        drains: dict[str, tuple[set[str], set[str]]] = {
            a: (set(), set()) for a in _DRAIN_ATTRS
        }
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DRAIN_ATTRS
            ):
                continue
            names, attrs = drains[node.func.attr]
            recv = node.func.value
            if isinstance(recv, ast.Name):
                names.add(recv.id)
            elif isinstance(recv, ast.Attribute):
                attrs.add(recv.attr)
        # `t.daemon = True` attribute sets (the Timer idiom — Timer's
        # constructor takes no daemon kwarg).
        daemon_names: set[str] = set()
        daemon_attrs: set[str] = set()
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "daemon"
                and isinstance(node.value, ast.Constant)
                and node.value.value is True
            ):
                continue
            recv = node.targets[0].value
            if isinstance(recv, ast.Name):
                daemon_names.add(recv.id)
            elif isinstance(recv, ast.Attribute):
                daemon_attrs.add(recv.attr)
        # Assignment targets per constructor call, and `with Executor()
        # as ex:` context expressions (scope-bounded drain by shape).
        targets: dict[int, ast.expr] = {}
        with_calls: set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                targets[id(node.value)] = node.targets[0]
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_calls.add(id(item.context_expr))

        def drained(target, *attrs_wanted: str) -> bool:
            pools = [drains[a] for a in attrs_wanted]
            if isinstance(target, ast.Name):
                return any(target.id in names for names, _ in pools)
            if isinstance(target, ast.Attribute):
                return any(target.attr in attrs for _, attrs in pools)
            # List-comprehension / loop-built resource sets: any drain
            # call in the module keeps the loose pairing honest.
            return any(names or attrs for names, attrs in pools)

        diags = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _callee_basename(node.func)
            if callee in ("Thread", "Timer"):
                daemon = None
                for kw in node.keywords:
                    if kw.arg == "daemon":
                        daemon = kw.value
                if (
                    daemon is not None
                    and isinstance(daemon, ast.Constant)
                    and daemon.value is True
                ):
                    continue
                target = targets.get(id(node))
                if isinstance(target, ast.Name) and target.id in daemon_names:
                    continue
                if (
                    isinstance(target, ast.Attribute)
                    and target.attr in daemon_attrs
                ):
                    continue
                wanted = ("join",) if callee == "Thread" else ("join", "cancel")
                if drained(target, *wanted):
                    continue
                what = (
                    "thread is neither daemon=True nor joined"
                    if callee == "Thread"
                    else "timer is neither daemon, cancelled, nor joined"
                )
                diags.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS903",
                        f"{what} anywhere in this module: it outlives its "
                        "owner and blocks interpreter exit",
                    )
                )
            elif callee in _EXECUTORS:
                if id(node) in with_calls:
                    continue
                if drained(targets.get(id(node)), "shutdown"):
                    continue
                diags.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS903",
                        f"{callee} is neither used as a context manager nor "
                        ".shutdown() anywhere in this module: its worker "
                        "threads outlive the owner and block interpreter "
                        "exit",
                    )
                )
        return diags
