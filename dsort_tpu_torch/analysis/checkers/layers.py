"""Import-layer purity checker: declared-pure modules stay device-free.

Counterpart of ``dsort_tpu/analysis/checkers/layers.py``.  The port's
control plane rests on an import-layering contract: the fleet controller
and its wire protocol (`fleet.controller`, `fleet.proto`), the serve
policies and the planner must be importable in a process that never
imports torch (``cli fleet`` runs there), and the analysis package itself
must stay stdlib-only so linting a tree never touches a device.  The
contracts are the `core.LAYERS` table: module patterns and the import
roots they must never reach.  The checker walks the TRANSITIVE
module-level import graph (parent ``__init__`` packages included —
importing ``a.b.c`` executes ``a`` and ``a.b`` first) from every declared
module, reading files from disk on demand so the contract holds even when
only one changed file is linted.  Function-local (lazy) imports are
deliberately out of scope: they are the sanctioned escape hatch
(`obs.prof` imports torch inside its functions).  ``if TYPE_CHECKING:``
blocks never execute and are skipped.

Codes
  DS601  a declared-pure module reaches a forbidden import root at import
         time (the message carries the module chain; anchored at the
         offending import statement)
  DS602  a layer contract's pattern matches no existing module — a
         renamed module must carry its purity contract with it, never
         silently un-declare it
"""

from __future__ import annotations

import ast
import os

from dsort_tpu_torch.analysis.core import LAYERS_SOURCE, Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, ProjectContext


def _is_type_checking(test: ast.expr) -> bool:
    if isinstance(test, ast.Name):
        return test.id == "TYPE_CHECKING"
    if isinstance(test, ast.Attribute):
        return test.attr == "TYPE_CHECKING"
    return False


def _iter_import_stmts(nodes):
    """Import statements that EXECUTE at module import time: top-level and
    inside top-level compound statements (try/if/with/class bodies), but
    never inside function bodies or ``if TYPE_CHECKING:`` guards."""
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If) and _is_type_checking(node.test):
            yield from _iter_import_stmts(node.orelse)
        elif isinstance(node, (ast.stmt, ast.excepthandler)):
            children = [
                c
                for c in ast.iter_child_nodes(node)
                if isinstance(c, (ast.stmt, ast.excepthandler))
            ]
            yield from _iter_import_stmts(children)


class ImportGraph:
    """Module-level import graph over the packages under ``root``.

    Modules resolve as ``root/a/b.py`` or ``root/a/b/__init__.py``; a name
    that resolves nowhere under root is an external leaf (stdlib or third
    party) — leaves are where the forbidden-root check applies, in-tree
    modules are traversed.
    """

    def __init__(self, root: str):
        self.root = root
        self._resolve_cache: dict[str, tuple[str, bool] | None] = {}
        self._imports_cache: dict[str, list[tuple[str, int]] | None] = {}

    def resolve(self, modname: str) -> tuple[str, bool] | None:
        """``(relpath, is_package)`` for an in-tree module, else None."""
        if modname in self._resolve_cache:
            return self._resolve_cache[modname]
        base = os.path.join(self.root, *modname.split("."))
        out = None
        if os.path.isfile(base + ".py"):
            out = (
                os.path.relpath(base + ".py", self.root).replace(os.sep, "/"),
                False,
            )
        elif os.path.isfile(os.path.join(base, "__init__.py")):
            out = (
                os.path.relpath(
                    os.path.join(base, "__init__.py"), self.root
                ).replace(os.sep, "/"),
                True,
            )
        self._resolve_cache[modname] = out
        return out

    def expand(self, pattern: str) -> list[str]:
        """Module names a layers pattern covers: an exact module, or every
        module under a package for a trailing ``.*``."""
        if not pattern.endswith(".*"):
            return [pattern] if self.resolve(pattern) else []
        pkg = pattern[: -len(".*")]
        resolved = self.resolve(pkg)
        if resolved is None or not resolved[1]:
            return []
        out = [pkg]
        pkg_dir = os.path.join(self.root, *pkg.split("."))
        for dirpath, dirnames, names in os.walk(pkg_dir):
            dirnames[:] = sorted(
                d for d in dirnames
                if os.path.isfile(os.path.join(dirpath, d, "__init__.py"))
            )
            relmod = os.path.relpath(dirpath, pkg_dir)
            prefix = pkg if relmod == "." else (
                pkg + "." + relmod.replace(os.sep, ".")
            )
            for name in sorted(names):
                if name == "__init__.py":
                    if prefix != pkg:
                        out.append(prefix)
                elif name.endswith(".py"):
                    out.append(f"{prefix}.{name[:-3]}")
        return sorted(out)

    def module_imports(self, modname: str) -> list[tuple[str, int]] | None:
        """``(imported_dotted_name, line)`` pairs for one module's
        import-time imports (relative imports resolved; ``from X import
        n`` contributes ``X`` plus ``X.n`` when ``X.n`` is a module)."""
        if modname in self._imports_cache:
            return self._imports_cache[modname]
        resolved = self.resolve(modname)
        out: list[tuple[str, int]] | None = None
        if resolved is not None:
            relpath, is_pkg = resolved
            try:
                with open(
                    os.path.join(self.root, relpath.replace("/", os.sep)),
                    encoding="utf-8",
                ) as f:
                    tree = ast.parse(f.read(), filename=relpath)
            except (OSError, SyntaxError):
                tree = None
            if tree is not None:
                out = []
                for stmt in _iter_import_stmts(tree.body):
                    out.extend(self._stmt_targets(stmt, modname, is_pkg))
        self._imports_cache[modname] = out
        return out

    def _stmt_targets(self, stmt, modname: str, is_pkg: bool):
        line = stmt.lineno
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                yield alias.name, line
            return
        # ImportFrom: resolve the (possibly relative) base module.
        parts = modname.split(".")
        if stmt.level:
            # level 1 = the containing package (the module itself, for a
            # package __init__); each further level strips one package.
            anchor = parts if is_pkg else parts[:-1]
            anchor = anchor[: len(anchor) - (stmt.level - 1)]
            base = ".".join(anchor)
            if stmt.module:
                base = f"{base}.{stmt.module}" if base else stmt.module
        else:
            base = stmt.module or ""
        if base:
            yield base, line
        for alias in stmt.names:
            if alias.name == "*":
                continue
            cand = f"{base}.{alias.name}" if base else alias.name
            # `from a.b import c`: c may itself be a submodule.
            if self.resolve(cand) is not None:
                yield cand, line


def _forbidden_root(name: str, forbidden: tuple[str, ...]) -> str | None:
    for f in forbidden:
        if name == f or name.startswith(f + "."):
            return f
    return None


class LayersChecker(Checker):
    name = "layers"
    codes = {
        "DS601": "declared-pure module reaches a forbidden import root "
                 "at import time",
        "DS602": "a layer contract names a module that does not exist",
    }
    scope = ()  # project-wide: the engine calls check_project once per run
    project = True

    def check_project(self, project: ProjectContext) -> list[Diagnostic]:
        config = project.config
        if not config.layers:
            return []
        graph = ImportGraph(config.root)
        diags: list[Diagnostic] = []
        for pattern in sorted(config.layers):
            forbidden = tuple(config.layers[pattern])
            mods = graph.expand(pattern)
            if not mods:
                diags.append(
                    Diagnostic(
                        LAYERS_SOURCE, 1, 0, "DS602",
                        f"layer contract pattern {pattern!r} "
                        "matches no existing module — a renamed module must "
                        "carry its purity contract, not silently shed it",
                    )
                )
                continue
            for mod in mods:
                diags.extend(
                    self._check_module(graph, project, mod, pattern, forbidden)
                )
        return diags

    def _check_module(
        self,
        graph: ImportGraph,
        project: ProjectContext,
        mod: str,
        pattern: str,
        forbidden: tuple[str, ...],
    ) -> list[Diagnostic]:
        # Importing a.b.c executes a and a.b first: seed the closure with
        # the module AND its parent packages.
        parts = mod.split(".")
        seeds = [".".join(parts[: i + 1]) for i in range(len(parts))]
        via: dict[str, str | None] = {}
        queue: list[str] = []
        for s in seeds:
            if graph.resolve(s) is not None and s not in via:
                via[s] = None if s == mod else mod
                queue.append(s)
        findings: list[tuple[str, str, int, str, str]] = []
        closure_files: set[str] = set()
        while queue:
            cur = queue.pop(0)
            resolved = graph.resolve(cur)
            if resolved is None:
                continue
            closure_files.add(resolved[0])
            imports = graph.module_imports(cur)
            if imports is None:
                continue
            for name, line in imports:
                root_hit = _forbidden_root(name, forbidden)
                if root_hit is not None:
                    findings.append((cur, name, line, resolved[0], root_hit))
                    continue
                # Traverse in-tree targets (and their parent packages).
                nparts = name.split(".")
                for i in range(len(nparts)):
                    sub = ".".join(nparts[: i + 1])
                    if graph.resolve(sub) is not None and sub not in via:
                        via[sub] = cur
                        queue.append(sub)
        # The contract is checked when the lint run touches any file of the
        # closure (the whole-tree gate and `--changed` both qualify); a
        # fixture run far from the declared modules stays silent.
        if not (closure_files & project.relpaths):
            return []
        diags = []
        for cur, name, line, relpath, root_hit in findings:
            chain: list[str] = [cur]
            while via.get(chain[-1]):
                chain.append(via[chain[-1]])
            chain = list(reversed(chain))
            hop = " -> ".join(chain + [name])
            diags.append(
                Diagnostic(
                    relpath, line, 0, "DS601",
                    f"layer {pattern!r} forbids importing {root_hit!r}, but "
                    f"{mod} reaches {name!r} at import time ({hop}); move "
                    "the import into the function that needs it or re-layer "
                    "the module",
                )
            )
        return diags
