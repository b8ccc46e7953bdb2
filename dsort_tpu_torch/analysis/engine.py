"""The lint engine: file discovery, checker dispatch, output formats.

Counterpart of ``dsort_tpu/analysis/engine.py``, its own copy.
`lint_paths` walks the requested files/directories, parses each Python file
once, hands every file to the checkers whose scope matches, and filters the
findings through per-line suppressions and the baseline.  Checkers are
plain classes registered in `dsort_tpu_torch.analysis.checkers`; the engine
knows nothing about individual rules.

The project registries (event types / counters in ``utils/events.py``, the
native event map in ``runtime/native.py``) are read by PARSING their source,
not importing it: the linter must see exactly what is written in the tree it
checks (an out-of-date installed copy must not mask drift), and checking a
tree must never import torch or touch a device.

The per-file result cache (`ResultCache`) of the port lives in its own file
(`CACHE_NAME`), apart from the JAX package's ``.lint-cache.json``: both
linters run from one root, and neither run may invalidate the other's.
"""

from __future__ import annotations

import ast
import fnmatch
import hashlib
import json
import os

from dsort_tpu_torch.analysis.core import (
    Diagnostic,
    LintConfig,
    is_suppressed,
    load_baseline,
    suppressions,
)


class FileContext:
    """Everything checkers may need about one file, parsed once."""

    def __init__(self, path: str, relpath: str, source: str, config: LintConfig):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.config = config
        self.is_python = relpath.endswith(".py")
        self.tree: ast.AST | None = None
        if self.is_python:
            self.tree = ast.parse(source, filename=path)


class Checker:
    """Base class: subclasses set `name`, `codes`, `scope`, and `check`.

    ``scope`` is a tuple of fnmatch globs over repo-relative paths; the
    engine only hands a checker files it matches.  ``codes`` documents every
    diagnostic the checker can produce (`checkers.checker_catalog`,
    enforced by tests).

    A checker with ``project = True`` works over the whole lint run rather
    than file by file: the engine calls `check_project` ONCE, after the
    per-file phase, with a `ProjectContext` (the DS6xx import-graph pass —
    a layer contract is a property of the tree, not of any one file).
    Project findings skip the per-file result cache (their inputs span
    files) but pass through suppressions and the baseline like any other.
    """

    name: str = ""
    codes: dict[str, str] = {}
    scope: tuple[str, ...] = ("*.py",)
    project: bool = False

    def __init__(self, scope: tuple[str, ...] | None = None):
        # Tests point a checker at fixture trees outside its default scope.
        if scope is not None:
            self.scope = tuple(scope)

    def matches(self, relpath: str) -> bool:
        rel = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rel, pat) for pat in self.scope)

    def check(self, ctx: FileContext) -> list[Diagnostic]:  # pragma: no cover
        raise NotImplementedError

    def check_project(
        self, project: "ProjectContext"
    ) -> list[Diagnostic]:  # pragma: no cover
        raise NotImplementedError


class ProjectContext:
    """What a project-wide checker sees: the run's config, the set of
    repo-relative Python files actually linted, and an on-demand source
    loader (a cross-file pass may need to read files OUTSIDE the linted
    set — e.g. the import closure of a declared-pure module when only one
    changed file was passed)."""

    def __init__(self, config: LintConfig, relpaths: set[str]):
        self.config = config
        self.relpaths = relpaths  # '/'-normalized, root-relative
        self._sources: dict[str, str | None] = {}

    def source(self, relpath: str) -> str | None:
        rel = relpath.replace(os.sep, "/")
        if rel not in self._sources:
            path = self.config.abspath(rel)
            try:
                with open(path, encoding="utf-8", errors="replace") as f:
                    self._sources[rel] = f.read()
            except OSError:
                self._sources[rel] = None
        return self._sources[rel]


# -- project registries, read statically ------------------------------------


def _dict_literal_keys(tree: ast.AST, names: set[str]) -> dict[str, list[str]]:
    """String keys of top-level dict literals assigned to ``names``.

    Matches both plain and annotated assignments (``X: dict[str, str] = {}``).
    """
    out: dict[str, list[str]] = {}
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if (
                isinstance(t, ast.Name)
                and t.id in names
                and isinstance(value, ast.Dict)
            ):
                out[t.id] = [
                    k.value
                    for k in value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                ]
    return out


def _tuple_literal_strs(tree: ast.AST, names: set[str]) -> dict[str, list[str]]:
    """String elements of top-level tuple/list literals assigned to
    ``names`` (the ``ADMISSION_REASONS`` vocabulary shape)."""
    out: dict[str, list[str]] = {}
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if (
                isinstance(t, ast.Name)
                and t.id in names
                and isinstance(value, (ast.Tuple, ast.List))
            ):
                out[t.id] = [
                    e.value
                    for e in value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
    return out


class Registries:
    """Lazily parsed project vocabularies shared by the registry checkers."""

    def __init__(self, config: LintConfig):
        self._config = config
        self._loaded = False
        self.event_types: set[str] = set()
        self.counters: set[str] = set()
        self.native_map: set[str] = set()  # native line names the parser maps
        self.frame_types: set[str] = set()  # fleet wire-protocol vocabulary
        self.admission_reasons: set[str] = set()  # typed verdict vocabulary
        self.missing: list[str] = []  # registry files that could not be read
        self.proto_missing: list[str] = []  # protocol registry files missing

    def _parse(self, relpath: str, sink: list[str]) -> ast.AST | None:
        path = self._config.abspath(relpath)
        if path and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return ast.parse(f.read(), filename=path)
        sink.append(relpath)
        return None

    def load(self) -> "Registries":
        if self._loaded:
            return self
        self._loaded = True
        tree = self._parse(self._config.registry_path, self.missing)
        if tree is not None:
            found = _dict_literal_keys(tree, {"EVENT_TYPES", "COUNTERS"})
            self.event_types = set(found.get("EVENT_TYPES", []))
            self.counters = set(found.get("COUNTERS", []))
        tree = self._parse(self._config.native_map_path, self.missing)
        if tree is not None:
            found = _dict_literal_keys(tree, {"_COORD_EVENT_TYPES"})
            self.native_map = set(found.get("_COORD_EVENT_TYPES", []))
        tree = self._parse(self._config.proto_registry_path, self.proto_missing)
        if tree is not None:
            found = _dict_literal_keys(tree, {"FRAME_TYPES"})
            self.frame_types = set(found.get("FRAME_TYPES", []))
        tree = self._parse(
            self._config.admission_registry_path, self.proto_missing
        )
        if tree is not None:
            found = _tuple_literal_strs(tree, {"ADMISSION_REASONS"})
            self.admission_reasons = set(found.get("ADMISSION_REASONS", []))
        return self


def _spmd_required_files(config: LintConfig) -> list[str]:
    """Repo-relative files the SPMD verifier registry requires contracts
    from (cache-key inputs; empty when the registry is absent/unreadable)."""
    path = config.abspath(config.spmd_registry_path)
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return []
    found = _tuple_literal_strs(tree, {"SPMD_REQUIRED"})
    return found.get("SPMD_REQUIRED", [])


# -- per-file result cache ---------------------------------------------------

#: Bump when the cached-diagnostic shape or engine semantics change.
CACHE_SCHEMA = 1

#: The port's cache file, root-relative (``cli lint``'s default).
CACHE_NAME = ".lint-cache.torch.json"


class ResultCache:
    """Content-hash keyed per-file diagnostic cache (``cli lint`` stays
    interactive on the grown tree).

    One entry per file: sha256 of the source -> the file's post-suppression,
    PRE-baseline diagnostics (suppressions are a function of the content —
    safe to bake in; the baseline can change independently — applied at
    read time).  The whole cache is keyed by a config fingerprint covering
    the checker set (names, codes, scopes), the enabled set, and the
    CONTENT of every registry source the per-file checkers read — editing
    ``events.py`` must invalidate every cached registry finding.  Project-
    wide (cross-file) checkers never cache: their inputs span files.
    """

    def __init__(self, path: str, config: LintConfig, checkers: list):
        self.path = path
        self._root = config.root
        self._key = self._config_key(config, checkers)
        self._files: dict[str, dict] = {}
        self._dirty = False
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if (
                data.get("schema") == CACHE_SCHEMA
                and data.get("config_key") == self._key
            ):
                self._files = dict(data.get("files", {}))
        except (OSError, json.JSONDecodeError, ValueError):
            pass  # a torn/stale cache regenerates; never fatal

    @staticmethod
    def _config_key(config: LintConfig, checkers: list) -> str:
        h = hashlib.sha256()
        h.update(f"schema={CACHE_SCHEMA}".encode())
        for c in sorted(checkers, key=lambda c: c.name):
            h.update(
                f"{c.name}|{sorted(c.codes)}|{sorted(c.scope)}".encode()
            )
        h.update(repr(sorted(config.enable)).encode())
        # The analysis package's OWN sources participate: a checker bugfix
        # that keeps its name/codes/scope must still invalidate every
        # cached verdict, without anyone remembering to bump CACHE_SCHEMA.
        pkg = os.path.dirname(os.path.abspath(__file__))
        for dirpath, dirnames, names in os.walk(pkg):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS
            )
            for name in sorted(names):
                if name.endswith(".py"):
                    try:
                        with open(os.path.join(dirpath, name), "rb") as f:
                            h.update(hashlib.sha256(f.read()).digest())
                    except OSError:
                        h.update(b"<unreadable>")
        for rel in (
            config.registry_path, config.native_map_path,
            config.proto_registry_path, config.admission_registry_path,
            config.spec_registry_path, config.contracts_registry_path,
            config.spmd_registry_path,
        ):
            path = config.abspath(rel)
            h.update(rel.encode())
            try:
                with open(path, "rb") as f:
                    h.update(hashlib.sha256(f.read()).digest())
            except OSError:
                h.update(b"<missing>")
        # The SPMD verifier proves OTHER modules' closed forms: every file
        # the spmd registry requires a contract from participates in the
        # key, so editing a perm builder or cap ladder in exchange.py
        # invalidates every cached verdict (not just exchange.py's own —
        # ring_kernel.py's layout proof evaluates exchange-derived caps).
        for rel in sorted(_spmd_required_files(config)):
            path = config.abspath(rel)
            h.update(rel.encode())
            try:
                with open(path, "rb") as f:
                    h.update(hashlib.sha256(f.read()).digest())
            except OSError:
                h.update(b"<missing>")
        return h.hexdigest()

    @staticmethod
    def _content_key(source: str) -> str:
        return hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()

    def get(self, relpath: str, source: str) -> list[Diagnostic] | None:
        entry = self._files.get(relpath)
        if entry is None or entry.get("hash") != self._content_key(source):
            return None
        try:
            return [Diagnostic(**d) for d in entry["diags"]]
        except (KeyError, TypeError):
            return None

    def put(self, relpath: str, source: str, diags: list[Diagnostic]) -> None:
        self._files[relpath] = {
            "hash": self._content_key(source),
            "diags": [d.to_dict() for d in diags],
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        # Prune entries whose file is gone: without this the cache grows
        # monotonically across renames/deletes and one-off explicit-path
        # runs.
        root = self._root
        self._files = {
            rel: entry
            for rel, entry in self._files.items()
            if os.path.exists(os.path.join(root, rel.replace("/", os.sep)))
        }
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "schema": CACHE_SCHEMA,
                        "config_key": self._key,
                        "files": self._files,
                    },
                    f,
                )
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass  # the cache is an optimization; a full disk is not fatal


# -- the run ----------------------------------------------------------------

_LINTABLE = (".py", ".cpp", ".cc", ".h", ".hpp")
_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "node_modules"}


def discover(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, names in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
                for name in sorted(names):
                    if name.endswith(_LINTABLE):
                        files.append(os.path.join(dirpath, name))
        elif p.endswith(_LINTABLE):
            files.append(p)
    return files


class LintStats:
    """Per-checker cost/yield accounting for one `lint_paths` run.

    ``checkers`` maps checker name -> ``{"seconds", "findings", "files",
    "project"}`` — wall time inside the checker, pre-baseline finding
    count, files handed to it (0 for a project pass, which runs once), and
    whether it ran as the cross-file phase.  ``files``/``cached`` count the
    run's inputs and cache hits; cache-served files charge no checker time,
    so a warm run's table shows where the cold cost actually lives."""

    def __init__(self):
        self.files = 0
        self.cached = 0
        self.checkers: dict[str, dict] = {}

    def add(self, name: str, seconds: float, findings: int, project: bool):
        row = self.checkers.setdefault(
            name,
            {"seconds": 0.0, "findings": 0, "files": 0, "project": project},
        )
        row["seconds"] += seconds
        row["findings"] += findings
        if not project:
            row["files"] += 1

    def format(self) -> str:
        rows = sorted(
            self.checkers.items(),
            key=lambda kv: -kv[1]["seconds"],
        )
        width = max([len("checker")] + [len(n) for n, _ in rows])
        lines = [
            f"{'checker':<{width}}  {'phase':<7}  {'files':>5}  "
            f"{'findings':>8}  {'seconds':>8}",
        ]
        for name, row in rows:
            phase = "project" if row["project"] else "file"
            files = "-" if row["project"] else str(row["files"])
            lines.append(
                f"{name:<{width}}  {phase:<7}  {files:>5}  "
                f"{row['findings']:>8}  {row['seconds']:>8.3f}"
            )
        total = sum(r["seconds"] for _, r in rows)
        lines.append(
            f"{len(self.checkers)} checker(s), {self.files} file(s) "
            f"({self.cached} cache hit(s)), {total:.3f}s in checkers"
        )
        return "\n".join(lines) + "\n"


def lint_paths(
    paths: list[str],
    config: LintConfig | None = None,
    checkers: list[Checker] | None = None,
    cache_path: str | None = None,
    stats: LintStats | None = None,
) -> list[Diagnostic]:
    """Run ``checkers`` (default: all registered, minus config disables)
    over ``paths``; returns baseline- and suppression-filtered diagnostics
    sorted by (path, line, col, code).  ``cache_path`` enables the
    per-file result cache (the CLI's default; the API default stays
    cache-free so tests and tools are hermetic).  ``stats``, when given,
    is filled with per-checker wall time and finding counts."""
    import time

    from dsort_tpu_torch.analysis.checkers import all_checkers

    config = config or LintConfig()
    if checkers is None:
        checkers = all_checkers()
        if config.enable:
            known = {c.name for c in checkers}
            unknown = sorted(set(config.enable) - known)
            if unknown:
                # A typo'd name would silently disable a checker and let
                # the gate pass vacuously — same doctrine as the CLI's
                # missing-path error.
                raise ValueError(
                    f"lint config enable names unknown checkers "
                    f"{unknown}; known: {sorted(known)}"
                )
            checkers = [c for c in checkers if c.name in config.enable]
    file_checkers = [c for c in checkers if not c.project]
    project_checkers = [c for c in checkers if c.project]
    registries = Registries(config)
    baseline = load_baseline(config.abspath(config.baseline))
    cache = (
        ResultCache(cache_path, config, checkers) if cache_path else None
    )
    diags: list[Diagnostic] = []
    relpaths: set[str] = set()
    for path in discover(paths):
        rel = os.path.relpath(path, config.root)
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        rel_slash = rel.replace(os.sep, "/")
        relpaths.add(rel_slash)
        if stats is not None:
            stats.files += 1
        if cache is not None:
            cached = cache.get(rel_slash, source)
            if cached is not None:
                if stats is not None:
                    stats.cached += 1
                diags.extend(
                    d for d in cached if d.baseline_key not in baseline
                )
                continue
        raw: list[Diagnostic] = []
        try:
            ctx = FileContext(path, rel, source, config)
        except SyntaxError as e:
            raw.append(
                Diagnostic(
                    rel_slash, e.lineno or 1, 0, "DS001",
                    f"syntax error: {e.msg}",
                )
            )
        else:
            ctx.registries = registries  # shared lazily-loaded vocabularies
            supp = suppressions(source)
            for checker in file_checkers:
                if not checker.matches(rel):
                    continue
                t0 = time.perf_counter()
                found = checker.check(ctx)
                if stats is not None:
                    stats.add(
                        checker.name, time.perf_counter() - t0,
                        len(found), project=False,
                    )
                raw.extend(d for d in found if not is_suppressed(d, supp))
        if cache is not None:
            cache.put(rel_slash, source, raw)
        diags.extend(d for d in raw if d.baseline_key not in baseline)
    if project_checkers:
        project = ProjectContext(config, relpaths)
        supp_cache: dict[str, dict] = {}
        for checker in project_checkers:
            t0 = time.perf_counter()
            found = checker.check_project(project)
            if stats is not None:
                stats.add(
                    checker.name, time.perf_counter() - t0,
                    len(found), project=True,
                )
            for d in found:
                if d.path not in supp_cache:
                    src = project.source(d.path)
                    supp_cache[d.path] = suppressions(src) if src else {}
                if (
                    not is_suppressed(d, supp_cache[d.path])
                    and d.baseline_key not in baseline
                ):
                    diags.append(d)
    if cache is not None:
        cache.save()
    # Identical findings collapse (Diagnostic is frozen/hashable): run-wide
    # diagnostics like DS105 anchor on a shared path and report once.
    return sorted(set(diags), key=lambda d: (d.path, d.line, d.col, d.code))


def format_text(diags: list[Diagnostic]) -> str:
    lines = [d.format() for d in diags]
    errors = sum(d.severity == "error" for d in diags)
    lines.append(
        f"dsort lint: {errors} error(s), {len(diags) - errors} warning(s)"
    )
    return "\n".join(lines) + "\n"


def format_json(diags: list[Diagnostic]) -> str:
    return json.dumps([d.to_dict() for d in diags], indent=1) + "\n"


def format_sarif(diags: list[Diagnostic]) -> str:
    """SARIF 2.1.0 log: one run, the full checker catalog as driver rules
    (so code-scanning UIs show rule help even for clean runs), one result
    per diagnostic.  Columns convert to SARIF's 1-based convention; paths
    are already '/'-separated repo-relative URIs."""
    from dsort_tpu_torch.analysis.checkers import checker_catalog

    rules = [
        {
            "id": code,
            "name": code,
            "shortDescription": {"text": desc},
            "properties": {"checker": checker},
        }
        for checker, codes in sorted(checker_catalog().items())
        for code, desc in sorted(codes.items())
    ]
    results = [
        {
            "ruleId": d.code,
            "level": "error" if d.severity == "error" else "warning",
            "message": {"text": d.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": d.path},
                        "region": {
                            "startLine": d.line,
                            "startColumn": d.col + 1,
                        },
                    }
                }
            ],
        }
        for d in diags
    ]
    log = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "dsort-lint",
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(log, indent=1) + "\n"
