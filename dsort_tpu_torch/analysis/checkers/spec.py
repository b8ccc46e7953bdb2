"""Spec-plane checker: protocol spec ↔ handler source, trace contracts.

Counterpart of ``dsort_tpu/analysis/checkers/spec.py``: the port's spec
(`analysis/spec/machines.py`) held to the port's fleet handlers, and the
port's trace contracts to its emission sites.

Third-generation registry discipline (after DS1xx events and DS7xx
frames): the declarative protocol spec (`analysis/spec/machines.py`) and
the trace-contract registry (`analysis/spec/contracts.py`) are pure
literals, and this checker holds them and the code to each other — both
ways, by PARSING sources, never importing the linted tree.

DS10xx — spec ↔ handler cross-checks
  DS1001  malformed spec: unknown registry, event outside its registry,
          transition over an undeclared state/event, a covers_registry
          machine missing registry entries, or a spec/contracts source
          that is missing or not a pure literal
  DS1002  handler arm not declared: the dispatch function compares the
          frame type against a registry name the spec does not list as
          handled — code drifted ahead of the spec
  DS1003  declared handled frame has no handler arm — the spec promises
          a dispatch arm the code no longer has (the seeded-drift drill
          deletes one arm and must land here)
  DS1004  silent drop: in a non-terminal state, an event of the
          machine's alphabet has neither a transition nor an explicit
          ``ignorable`` entry — every dropped frame is a decision
  DS1005  obligation not discharged: the named function never calls its
          discharge function, or (``before_send``) the last send of the
          guarded frame type precedes the first discharge call — the
          persist-before-ack class of bug, statically

DS11xx — journal trace contracts
  DS1101  an ``.event(...)``/``.emit(...)`` site emits an `EVENT_TYPES`
          name that no declared contract covers and `CONTRACT_EXEMPT`
          does not exempt
  DS1102  a contract (or exempt) name does not resolve against
          `EVENT_TYPES`, a contract grammar does not compile, or a name
          is both covered and exempt
  DS1103  a hand-rolled trace-sequence literal (>= 4 contract-alphabet
          event names in one list/tuple) — the duplicated-sequence smell
          the contract engine exists to remove; use `assert_conformant`
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import (
    Checker,
    ProjectContext,
    _dict_literal_keys,
    _tuple_literal_strs,
)

#: Attribute calls that journal an event (first positional arg = name).
_EMIT_ATTRS = ("event", "emit")

#: Attribute calls that send a wire frame (DS1005 ``before_send``).
_SEND_ATTRS = ("_send", "send")


def _literal_assign(tree: ast.AST, name: str):
    """``(value, lineno)`` of the pure-literal top-level assignment to
    ``name``, or ``(None, reason)`` when absent or not a literal."""
    for node in ast.walk(tree):
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                try:
                    return ast.literal_eval(value), value.lineno
                except ValueError:
                    return None, f"{name} is not a pure literal"
    return None, f"no top-level {name} assignment"


def _dict_key_lines(tree: ast.AST, name: str) -> dict[str, int]:
    """Top-level key -> lineno for the dict literal assigned to ``name``
    (diagnostic anchors inside a literal_eval'd registry)."""
    for node in ast.walk(tree):
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if (
                isinstance(t, ast.Name)
                and t.id == name
                and isinstance(value, ast.Dict)
            ):
                return {
                    k.value: k.lineno
                    for k in value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                }
    return {}


def _functions_named(tree: ast.AST, name: str) -> list[ast.FunctionDef]:
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name == name
    ]


def _sends_of(fn: ast.AST, frame_type: str) -> list[int]:
    """Line numbers of sends of ``{"type": frame_type, ...}`` in ``fn``."""
    out = []
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.Call)
            and callee_basename(node.func) in _SEND_ATTRS
        ):
            continue
        for arg in node.args:
            if not isinstance(arg, ast.Dict):
                continue
            for k, v in zip(arg.keys, arg.values):
                if (
                    isinstance(k, ast.Constant)
                    and k.value == "type"
                    and isinstance(v, ast.Constant)
                    and v.value == frame_type
                ):
                    out.append(node.lineno)
    return out


class SpecChecker(Checker):
    name = "spec"
    codes = {
        "DS1001": "malformed protocol spec (unknown registry/state/event, "
                  "or a spec source that is missing or not a pure literal)",
        "DS1002": "handler arm not declared in the protocol spec",
        "DS1003": "declared handled frame has no handler arm",
        "DS1004": "frame silently dropped in a reachable state (no "
                  "transition, no ignorable entry)",
        "DS1005": "transition obligation not discharged (missing or "
                  "mis-ordered call)",
        "DS1101": "event emission outside every declared trace contract",
        "DS1102": "trace-contract registry does not resolve (unknown "
                  "event name, non-compiling grammar, covered-and-exempt)",
        "DS1103": "hand-rolled trace-sequence literal; declare it in "
                  "TRACE_CONTRACTS and use the contract engine",
    }
    scope = ("*.py",)
    project = True  # spec ↔ source is a property of the tree

    def check_project(self, project: ProjectContext) -> list[Diagnostic]:
        cfg = project.config
        diags: list[Diagnostic] = []
        spec_rel = cfg.spec_registry_path.replace("\\", "/")
        contracts_rel = cfg.contracts_registry_path.replace("\\", "/")

        spec, spec_tree = self._load_literal(
            project, spec_rel, "PROTOCOL_SPEC", diags
        )
        contracts, contracts_tree = self._load_literal(
            project, contracts_rel, "TRACE_CONTRACTS", diags
        )
        vocabularies = self._vocabularies(project)

        if spec is not None:
            machine_lines = _dict_key_lines(spec_tree, "PROTOCOL_SPEC")
            for mname, machine in spec.items():
                line = machine_lines.get(mname, 1)
                diags.extend(
                    self._check_machine(
                        project, spec_rel, line, mname, machine, vocabularies
                    )
                )

        exempt = None
        if contracts_tree is not None:
            exempt, _ = _literal_assign(contracts_tree, "CONTRACT_EXEMPT")
        if contracts is not None:
            diags.extend(
                self._check_contracts(
                    contracts_rel, contracts_tree, contracts,
                    exempt if isinstance(exempt, tuple) else (),
                    vocabularies.get("EVENT_TYPES", set()),
                )
            )
            diags.extend(
                self._check_emissions(
                    project, contracts,
                    exempt if isinstance(exempt, tuple) else (),
                    vocabularies.get("EVENT_TYPES", set()),
                    spec_rel, contracts_rel,
                )
            )
        return diags

    # -- loading -------------------------------------------------------------

    def _load_literal(self, project, relpath, name, diags):
        src = project.source(relpath)
        if src is None:
            diags.append(
                Diagnostic(
                    relpath, 1, 0, "DS1001",
                    f"spec registry source {relpath!r} not found — the "
                    f"spec plane cannot pass vacuously",
                )
            )
            return None, None
        tree = ast.parse(src, filename=relpath)
        value, where = _literal_assign(tree, name)
        if value is None:
            diags.append(
                Diagnostic(relpath, 1, 0, "DS1001", f"{where} in {relpath}")
            )
            return None, tree
        return value, tree

    def _vocabularies(self, project) -> dict[str, set[str]]:
        """The registry vocabularies, parsed from THIS tree's sources."""
        cfg = project.config
        out: dict[str, set[str]] = {}
        src = project.source(cfg.proto_registry_path.replace("\\", "/"))
        if src is not None:
            found = _dict_literal_keys(ast.parse(src), {"FRAME_TYPES"})
            out["FRAME_TYPES"] = set(found.get("FRAME_TYPES", []))
        src = project.source(cfg.admission_registry_path.replace("\\", "/"))
        if src is not None:
            found = _tuple_literal_strs(ast.parse(src), {"ADMISSION_REASONS"})
            out["ADMISSION_REASONS"] = set(found.get("ADMISSION_REASONS", []))
        src = project.source(cfg.registry_path.replace("\\", "/"))
        if src is not None:
            found = _dict_literal_keys(ast.parse(src), {"EVENT_TYPES"})
            out["EVENT_TYPES"] = set(found.get("EVENT_TYPES", []))
        return out

    # -- DS1001..DS1005 ------------------------------------------------------

    def _check_machine(
        self, project, spec_rel, line, mname, machine, vocabularies
    ) -> list[Diagnostic]:
        diags: list[Diagnostic] = []

        def bad(code, msg, path=spec_rel, at=line):
            diags.append(Diagnostic(path, at, 0, code, f"{mname}: {msg}"))

        registry = machine.get("registry")
        vocab = vocabularies.get(registry)
        if vocab is None:
            bad("DS1001", f"unknown registry {registry!r}")
            return diags
        receives = tuple(machine.get("receives", ()))
        handled = tuple(machine.get("handled", ()))
        replies = tuple(machine.get("replies", ()))
        internal = tuple(machine.get("internal", ()))
        states = tuple(machine.get("states", ()))
        transitions = tuple(machine.get("transitions", ()))
        ignorable = dict(machine.get("ignorable", {}))
        alphabet = set(receives) | set(internal)

        for ev in receives:
            if ev not in vocab:
                bad("DS1001", f"receives {ev!r}, not in {registry}")
        for ev in handled:
            if ev not in receives:
                bad("DS1001", f"handled {ev!r} is not in receives")
        for ev in replies:
            if ev not in vocab:
                bad("DS1001", f"reply frame {ev!r}, not in {registry}")
        for ev in internal:
            if ev in vocab:
                bad("DS1001",
                    f"internal event {ev!r} collides with a {registry} name")
        if machine.get("initial") not in states:
            bad("DS1001", f"initial state {machine.get('initial')!r} "
                          f"not in states")
        if machine.get("covers_registry"):
            missing = sorted(vocab - set(receives))
            if missing:
                bad("DS1001",
                    f"covers_registry but misses {registry} entries "
                    f"{missing}")
        outgoing: dict[str, set[str]] = {s: set() for s in states}
        for row in transitions:
            if len(row) != 4:
                bad("DS1001", f"transition row {row!r} is not "
                              f"(state, event, target, guard)")
                continue
            src, ev, dst, _guard = row
            if src not in states or dst not in states:
                bad("DS1001", f"transition {src!r}-[{ev}]->{dst!r} uses an "
                              f"undeclared state")
            if ev not in alphabet:
                bad("DS1001", f"transition event {ev!r} is neither a "
                              f"received frame nor an internal event")
            outgoing.setdefault(src, set()).add(ev)
        for st, evs in ignorable.items():
            if st not in states:
                bad("DS1001", f"ignorable state {st!r} is undeclared")
            for ev in evs:
                if ev not in alphabet:
                    bad("DS1001", f"ignorable event {ev!r} in {st!r} is "
                                  f"outside the machine alphabet")

        # DS1004: in every non-terminal state, every alphabet event is
        # either transitioned or explicitly ignorable.  A state with no
        # outgoing transitions is terminal (the link/job is gone) and
        # cannot silently drop anything.
        machine_alphabet = {
            row[1] for row in transitions if len(row) == 4
        }
        for st in states:
            if not outgoing.get(st):
                continue
            for ev in sorted(machine_alphabet):
                if ev in outgoing[st]:
                    continue
                if ev in tuple(ignorable.get(st, ())):
                    continue
                bad("DS1004",
                    f"event {ev!r} in state {st!r} has no transition and "
                    f"no ignorable entry — a silent drop")

        # DS1002/DS1003: arms in the dispatch function vs handled.
        handler = machine.get("handler")
        if handler:
            hfile, hfunc = handler
            hfile = hfile.replace("\\", "/")
            src = project.source(hfile)
            if src is None:
                bad("DS1001", f"handler file {hfile!r} not found")
            else:
                htree = ast.parse(src, filename=hfile)
                fns = _functions_named(htree, hfunc)
                if not fns:
                    bad("DS1001",
                        f"handler function {hfunc!r} not found in {hfile}")
                arms: dict[str, int] = {}
                for fn in fns:
                    for node in ast.walk(fn):
                        if not isinstance(node, ast.Compare):
                            continue
                        if not any(
                            isinstance(op, ast.Eq) for op in node.ops
                        ):
                            continue
                        for cmp in [node.left, *node.comparators]:
                            if (
                                isinstance(cmp, ast.Constant)
                                and cmp.value in vocab
                            ):
                                arms.setdefault(cmp.value, cmp.lineno)
                for ev, at in sorted(arms.items()):
                    if ev not in handled:
                        bad("DS1002",
                            f"{hfunc} dispatches frame {ev!r}, which the "
                            f"spec does not declare as handled",
                            path=hfile, at=at)
                for ev in handled:
                    if ev not in arms:
                        at = fns[0].lineno if fns else line
                        bad("DS1003",
                            f"spec declares {ev!r} handled by {hfunc}, but "
                            f"the function has no arm for it",
                            path=hfile, at=at)

        # DS1005: obligations.
        for ob in machine.get("obligations", ()):
            diags.extend(self._check_obligation(project, mname, ob, line,
                                                spec_rel))
        return diags

    def _check_obligation(self, project, mname, ob, line, spec_rel):
        path = str(ob.get("file", "")).replace("\\", "/")
        func = str(ob.get("function", ""))
        must = str(ob.get("must_call", ""))
        before = ob.get("before_send")
        src = project.source(path)
        if src is None:
            return [Diagnostic(
                spec_rel, line, 0, "DS1001",
                f"{mname}: obligation file {path!r} not found",
            )]
        tree = ast.parse(src, filename=path)
        fns = _functions_named(tree, func)
        if not fns:
            return [Diagnostic(
                spec_rel, line, 0, "DS1001",
                f"{mname}: obligation function {func!r} not in {path}",
            )]
        calls = [
            node.lineno
            for fn in fns
            for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and callee_basename(node.func) == must
        ]
        if not calls:
            return [Diagnostic(
                path, fns[0].lineno, 0, "DS1005",
                f"{mname}: {func} must call {must} "
                f"({ob.get('why', 'declared obligation')}) — no call found",
            )]
        if before:
            sends = [ln for fn in fns for ln in _sends_of(fn, str(before))]
            if sends and max(sends) < min(calls):
                return [Diagnostic(
                    path, max(sends), 0, "DS1005",
                    f"{mname}: {func} sends {before!r} (line {max(sends)}) "
                    f"before discharging {must} (line {min(calls)}) — "
                    f"{ob.get('why', 'ordered obligation')}",
                )]
        return []

    # -- DS1101..DS1103 ------------------------------------------------------

    def _check_contracts(
        self, contracts_rel, contracts_tree, contracts, exempt, event_types
    ) -> list[Diagnostic]:
        # The engine code is imported from the installed analysis package,
        # but the DATA it validates is the linted tree's literal — the
        # parse-don't-import discipline applies to the tree, not to our
        # own library functions.
        from dsort_tpu_torch.analysis.spec.contracts import (
            ContractError,
            compile_contract,
            contract_names,
        )

        diags = []
        key_lines = _dict_key_lines(contracts_tree, "TRACE_CONTRACTS")
        covered: set[str] = set()
        for cname, contract in contracts.items():
            at = key_lines.get(cname, 1)
            try:
                names = contract_names(contract)
                compile_contract(contract)
            except (ContractError, KeyError, TypeError) as e:
                diags.append(Diagnostic(
                    contracts_rel, at, 0, "DS1102",
                    f"contract {cname!r} does not compile: {e}",
                ))
                continue
            covered |= names
            for ev in sorted(names | set(contract.get("when", ()))):
                if event_types and ev not in event_types:
                    diags.append(Diagnostic(
                        contracts_rel, at, 0, "DS1102",
                        f"contract {cname!r} names {ev!r}, which is not in "
                        f"EVENT_TYPES",
                    ))
        for ev in exempt:
            if event_types and ev not in event_types:
                diags.append(Diagnostic(
                    contracts_rel, 1, 0, "DS1102",
                    f"CONTRACT_EXEMPT names {ev!r}, which is not in "
                    f"EVENT_TYPES",
                ))
            if ev in covered:
                diags.append(Diagnostic(
                    contracts_rel, 1, 0, "DS1102",
                    f"{ev!r} is both contract-covered and CONTRACT_EXEMPT",
                ))
        return diags

    def _check_emissions(
        self, project, contracts, exempt, event_types, spec_rel, contracts_rel
    ) -> list[Diagnostic]:
        from dsort_tpu_torch.analysis.spec.contracts import (
            ContractError,
            contract_names,
        )

        covered: set[str] = set()
        for contract in contracts.values():
            try:
                covered |= contract_names(contract)
            except (ContractError, KeyError, TypeError):
                pass  # already a DS1102
        alphabet_union = covered
        ok_names = covered | set(exempt)
        diags = []
        for rel in sorted(project.relpaths):
            if not rel.endswith(".py"):
                continue
            if rel in (spec_rel, contracts_rel):
                continue  # the registries' own docstrings/literals
            src = project.source(rel)
            if src is None:
                continue
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError:
                continue  # DS001's problem
            is_test = rel.startswith("tests/") or "/tests/" in rel
            for node in ast.walk(tree):
                # DS1101: emission sites of registered event names.
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_ATTRS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    ev = node.args[0].value
                    if (
                        not is_test
                        and ev in event_types
                        and ev not in ok_names
                    ):
                        diags.append(Diagnostic(
                            rel, node.lineno, node.col_offset, "DS1101",
                            f"event {ev!r} is emitted here but belongs to "
                            f"no declared trace contract (and is not in "
                            f"CONTRACT_EXEMPT)",
                        ))
                # DS1103: hand-rolled trace-sequence literals.
                if isinstance(node, (ast.List, ast.Tuple)):
                    names = [
                        e.value
                        for e in node.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    ]
                    if (
                        len(names) == len(node.elts)
                        and len(names) >= 4
                        and len(set(names)) >= 2
                        and alphabet_union
                        and all(n in alphabet_union for n in names)
                    ):
                        diags.append(Diagnostic(
                            rel, node.lineno, node.col_offset, "DS1103",
                            f"hand-rolled trace sequence {names[:3] + ['...']}"
                            f" — declare the grammar in TRACE_CONTRACTS and "
                            f"assert with the contract engine",
                        ))
        return diags
