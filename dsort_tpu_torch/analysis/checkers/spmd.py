"""DS12xx: the collective-schedule verifier.

Counterpart of ``dsort_tpu/analysis/checkers/spmd.py``, read on the port's
collectives.  The reference's shards run one program each under
``shard_map`` and meet in ``lax.ppermute`` / ``all_gather``; the port's
shards are the rows of one tensor (`parallel.mesh.VirtualMesh`) or of one
tensor per process (`parallel.distributed.ProcessGroupMesh`), so a
``ppermute`` is either ``mesh.ppermute(x, pairs)`` or, for the ring's
rotations, one ``torch.roll`` along the shard axis.  Proves, per module
that declares an ``SPMD_CONTRACT`` (and REQUIRES the declaration from the
modules `spmd.registry` lists):

- DS1201 — every permutation is the declared one.  Each closed-form
  ``perms`` builder is evaluated over the bounded (P, step) grid and
  checked for validity (in-range, no duplicate source or destination,
  full builders cover the axis) AND conformance to its declared
  destination form; every ``mesh.ppermute`` call site must trace its table
  to a declared builder.  A ``torch.roll(x, s, dims=d)`` along the shard
  axis sends row ``i`` to ``(i + s) % P``: every roll must sit in a
  function the contract's ``rolls`` section declares, and its shift,
  evaluated over the declared domain, must give the declared destination
  form for every row — an inverted shift is still a bijection, so only
  the form catches it.
- DS1202 — no collective under a rank-divergent branch: a collective
  inside an ``if`` whose test derives from the process rank
  (``dist.get_rank()``, a mesh's ``.rank``, or a module function that
  returns one) deadlocks the process group when ranks disagree (or a
  ``cond``/``switch`` on such a predicate whose branch issues one).  A
  module function that issues a collective is itself one.  Host-plane
  modules (``plane: "host"``) must issue no collectives at all.
- DS1204 — per-step slot writes are disjoint and inside their buffers:
  in each function the ``layouts`` section declares, every subscript
  store inside a ``for k in range(...)`` step loop is evaluated, per mesh
  size of the grid over sample caps, as a box of per-dimension intervals;
  boxes of different steps must not overlap, and a box must lie inside
  its buffer where the allocation's shape is evaluable.  The port's fused
  ring writes every (destination, step) slot in one CUDA launch; its
  plain twin `ops.ring_kernel.ring_exchange_plain` states that layout in
  Python, and chip_smoke.py holds the kernel to it bit for bit.

DS1200 is the loud-failure channel: a missing/malformed contract, an
undeclared required minimum, or a closed form that left the statically
evaluable subset can never pass vacuously.  The reference's DS1203 (a
collective's mesh-axis name) has no reading: the port's mesh is one
unnamed axis (`checkers.SKIPPED`).
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename, own_nodes
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext
from dsort_tpu_torch.analysis.spmd.contract import (
    CONTRACT_KEYS,
    ContractError,
    extract_contract,
    iter_domain,
    load_spmd_registry,
)
from dsort_tpu_torch.analysis.spmd.symeval import (
    EvalError,
    Evaluator,
    extract_functions,
)

#: Collective operations the verifier tracks (group-blocking: every shard
#: or process must issue the same sequence): the mesh methods and
#: ``torch.distributed``'s collectives.
COLLECTIVES = {
    "ppermute",
    "all_gather",
    "all_to_all",
    "all_reduce",
    "all_gather_into_tensor",
    "all_gather_object",
    "all_to_all_single",
    "reduce_scatter",
    "reduce_scatter_tensor",
    "broadcast",
    "broadcast_object_list",
    "barrier",
    "batch_isend_irecv",
}

#: Calls whose results differ per process (taint seeds), besides any
#: ``.rank`` attribute read.
_RANK_CALLS = {"get_rank", "get_group_rank", "get_global_rank"}

#: An unbounded extent (a bare ``:`` over a dimension of unknown size).
_INF = 1 << 62


def _varying(expr: ast.AST, tainted: set[str], rank_fns: dict) -> bool:
    """Does ``expr`` derive from the process rank?  ``rank_fns`` maps a
    module function returning a rank-derived value to the varying
    positions of the tuple it returns (None: the whole value), so
    ``_rank_world()[1]`` (the world size) stays uniform."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute) and expr.attr == "rank":
        return True
    if isinstance(expr, ast.Call):
        base = callee_basename(expr.func)
        if base in _RANK_CALLS or base in rank_fns:
            return True
    if (
        isinstance(expr, ast.Subscript)
        and isinstance(expr.value, ast.Call)
        and isinstance(expr.slice, ast.Constant)
        and rank_fns.get(callee_basename(expr.value.func)) is not None
        and expr.slice.value not in rank_fns[callee_basename(expr.value.func)]
    ):
        return any(_varying(a, tainted, rank_fns) for a in expr.value.args)
    return any(
        _varying(c, tainted, rank_fns) for c in ast.iter_child_nodes(expr)
    )


def _varying_positions(value: ast.expr, tainted, rank_fns):
    """Rank-varying positions of a returned or unpacked value: a set of
    tuple positions, None for the whole value, or an empty set."""
    if isinstance(value, ast.Tuple):
        return {
            i for i, e in enumerate(value.elts)
            if _varying(e, tainted, rank_fns)
        }
    if isinstance(value, ast.Call) and callee_basename(value.func) in rank_fns:
        return rank_fns[callee_basename(value.func)]
    return None if _varying(value, tainted, rank_fns) else set()


def _module_closures(tree: ast.AST) -> tuple[set[str], dict]:
    """Module functions that issue a collective, and module functions that
    return a rank-derived value (with its varying tuple positions), each
    closed over same-module calls."""
    fns = extract_functions(tree)
    collective: set[str] = set()
    rank_fns: dict = {}
    grew = True
    while grew:
        grew = False
        for name, fn in fns.items():
            if name not in collective and any(
                isinstance(n, ast.Call)
                and callee_basename(n.func) in COLLECTIVES | collective
                for n in own_nodes(fn)
            ):
                collective.add(name)
                grew = True
            positions: set | None = set()
            for n in own_nodes(fn):
                if isinstance(n, ast.Return) and n.value is not None:
                    got = _varying_positions(n.value, set(), rank_fns)
                    positions = (
                        None if got is None or positions is None
                        else positions | got
                    )
            if positions != set() and rank_fns.get(name, set()) != positions:
                rank_fns[name] = positions
                grew = True
    return collective, rank_fns


def _roll_parts(call: ast.Call):
    """``(shift expr, dims value | None)`` of ``torch.roll(x, s, dims)`` or
    ``x.roll(s, dims)``, else None."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "roll"):
        return None
    args = list(call.args)
    if isinstance(f.value, ast.Name) and f.value.id == "torch":
        args = args[1:]
    shift = args[0] if args else None
    dims = args[1] if len(args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "shifts":
            shift = kw.value
        elif kw.arg == "dims":
            dims = kw.value
    if shift is None:
        return None
    dim = dims.value if isinstance(dims, ast.Constant) else None
    return shift, dim


class _FnScan:
    """One function's SPMD-relevant surface, def-boundary scoped."""

    def __init__(self, fn: ast.FunctionDef, collectives: set, rank_fns: dict):
        self.fn = fn
        self.collectives = collectives
        self.rank_fns = rank_fns
        self.sites: list[tuple[ast.Call, list[ast.expr]]] = []
        self.conds: list[tuple[ast.Call, list[ast.expr]]] = []
        self.rolls: list[ast.Call] = []
        self.assign_calls: dict[str, list[str]] = {}
        self.local_defs: dict[str, ast.FunctionDef] = {}
        self._stmts(fn.body, [])
        self.tainted = self._taint()

    def _stmts(self, stmts, tests: list[ast.expr]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.local_defs[st.name] = st
                continue
            if isinstance(st, ast.If):
                self._exprs(st.test, tests)
                inner = tests + [st.test]
                self._stmts(st.body, inner)
                self._stmts(st.orelse, inner)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._exprs(st.iter, tests)
                self._stmts(st.body, tests)
                self._stmts(st.orelse, tests)
            elif isinstance(st, ast.While):
                self._exprs(st.test, tests)
                self._stmts(st.body, tests)
                self._stmts(st.orelse, tests)
            elif isinstance(st, ast.Try):
                self._stmts(st.body, tests)
                for h in st.handlers:
                    self._stmts(h.body, tests)
                self._stmts(st.orelse, tests)
                self._stmts(st.finalbody, tests)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._exprs(item.context_expr, tests)
                self._stmts(st.body, tests)
            else:
                self._exprs(st, tests)

    def _exprs(self, node: ast.AST, tests: list[ast.expr]) -> None:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                base = callee_basename(n.func)
                if base in COLLECTIVES or base in self.collectives:
                    self.sites.append((n, tests))
                elif base in ("cond", "switch"):
                    self.conds.append((n, tests))
                elif _roll_parts(n) is not None:
                    self.rolls.append(n)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                base = callee_basename(n.value.func)
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        self.assign_calls.setdefault(t.id, []).append(base)

    def _taint(self) -> set[str]:
        """Local names bound to rank-derived values (an attribute target
        such as ``self.rank`` taints nothing: ``.rank`` reads are seeds)."""
        assigns: list[tuple[ast.expr, ast.expr]] = []
        for st in own_nodes(self.fn):
            if isinstance(st, ast.Assign):
                assigns.extend((t, st.value) for t in st.targets)
            elif isinstance(st, (ast.AnnAssign, ast.AugAssign)) and st.value:
                assigns.append((st.target, st.value))
        tainted: set[str] = set()
        for _ in range(len(assigns) + 1):
            grew = False
            for target, value in assigns:
                if isinstance(target, ast.Tuple):
                    pos = _varying_positions(value, tainted, self.rank_fns)
                    names = {
                        e.id for i, e in enumerate(target.elts)
                        if isinstance(e, ast.Name) and (pos is None or i in pos)
                    }
                elif isinstance(target, ast.Name) and _varying(
                    value, tainted, self.rank_fns
                ):
                    names = {target.id}
                else:
                    names = set()
                if not names <= tainted:
                    tainted |= names
                    grew = True
            if not grew:
                break
        return tainted

    def is_varying(self, expr: ast.expr) -> bool:
        return _varying(expr, self.tainted, self.rank_fns)


class SpmdChecker(Checker):
    name = "spmd"
    codes = {
        "DS1200": (
            "SPMD contract missing, malformed, or a declared closed form "
            "is not statically evaluable"
        ),
        "DS1201": (
            "ppermute table or shard-axis roll is not the declared "
            "permutation of the mesh"
        ),
        "DS1202": (
            "collective issued under a rank-divergent branch (or from a "
            "host-only module)"
        ),
        "DS1204": (
            "per-step slot writes in one layout are not provably disjoint "
            "or inside their buffer"
        ),
    }
    scope = ("dsort_tpu_torch/*",)

    def __init__(self, scope=None):
        super().__init__(scope)
        self._registry_memo: dict[str, tuple] = {}

    def _registry(self, ctx: FileContext):
        """(registry dict | None, error Diagnostic | None), memoized."""
        rel = ctx.config.spmd_registry_path.replace("\\", "/")
        path = ctx.config.abspath(ctx.config.spmd_registry_path)
        if path not in self._registry_memo:
            try:
                self._registry_memo[path] = (load_spmd_registry(path), None)
            except ContractError as e:
                self._registry_memo[path] = (
                    None,
                    Diagnostic(rel, e.lineno, 0, "DS1200", str(e)),
                )
        return self._registry_memo[path]

    # -- the pass -----------------------------------------------------------

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        if ctx.tree is None:
            return []
        out: list[Diagnostic] = []
        registry, reg_err = self._registry(ctx)
        try:
            contract, line = extract_contract(ctx.tree)
        except ContractError as e:
            return [Diagnostic(ctx.relpath, e.lineno, 0, "DS1200", str(e))]
        required = (
            ctx.relpath in registry["SPMD_REQUIRED"] if registry else False
        )
        if contract is None and not required:
            return []
        if reg_err is not None:
            return [reg_err]
        if contract is None:
            return [
                Diagnostic(
                    ctx.relpath, 1, 0, "DS1200",
                    "module is required to declare an SPMD_CONTRACT "
                    "(analysis/spmd/registry.py SPMD_REQUIRED) but does not",
                )
            ]
        bad_keys = sorted(set(contract) - CONTRACT_KEYS)
        if bad_keys:
            out.append(
                Diagnostic(
                    ctx.relpath, line, 0, "DS1200",
                    f"SPMD_CONTRACT has unknown keys {bad_keys}",
                )
            )
        plane = contract.get("plane")
        if plane not in ("device", "host"):
            out.append(
                Diagnostic(
                    ctx.relpath, line, 0, "DS1200",
                    "SPMD_CONTRACT must declare plane: 'device' or 'host'",
                )
            )
            return out
        collectives, rank_fns = _module_closures(ctx.tree)
        scans = [
            _FnScan(fn, collectives, rank_fns)
            for fn in ast.walk(ctx.tree)
            if isinstance(fn, ast.FunctionDef)
        ]
        if plane == "host":
            for scan in scans:
                for call, _tests in scan.sites:
                    out.append(
                        Diagnostic(
                            ctx.relpath, call.lineno, call.col_offset,
                            "DS1202",
                            f"collective {callee_basename(call.func)!r} "
                            "issued from a module declared host-only "
                            "(plane: 'host')",
                        )
                    )
            return out
        functions = extract_functions(ctx.tree)
        perms = contract.get("perms", {})
        out.extend(self._check_required_minima(ctx, registry, line, contract))
        out.extend(self._check_perm_builders(ctx, registry, perms, functions))
        for scan in scans:
            out.extend(self._check_sites(ctx, scan, set(perms)))
        out.extend(
            self._check_rolls(
                ctx, registry, contract.get("rolls", {}), scans, line
            )
        )
        out.extend(
            self._check_layouts(
                ctx, registry, contract.get("layouts", {}), functions, line
            )
        )
        return out

    def _check_required_minima(
        self, ctx, registry, line, contract
    ) -> list[Diagnostic]:
        out = []
        for section, table in (
            ("perms", registry["SPMD_REQUIRED_PERMS"]),
            ("rolls", registry["SPMD_REQUIRED_ROLLS"]),
            ("layouts", registry["SPMD_REQUIRED_LAYOUTS"]),
        ):
            have = contract.get(section, {})
            for name in table.get(ctx.relpath, ()):
                if name not in have:
                    out.append(
                        Diagnostic(
                            ctx.relpath, line, 0, "DS1200",
                            f"SPMD_CONTRACT must declare {section}[{name!r}] "
                            "(analysis/spmd/registry.py minimum)",
                        )
                    )
        return out

    # -- DS1201: closed-form builders ---------------------------------------

    def _check_perm_builders(
        self, ctx, registry, perms, functions
    ) -> list[Diagnostic]:
        out = []
        for name, spec in sorted(perms.items()):
            fn = functions.get(name)
            if fn is None:
                out.append(
                    Diagnostic(
                        ctx.relpath, 1, 0, "DS1200",
                        f"declared perm builder {name!r} not found at "
                        "module top level",
                    )
                )
                continue
            if not isinstance(spec, dict):
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1200",
                        f"perms[{name!r}] must be a dict",
                    )
                )
                continue
            diag = self._verify_builder(ctx, registry, name, spec, fn)
            if diag is not None:
                out.append(diag)
        return out

    def _verify_builder(
        self, ctx, registry, name, spec, fn
    ) -> Diagnostic | None:
        ev = Evaluator(extract_functions(ctx.tree))
        args = spec.get("args")
        domain = spec.get("domain")
        kind = spec.get("kind")
        axis_size = spec.get("axis_size")
        if (
            not isinstance(args, (list, tuple))
            or not isinstance(domain, dict)
            or kind not in ("full", "partial")
            or not isinstance(axis_size, str)
        ):
            return Diagnostic(
                ctx.relpath, fn.lineno, 0, "DS1200",
                f"perms[{name!r}] needs args/domain/kind/axis_size",
            )
        try:
            for env in iter_domain(domain, registry, ev):
                p = ev.eval_str(axis_size, env)
                pairs = ev.call(name, [env[a] for a in args])
                bad = self._perm_violation(pairs, p, kind)
                if bad is None and "dst" in spec:
                    for src, dst in pairs:
                        want = ev.eval_str(spec["dst"], {**env, "i": src})
                        if dst != want:
                            bad = (
                                f"destination of source {src} is {dst}, "
                                f"declared form gives {want}"
                            )
                            break
                if bad is None and "pairs" in spec:
                    want = ev.eval_str(spec["pairs"], env)
                    if sorted(tuple(x) for x in pairs) != sorted(
                        tuple(x) for x in want
                    ):
                        bad = "pair set differs from the declared closed form"
                if bad is not None:
                    at = ", ".join(f"{a}={env[a]}" for a in args)
                    return Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1201",
                        f"{name}({at}): {bad}",
                    )
        except EvalError as e:
            return Diagnostic(
                ctx.relpath, fn.lineno, 0, "DS1200",
                f"perm builder {name!r} is not statically evaluable: {e}",
            )
        return None

    @staticmethod
    def _perm_violation(pairs, p, kind) -> str | None:
        if not isinstance(pairs, (list, tuple)) or not all(
            isinstance(x, (list, tuple))
            and len(x) == 2
            and all(isinstance(v, int) and not isinstance(v, bool) for v in x)
            for x in pairs
        ):
            return "builder did not return a list of (src, dst) int pairs"
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        for v in srcs + dsts:
            if not 0 <= v < p:
                return f"index {v} is outside the axis [0, {p})"
        if len(set(srcs)) != len(srcs):
            return "duplicate source (a shard sends twice)"
        if len(set(dsts)) != len(dsts):
            return "duplicate destination (two shards write one row)"
        if kind == "full" and set(srcs) != set(range(p)):
            return "missing source: table does not cover the axis"
        return None

    # -- DS1201/DS1202: call sites -------------------------------------------

    def _check_sites(self, ctx, scan, declared) -> list[Diagnostic]:
        out = []
        for call, tests in scan.sites:
            base = callee_basename(call.func)
            if base == "ppermute":
                out.extend(self._check_perm_arg(ctx, scan, call, declared))
            for test in tests:
                if scan.is_varying(test):
                    out.append(
                        Diagnostic(
                            ctx.relpath, call.lineno, call.col_offset,
                            "DS1202",
                            f"collective {base!r} under a branch on the "
                            f"process rank ({scan.fn.name}): divergent "
                            "participation deadlocks the group",
                        )
                    )
                    break
        for call, _tests in scan.conds:
            if not call.args or not scan.is_varying(call.args[0]):
                continue
            for branch in call.args[1:]:
                body = None
                if (
                    isinstance(branch, ast.Name)
                    and branch.id in scan.local_defs
                ):
                    body = scan.local_defs[branch.id]
                elif isinstance(branch, ast.Lambda):
                    body = branch
                if body is None:
                    continue
                if any(
                    isinstance(n, ast.Call)
                    and callee_basename(n.func) in COLLECTIVES
                    for n in ast.walk(body)
                ):
                    out.append(
                        Diagnostic(
                            ctx.relpath, call.lineno, call.col_offset,
                            "DS1202",
                            "collective inside a cond/switch branch on the "
                            f"process rank ({scan.fn.name}): divergent "
                            "participation deadlocks the group",
                        )
                    )
                    break
        return out

    def _check_perm_arg(self, ctx, scan, call, declared) -> list[Diagnostic]:
        """``mesh.ppermute(x, pairs)``: the table must trace to a declared
        closed-form builder."""
        perm = call.args[1] if len(call.args) >= 2 else None
        for kw in call.keywords:
            if kw.arg == "pairs":
                perm = kw.value
        if perm is None:
            return []
        if isinstance(perm, ast.Call) and callee_basename(
            perm.func
        ) in declared:
            return []
        if isinstance(perm, ast.Name):
            builders = scan.assign_calls.get(perm.id, [])
            if builders and all(b in declared for b in builders):
                return []
        return [
            Diagnostic(
                ctx.relpath, call.lineno, call.col_offset, "DS1201",
                "ppermute table does not trace to a declared closed-form "
                f"builder ({scan.fn.name}); declare it in "
                "SPMD_CONTRACT['perms'] so it is verified",
            )
        ]

    # -- DS1201: shard-axis rolls --------------------------------------------

    def _check_rolls(self, ctx, registry, rolls, scans, cline):
        if not isinstance(rolls, dict):
            return [
                Diagnostic(
                    ctx.relpath, cline, 0, "DS1200",
                    "SPMD_CONTRACT['rolls'] must be a dict",
                )
            ]
        out = []
        by_fn = {}
        for scan in scans:
            by_fn.setdefault(scan.fn.name, []).extend(scan.rolls)
        for name in sorted(rolls):
            if name not in by_fn:
                out.append(
                    Diagnostic(
                        ctx.relpath, cline, 0, "DS1200",
                        f"declared roll function {name!r} not found",
                    )
                )
            elif not by_fn[name]:
                out.append(
                    Diagnostic(
                        ctx.relpath, cline, 0, "DS1200",
                        f"declared roll function {name!r} issues no "
                        "torch.roll (stale rolls declaration?)",
                    )
                )
        ev = Evaluator(extract_functions(ctx.tree))
        for scan in scans:
            for call in scan.rolls:
                spec = rolls.get(scan.fn.name)
                if spec is None:
                    out.append(
                        Diagnostic(
                            ctx.relpath, call.lineno, call.col_offset,
                            "DS1201",
                            "torch.roll does not trace to a declared closed "
                            f"form ({scan.fn.name}); declare it in "
                            "SPMD_CONTRACT['rolls'] so it is verified",
                        )
                    )
                    continue
                diag = self._verify_roll(ctx, registry, ev, scan, call, spec)
                if diag is not None:
                    out.append(diag)
        return out

    def _verify_roll(self, ctx, registry, ev, scan, call, spec):
        shift, dim = _roll_parts(call)
        where = (ctx.relpath, call.lineno, call.col_offset)
        if not (
            isinstance(spec, dict)
            and isinstance(spec.get("dims"), int)
            and isinstance(spec.get("axis_size"), str)
            and isinstance(spec.get("domain"), dict)
            and isinstance(spec.get("dst"), str)
        ):
            return Diagnostic(
                *where, "DS1200",
                f"rolls[{scan.fn.name!r}] needs dims/axis_size/domain/dst",
            )
        if spec["dims"] != dim:
            return Diagnostic(
                *where, "DS1201",
                f"{scan.fn.name}: torch.roll along dims={dim!r}, but the "
                f"declared shard axis is dims={spec['dims']}",
            )
        text = ast.unparse(shift)
        try:
            bad = self._roll_violation(registry, ev, shift, spec)
        except EvalError as e:
            return Diagnostic(
                *where, "DS1200",
                f"{scan.fn.name}: roll shift {text!r} is not statically "
                f"evaluable over the declared domain: {e}",
            )
        if bad is None:
            return None
        return Diagnostic(
            *where, "DS1201", f"{scan.fn.name}: torch.roll by {text!r} {bad}",
        )

    @staticmethod
    def _roll_violation(registry, ev, shift, spec) -> str | None:
        for env in iter_domain(spec["domain"], registry, ev):
            p = ev.eval_str(spec["axis_size"], env)
            s = ev.eval_expr(shift, dict(env))
            for i in range(p):
                want = ev.eval_str(spec["dst"], {**env, "i": i})
                if (i + s) % p != want:
                    at = ", ".join(f"{k}={v}" for k, v in env.items())
                    return (
                        f"at {at} sends row {i} to {(i + s) % p}, declared "
                        f"form {spec['dst']!r} gives {want}"
                    )
        return None

    # -- DS1204: per-step slot layout ----------------------------------------

    def _check_layouts(
        self, ctx, registry, layouts, functions, cline
    ) -> list[Diagnostic]:
        out = []
        if not isinstance(layouts, dict):
            return [
                Diagnostic(
                    ctx.relpath, cline, 0, "DS1200",
                    "SPMD_CONTRACT['layouts'] must be a dict",
                )
            ]
        for name, spec in sorted(layouts.items()):
            fn = functions.get(name)
            if fn is None:
                out.append(
                    Diagnostic(
                        ctx.relpath, 1, 0, "DS1200",
                        f"declared layout function {name!r} not found at "
                        "module top level",
                    )
                )
                continue
            if not (
                isinstance(spec, dict)
                and isinstance(spec.get("axis"), str)
                and isinstance(spec.get("caps"), str)
            ):
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1200",
                        f"layouts[{name!r}] needs the axis and caps names",
                    )
                )
                continue
            out.extend(self._verify_layout(ctx, registry, fn, spec))
        return out

    @staticmethod
    def _bind_simple(ev, stmts, env) -> None:
        """Evaluate the simple assignments among ``stmts`` into ``env``,
        element by element for tuple targets; what is not evaluable (a
        tensor op) stays unbound."""
        for st in stmts:
            if not (isinstance(st, ast.Assign) and len(st.targets) == 1):
                continue
            t, v = st.targets[0], st.value
            pairs = [(t, v)]
            if (
                isinstance(t, ast.Tuple)
                and isinstance(v, ast.Tuple)
                and len(t.elts) == len(v.elts)
            ):
                pairs = list(zip(t.elts, v.elts))
            for tgt, val in pairs:
                if not isinstance(tgt, ast.Name):
                    continue
                try:
                    env[tgt.id] = ev.eval_expr(val, dict(env))
                except EvalError:
                    pass

    @staticmethod
    def _shape(ev, call, env):
        """Per-dimension sizes (None where unknown) of a ``torch.full`` /
        ``zeros`` / ``empty`` allocation with a literal shape tuple."""
        if not (
            isinstance(call, ast.Call)
            and callee_basename(call.func) in ("full", "zeros", "empty", "ones")
            and call.args
            and isinstance(call.args[0], ast.Tuple)
        ):
            return None
        dims = []
        for e in call.args[0].elts:
            try:
                v = ev.eval_expr(e, dict(env))
            except EvalError:
                v = None
            dims.append(v if isinstance(v, int) else None)
        return dims

    def _verify_layout(self, ctx, registry, fn, spec) -> list[Diagnostic]:
        loops = [
            n for n in own_nodes(fn)
            if isinstance(n, ast.For)
            and isinstance(n.target, ast.Name)
            and isinstance(n.iter, ast.Call)
            and callee_basename(n.iter.func) == "range"
        ]
        # Each store belongs to its innermost step loop.
        inside = {id(loop): {id(n) for n in own_nodes(loop)} for loop in loops}
        owner: dict[int, tuple] = {}
        for loop in loops:
            for st in own_nodes(loop):
                if not (
                    isinstance(st, ast.Assign)
                    and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Subscript)
                    and isinstance(st.targets[0].value, ast.Name)
                ):
                    continue
                held = owner.get(id(st))
                if held is None or id(loop) in inside[id(held[0])]:
                    owner[id(st)] = (loop, st)
        stores = list(owner.values())
        if not stores:
            return [
                Diagnostic(
                    ctx.relpath, fn.lineno, 0, "DS1200",
                    f"declared layout {fn.name!r} writes no slot inside a "
                    "step loop (stale layouts declaration?)",
                )
            ]
        ev = Evaluator(extract_functions(ctx.tree))
        for p in registry["MESH_SIZES"]:
            caps = tuple(8 * (1 + (i * 3) % 4) for i in range(p))
            env = {spec["axis"]: p, spec["caps"]: caps}
            self._bind_simple(ev, fn.body, env)
            shapes = {}
            for st in own_nodes(fn):
                if (
                    isinstance(st, ast.Assign)
                    and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                ):
                    shape = self._shape(ev, st.value, env)
                    if shape is not None:
                        shapes[st.targets[0].id] = shape
            boxes: dict[str, list] = {}
            for loop, st in stores:
                try:
                    steps = ev.eval_expr(loop.iter, dict(env))
                except EvalError as e:
                    return [
                        Diagnostic(
                            ctx.relpath, loop.lineno, loop.col_offset,
                            "DS1200",
                            f"layout {fn.name!r}: step range not statically "
                            f"evaluable at P={p}: {e}",
                        )
                    ]
                tgt = st.targets[0]
                buf = tgt.value.id
                for k in steps:
                    kenv = dict(env)
                    kenv[loop.target.id] = k
                    self._bind_simple(ev, loop.body, kenv)
                    try:
                        box = self._box(ev, tgt.slice, kenv, shapes.get(buf))
                    except EvalError as e:
                        return [
                            Diagnostic(
                                ctx.relpath, st.lineno, st.col_offset,
                                "DS1200",
                                f"layout {fn.name!r}: the write into {buf!r} "
                                f"is not statically evaluable at P={p}: {e}",
                            )
                        ]
                    shape = shapes.get(buf)
                    for d, (lo, hi) in enumerate(box):
                        size = shape[d] if shape and d < len(shape) else None
                        if lo < 0 or (size is not None and hi > size):
                            return [
                                Diagnostic(
                                    ctx.relpath, st.lineno, st.col_offset,
                                    "DS1204",
                                    f"layout {fn.name!r}: step {k} writes "
                                    f"{buf!r} dim {d} over [{lo}, {hi}) at "
                                    f"P={p}, outside its size {size}",
                                )
                            ]
                    boxes.setdefault(buf, []).append((box, k, st))
            for buf, entries in boxes.items():
                for i, (a, ka, _sa) in enumerate(entries):
                    for b, kb, sb in entries[i + 1:]:
                        if ka == kb:
                            continue
                        if all(
                            max(x[0], y[0]) < min(x[1], y[1])
                            for x, y in zip(a, b)
                        ):
                            return [
                                Diagnostic(
                                    ctx.relpath, sb.lineno, sb.col_offset,
                                    "DS1204",
                                    f"layout {fn.name!r}: writes into "
                                    f"{buf!r} overlap at P={p}: step {ka} "
                                    f"box {a} vs step {kb} box {b}",
                                )
                            ]
        return []

    @staticmethod
    def _box(ev, index, env, shape):
        """``[(lo, hi), ...]`` per dimension of a subscript store."""
        elts = index.elts if isinstance(index, ast.Tuple) else [index]
        box = []
        for d, e in enumerate(elts):
            size = shape[d] if shape and d < len(shape) else None
            if isinstance(e, ast.Slice):
                if e.step is not None:
                    raise EvalError("strided slot write")
                lo = 0 if e.lower is None else ev.eval_expr(e.lower, env)
                if e.upper is not None:
                    hi = ev.eval_expr(e.upper, env)
                else:
                    hi = size if size is not None else _INF
            else:
                lo = ev.eval_expr(e, env)
                hi = lo + 1 if isinstance(lo, int) else None
            if not (isinstance(lo, int) and isinstance(hi, int)):
                raise EvalError("non-integer slot bound")
            box.append((lo, max(hi, lo)))
        return box
