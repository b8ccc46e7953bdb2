"""DS13xx: the capacity/layout abstract interpreter.

Counterpart of ``dsort_tpu/analysis/checkers/caps.py``, read on the port's
closed forms (the same cap ladders, in pure Python) and on its torch
receive-canvas stores (``canvas[rows, slot] = value``).

Verifies the cap-ladder arithmetic the no-retry doctrine leans on
("ring-path overflow is an invariant violation" — the buffers are sized
from the measured histogram, so the quantizers must COVER every measured
max).  Each module's ``SPMD_CONTRACT`` declares its capacity functions with
the properties they must satisfy; the checker evaluates the functions —
from the linted source, never imported — over the bounded grids in
`spmd.registry` and checks every property at every point:

- DS1301 cap-not-covering: ``quantize(m) >= m`` over the declared domain
  (``_quantize_cap`` for measured maxes up to ``n_local``, ``pad_rung``
  for job sizes, the ladder reaching its ``hi``).
- DS1302 overlapping-slot-layout: slot offsets must be the monotone
  non-overlapping partial sums of the caps (``_step_offsets``), and every
  declared receive-canvas store (a subscript assignment into the canvas)
  must keep its re-pack hop (the hier leg's ``_pad_run(..., agg_total,
  ...)`` — deleting it stores a ``leg_caps[s]``-sized buffer into an
  ``agg_total`` row).
- DS1303 unaligned/degenerate size: no clamp chain may produce a zero,
  negative, or non-8-aligned buffer (``ring_step_quantum`` stays on the
  8 grid, caps stay on the quantum ladder, ``WAVE_MIN/MAX_ELEMS`` and the
  redundancy clamp stay positive and ordered).

DS1300 is the loud-failure channel (malformed/missing declarations, a cap
function outside the evaluable subset) — the same no-vacuous-pass doctrine
as DS1200.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.astutil import callee_basename
from dsort_tpu_torch.analysis.core import Diagnostic
from dsort_tpu_torch.analysis.engine import Checker, FileContext
from dsort_tpu_torch.analysis.spmd.contract import (
    ContractError,
    extract_contract,
    iter_domain,
    load_spmd_registry,
    module_const_env,
)
from dsort_tpu_torch.analysis.spmd.symeval import (
    EvalError,
    Evaluator,
    extract_functions,
)


class CapsChecker(Checker):
    name = "caps"
    codes = {
        "DS1300": (
            "capacity contract missing, malformed, or a declared cap "
            "function is not statically evaluable"
        ),
        "DS1301": "capacity quantization does not cover the measured demand",
        "DS1302": (
            "slot layout overlaps, or a declared receive-canvas re-pack "
            "hop is missing"
        ),
        "DS1303": (
            "cap/clamp chain can produce a zero, negative, or unaligned "
            "size"
        ),
    }
    scope = ("dsort_tpu_torch/*",)

    def __init__(self, scope=None):
        super().__init__(scope)
        self._registry_memo: dict[str, tuple] = {}

    def _registry(self, ctx: FileContext):
        rel = ctx.config.spmd_registry_path.replace("\\", "/")
        path = ctx.config.abspath(ctx.config.spmd_registry_path)
        if path not in self._registry_memo:
            try:
                self._registry_memo[path] = (load_spmd_registry(path), None)
            except ContractError as e:
                self._registry_memo[path] = (
                    None,
                    Diagnostic(rel, e.lineno, 0, "DS1300", str(e)),
                )
        return self._registry_memo[path]

    def check(self, ctx: FileContext) -> list[Diagnostic]:
        if ctx.tree is None:
            return []
        registry, reg_err = self._registry(ctx)
        try:
            contract, line = extract_contract(ctx.tree)
        except ContractError:
            # The spmd checker owns the malformed-contract finding; a second
            # copy here would double-report one defect.
            return []
        caps_required = (
            registry is not None
            and (
                ctx.relpath in registry["SPMD_REQUIRED_CAPS"]
                or ctx.relpath in registry["SPMD_REQUIRED_STORES"]
                or ctx.relpath in registry["SPMD_REQUIRED_CONSTS"]
            )
        )
        if contract is None and not caps_required:
            return []
        if reg_err is not None:
            return [reg_err]
        contract = contract or {}
        out: list[Diagnostic] = []
        functions = extract_functions(ctx.tree)
        for section, table in (
            ("caps", registry["SPMD_REQUIRED_CAPS"]),
            ("stores", registry["SPMD_REQUIRED_STORES"]),
            ("consts", registry["SPMD_REQUIRED_CONSTS"]),
        ):
            have = contract.get(section, {})
            for name in table.get(ctx.relpath, ()):
                if name not in have:
                    out.append(
                        Diagnostic(
                            ctx.relpath, max(line, 1), 0, "DS1300",
                            f"SPMD_CONTRACT must declare {section}[{name!r}] "
                            "(analysis/spmd/registry.py minimum)",
                        )
                    )
        out.extend(
            self._check_caps(
                ctx, registry, contract.get("caps", {}), functions
            )
        )
        out.extend(self._check_consts(ctx, contract.get("consts", {})))
        out.extend(self._check_stores(ctx, contract.get("stores", {})))
        return out

    # -- declared cap functions ---------------------------------------------

    def _check_caps(self, ctx, registry, caps, functions) -> list[Diagnostic]:
        out: list[Diagnostic] = []
        if not isinstance(caps, dict):
            return [
                Diagnostic(
                    ctx.relpath, 1, 0, "DS1300",
                    "SPMD_CONTRACT['caps'] must be a dict",
                )
            ]
        for name, spec in sorted(caps.items()):
            fn = functions.get(name)
            if fn is None:
                out.append(
                    Diagnostic(
                        ctx.relpath, 1, 0, "DS1300",
                        f"declared cap function {name!r} not found at "
                        "module top level",
                    )
                )
                continue
            args = spec.get("args") if isinstance(spec, dict) else None
            domain = spec.get("domain") if isinstance(spec, dict) else None
            require = spec.get("require") if isinstance(spec, dict) else None
            if (
                not isinstance(args, (list, tuple))
                or not isinstance(domain, dict)
                or not isinstance(require, (list, tuple))
                or not all(
                    isinstance(r, (list, tuple))
                    and len(r) == 2
                    and r[0] in self.codes
                    for r in require
                )
            ):
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1300",
                        f"caps[{name!r}] needs args/domain and (code, "
                        "property) require pairs",
                    )
                )
                continue
            ev = Evaluator(functions)
            failed: dict[int, tuple] = {}
            try:
                for env in iter_domain(domain, registry, ev):
                    result = ev.call(name, [env[a] for a in args])
                    scope = {**env, "out": result}
                    for i, (_code, prop) in enumerate(require):
                        if i in failed:
                            continue
                        if not ev.eval_str(prop, scope):
                            failed[i] = (dict(env), result)
                    if len(failed) == len(require):
                        break
            except EvalError as e:
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1300",
                        f"cap function {name!r} is not statically "
                        f"evaluable: {e}",
                    )
                )
                continue
            for i, (env, result) in sorted(failed.items()):
                code, prop = require[i]
                at = ", ".join(f"{a}={env[a]}" for a in args)
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, code,
                        f"{name}({at}) = {result!r} violates declared "
                        f"property {prop!r}",
                    )
                )
        return out

    # -- declared constants --------------------------------------------------

    def _check_consts(self, ctx, consts) -> list[Diagnostic]:
        out: list[Diagnostic] = []
        if not isinstance(consts, dict):
            return [
                Diagnostic(
                    ctx.relpath, 1, 0, "DS1300",
                    "SPMD_CONTRACT['consts'] must be a dict",
                )
            ]
        if not consts:
            return []
        ev = Evaluator()
        env = module_const_env(ctx.tree, ev)
        lines = self._const_lines(ctx.tree)
        for name, require in sorted(consts.items()):
            if name not in env:
                out.append(
                    Diagnostic(
                        ctx.relpath, 1, 0, "DS1300",
                        f"declared constant {name!r} not found (or not "
                        "statically evaluable) at module top level",
                    )
                )
                continue
            if not isinstance(require, (list, tuple)) or not all(
                isinstance(r, (list, tuple))
                and len(r) == 2
                and r[0] in self.codes
                for r in require
            ):
                out.append(
                    Diagnostic(
                        ctx.relpath, lines.get(name, 1), 0, "DS1300",
                        f"consts[{name!r}] needs (code, property) pairs",
                    )
                )
                continue
            for code, prop in require:
                try:
                    ok = ev.eval_str(prop, {**env, "value": env[name]})
                except EvalError as e:
                    out.append(
                        Diagnostic(
                            ctx.relpath, lines.get(name, 1), 0, "DS1300",
                            f"consts[{name!r}] property {prop!r} is not "
                            f"evaluable: {e}",
                        )
                    )
                    continue
                if not ok:
                    out.append(
                        Diagnostic(
                            ctx.relpath, lines.get(name, 1), 0, code,
                            f"constant {name} = {env[name]!r} violates "
                            f"declared property {prop!r}",
                        )
                    )
        return out

    @staticmethod
    def _const_lines(tree) -> dict[str, int]:
        out: dict[str, int] = {}
        for node in getattr(tree, "body", []):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, node.lineno)
        return out

    # -- declared canvas stores (the re-pack hop) ----------------------------

    def _check_stores(self, ctx, stores) -> list[Diagnostic]:
        out: list[Diagnostic] = []
        if not isinstance(stores, dict):
            return [
                Diagnostic(
                    ctx.relpath, 1, 0, "DS1300",
                    "SPMD_CONTRACT['stores'] must be a dict",
                )
            ]
        functions = extract_functions(ctx.tree)
        for name, specs in sorted(stores.items()):
            fn = functions.get(name)
            if fn is None:
                out.append(
                    Diagnostic(
                        ctx.relpath, 1, 0, "DS1300",
                        f"declared store function {name!r} not found at "
                        "module top level",
                    )
                )
                continue
            if not isinstance(specs, (list, tuple)):
                out.append(
                    Diagnostic(
                        ctx.relpath, fn.lineno, 0, "DS1300",
                        f"stores[{name!r}] must be a tuple of store specs",
                    )
                )
                continue
            for spec in specs:
                if not isinstance(spec, dict) or not all(
                    isinstance(spec.get(k), str)
                    for k in ("canvas", "repack", "width")
                ):
                    out.append(
                        Diagnostic(
                            ctx.relpath, fn.lineno, 0, "DS1300",
                            f"stores[{name!r}] specs need canvas/repack/"
                            "width names",
                        )
                    )
                    continue
                out.extend(self._check_store(ctx, fn, spec))
        return out

    def _check_store(self, ctx, fn, spec) -> list[Diagnostic]:
        canvas, repack, width = (
            spec["canvas"], spec["repack"], spec["width"],
        )
        sets = [
            node
            for node in ast.walk(fn)
            if isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id == canvas
                for t in node.targets
            )
        ]
        if not sets:
            return [
                Diagnostic(
                    ctx.relpath, fn.lineno, 0, "DS1300",
                    f"{fn.name}: no {canvas}[...] = ... store found "
                    "(stale stores declaration?)",
                )
            ]
        out = []
        for node in sets:
            repacked = any(
                isinstance(n, ast.Call)
                and callee_basename(n.func) == repack
                and any(
                    isinstance(a, ast.Name) and a.id == width
                    for a in n.args
                )
                for n in ast.walk(node.value)
            )
            if not repacked:
                out.append(
                    Diagnostic(
                        ctx.relpath, node.lineno, node.col_offset, "DS1302",
                        f"{fn.name}: store into receive canvas {canvas!r} "
                        f"without the declared {repack}(..., {width}, ...) "
                        "re-pack — a short leg buffer would land in a "
                        f"{width}-wide row",
                    )
                )
        return out
