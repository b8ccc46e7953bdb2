"""Restricted symbolic evaluator for closed-form schedule arithmetic.

Counterpart of ``dsort_tpu/analysis/spmd/symeval.py``, its own copy.
Evaluates the PURE integer/list functions the exchange schedules are built
from — perm builders (`_hier_perm_intra`, `_hier_perm_leg`), cap
quantizers (`ring_step_quantum`, `_quantize_cap`, `ladder_rungs`,
`pad_rung`, `parity_slots`) and slot-offset cumsums (`_step_offsets`) — by
interpreting their AST directly.  Nothing is imported from the tree being
linted: the verdict is about the source text, and a lint run never imports
torch (the analysis package is stdlib-only by layer contract).  A declared
function that calls ``np`` or ``torch`` leaves the evaluable subset and is
reported, never skipped.

The evaluator is deliberately SMALL.  It supports exactly the statement and
expression shapes those closed forms use (arithmetic, comparisons,
comprehensions, ``for``/``while``/``if``, calls to a builtin whitelist and
to other module-level functions) and raises `EvalError` on anything else —
a function that drifts outside the evaluable subset is reported loudly
(DS1200/DS1300), never silently skipped.  A global step budget bounds every
evaluation, so a seeded non-terminating mutation degrades to a loud
"not statically evaluable" finding rather than a hung lint run.
"""

from __future__ import annotations

import ast


class EvalError(Exception):
    """The expression/function left the evaluable subset (or the budget)."""


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


#: Builtins the closed forms may call.  ``print``/``getattr``/imports are
#: deliberately absent: anything effectful or reflective is out of scope.
_BUILTINS = {
    "abs": abs,
    "all": all,
    "any": any,
    "bool": bool,
    "divmod": divmod,
    "enumerate": enumerate,
    "int": int,
    "len": len,
    "list": list,
    "max": max,
    "min": min,
    "range": range,
    "reversed": reversed,
    "sorted": sorted,
    "sum": sum,
    "tuple": tuple,
    "zip": zip,
}

#: Methods callable on evaluated values, by value type.
_METHODS = {
    int: {"bit_length"},
    list: {"append", "extend", "pop", "index", "count"},
    tuple: {"index", "count"},
}

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a**b,
    ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitOr: lambda a, b: a | b,
    ast.BitXor: lambda a, b: a ^ b,
}

_CMPOPS = {
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.Is: lambda a, b: a is b,
    ast.IsNot: lambda a, b: a is not b,
    ast.In: lambda a, b: a in b,
    ast.NotIn: lambda a, b: a not in b,
}


def extract_functions(tree: ast.AST) -> dict[str, ast.FunctionDef]:
    """Top-level function definitions of a parsed module, by name."""
    out: dict[str, ast.FunctionDef] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
    return out


class Evaluator:
    """Interpret closed forms over concrete instantiations.

    ``functions`` maps name -> top-level ``ast.FunctionDef`` of the module
    under analysis; calls between them resolve through this table (e.g.
    ``_quantize_cap`` -> ``ring_step_quantum``).  ``max_steps`` is a global
    budget across nested calls.
    """

    def __init__(
        self,
        functions: dict[str, ast.FunctionDef] | None = None,
        max_steps: int = 2_000_000,
    ):
        self.functions = functions or {}
        self.max_steps = max_steps
        self.steps = 0

    # -- entry points -------------------------------------------------------

    def call(self, name: str, args: list, kwargs: dict | None = None):
        fn = self.functions.get(name)
        if fn is None:
            raise EvalError(f"unknown function {name!r}")
        return self._call_def(fn, args, kwargs or {})

    def eval_str(self, expr: str, env: dict):
        """Evaluate a Python expression string against ``env``."""
        try:
            node = ast.parse(expr, mode="eval")
        except SyntaxError as e:
            raise EvalError(f"bad expression {expr!r}: {e.msg}") from None
        return self.eval_expr(node.body, env)

    # -- plumbing -----------------------------------------------------------

    def _tick(self):
        self.steps += 1
        if self.steps > self.max_steps:
            raise EvalError("evaluation step budget exceeded")

    def _call_def(self, fn: ast.FunctionDef, args: list, kwargs: dict):
        a = fn.args
        if a.vararg or a.kwarg or a.posonlyargs:
            raise EvalError(f"{fn.name}: unsupported signature")
        names = [x.arg for x in a.args] + [x.arg for x in a.kwonlyargs]
        env: dict = {}
        if len(args) > len(a.args):
            raise EvalError(f"{fn.name}: too many positional args")
        for name, val in zip([x.arg for x in a.args], args):
            env[name] = val
        for key, val in kwargs.items():
            if key not in names:
                raise EvalError(f"{fn.name}: unknown kwarg {key!r}")
            env[key] = val
        # Defaults for anything still unbound.
        pos_defaults = dict(
            zip([x.arg for x in a.args][len(a.args) - len(a.defaults):],
                a.defaults)
        )
        kw_defaults = {
            x.arg: d
            for x, d in zip(a.kwonlyargs, a.kw_defaults)
            if d is not None
        }
        for name in names:
            if name not in env:
                default = pos_defaults.get(name, kw_defaults.get(name))
                if default is None:
                    raise EvalError(f"{fn.name}: missing argument {name!r}")
                env[name] = self.eval_expr(default, env)
        try:
            self._exec(fn.body, env)
        except _Return as r:
            return r.value
        return None

    def _exec(self, stmts: list[ast.stmt], env: dict) -> None:
        for node in stmts:
            self._tick()
            if isinstance(node, ast.Return):
                raise _Return(
                    None if node.value is None
                    else self.eval_expr(node.value, env)
                )
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._assign(node, env)
            elif isinstance(node, ast.If):
                branch = (
                    node.body if self.eval_expr(node.test, env) else node.orelse
                )
                self._exec(branch, env)
            elif isinstance(node, ast.For):
                self._for(node, env)
            elif isinstance(node, ast.While):
                while self.eval_expr(node.test, env):
                    self._tick()
                    try:
                        self._exec(node.body, env)
                    except _Break:
                        break
                    except _Continue:
                        continue
            elif isinstance(node, ast.Expr):
                self.eval_expr(node.value, env)
            elif isinstance(node, ast.Pass):
                pass
            elif isinstance(node, ast.Break):
                raise _Break()
            elif isinstance(node, ast.Continue):
                raise _Continue()
            elif isinstance(node, ast.Raise):
                # The closed forms raise only on domain violations; reaching
                # one under a verification domain IS a verification failure.
                raise EvalError("explicit raise reached during evaluation")
            elif isinstance(node, ast.Assert):
                if not self.eval_expr(node.test, env):
                    raise EvalError("assert failed during evaluation")
            else:
                raise EvalError(
                    f"unsupported statement {type(node).__name__}"
                )

    def _for(self, node: ast.For, env: dict) -> None:
        if node.orelse:
            raise EvalError("for/else unsupported")
        for item in self._iter(self.eval_expr(node.iter, env)):
            self._tick()
            self._bind(node.target, item, env)
            try:
                self._exec(node.body, env)
            except _Break:
                break
            except _Continue:
                continue

    @staticmethod
    def _iter(value):
        if isinstance(value, (list, tuple, range, str)) or hasattr(
            value, "__next__"
        ):
            return value
        raise EvalError(f"not iterable: {type(value).__name__}")

    def _assign(self, node, env: dict) -> None:
        if isinstance(node, ast.AugAssign):
            if not isinstance(node.target, ast.Name):
                raise EvalError("augmented assign to non-name")
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise EvalError("unsupported augmented op")
            cur = self._load_name(node.target.id, env)
            env[node.target.id] = op(cur, self.eval_expr(node.value, env))
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is None:
                raise EvalError("annotation without value")
            targets = [node.target]
            value = self.eval_expr(node.value, env)
        else:
            targets = node.targets
            value = self.eval_expr(node.value, env)
        for t in targets:
            self._bind(t, value, env)

    def _bind(self, target, value, env: dict) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = list(self._iter(value))
            if len(vals) != len(target.elts):
                raise EvalError("unpack length mismatch")
            for t, v in zip(target.elts, vals):
                self._bind(t, v, env)
        elif isinstance(target, ast.Subscript):
            obj = self.eval_expr(target.value, env)
            if not isinstance(obj, list):
                raise EvalError("subscript assignment to non-list")
            obj[self._index(target.slice, env)] = value
        else:
            raise EvalError(
                f"unsupported assignment target {type(target).__name__}"
            )

    def _load_name(self, name: str, env: dict):
        if name in env:
            return env[name]
        if name in ("True", "False", "None"):  # pre-3.8 trees only
            return {"True": True, "False": False, "None": None}[name]
        raise EvalError(f"unbound name {name!r}")

    def _index(self, node, env):
        return self.eval_expr(node, env)

    # -- expressions --------------------------------------------------------

    def eval_expr(self, node: ast.expr, env: dict):
        self._tick()
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, bool, str)) or node.value is None:
                return node.value
            raise EvalError(f"unsupported constant {node.value!r}")
        if isinstance(node, ast.Name):
            return self._load_name(node.id, env)
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise EvalError(
                    f"unsupported operator {type(node.op).__name__}"
                )
            try:
                return op(
                    self.eval_expr(node.left, env),
                    self.eval_expr(node.right, env),
                )
            except (TypeError, ZeroDivisionError, ValueError) as e:
                raise EvalError(str(e)) from None
        if isinstance(node, ast.UnaryOp):
            val = self.eval_expr(node.operand, env)
            if isinstance(node.op, ast.USub):
                return -val
            if isinstance(node.op, ast.UAdd):
                return +val
            if isinstance(node.op, ast.Not):
                return not val
            if isinstance(node.op, ast.Invert):
                return ~val
            raise EvalError("unsupported unary op")
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                val = True
                for v in node.values:
                    val = self.eval_expr(v, env)
                    if not val:
                        return val
                return val
            val = False
            for v in node.values:
                val = self.eval_expr(v, env)
                if val:
                    return val
            return val
        if isinstance(node, ast.Compare):
            left = self.eval_expr(node.left, env)
            for op, rhs in zip(node.ops, node.comparators):
                fn = _CMPOPS.get(type(op))
                if fn is None:
                    raise EvalError("unsupported comparison")
                right = self.eval_expr(rhs, env)
                try:
                    ok = fn(left, right)
                except TypeError as e:
                    raise EvalError(str(e)) from None
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return (
                self.eval_expr(node.body, env)
                if self.eval_expr(node.test, env)
                else self.eval_expr(node.orelse, env)
            )
        if isinstance(node, ast.Tuple):
            return tuple(self.eval_expr(e, env) for e in node.elts)
        if isinstance(node, ast.List):
            return [self.eval_expr(e, env) for e in node.elts]
        if isinstance(node, ast.Subscript):
            obj = self.eval_expr(node.value, env)
            if isinstance(node.slice, ast.Slice):
                s = node.slice
                lo = None if s.lower is None else self.eval_expr(s.lower, env)
                hi = None if s.upper is None else self.eval_expr(s.upper, env)
                st = None if s.step is None else self.eval_expr(s.step, env)
                try:
                    return obj[lo:hi:st]
                except TypeError as e:
                    raise EvalError(str(e)) from None
            idx = self.eval_expr(node.slice, env)
            try:
                return obj[idx]
            except (TypeError, IndexError, KeyError) as e:
                raise EvalError(str(e)) from None
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            out = self._comprehension(node, env)
            if isinstance(node, ast.SetComp):
                return set(out)
            return out
        if isinstance(node, ast.Call):
            return self._call(node, env)
        raise EvalError(f"unsupported expression {type(node).__name__}")

    def _comprehension(self, node, env: dict) -> list:
        out: list = []
        scope = dict(env)

        def rec(gens: list[ast.comprehension]):
            gen = gens[0]
            if gen.is_async:
                raise EvalError("async comprehension")
            for item in self._iter(self.eval_expr(gen.iter, scope)):
                self._tick()
                self._bind(gen.target, item, scope)
                if not all(
                    self.eval_expr(cond, scope) for cond in gen.ifs
                ):
                    continue
                if len(gens) > 1:
                    rec(gens[1:])
                else:
                    out.append(self.eval_expr(node.elt, scope))

        rec(node.generators)
        return out

    def _call(self, node: ast.Call, env: dict):
        for kw in node.keywords:
            if kw.arg is None:
                raise EvalError("**kwargs call unsupported")
        if any(isinstance(a, ast.Starred) for a in node.args):
            raise EvalError("*args call unsupported")
        args = [self.eval_expr(a, env) for a in node.args]
        kwargs = {
            kw.arg: self.eval_expr(kw.value, env) for kw in node.keywords
        }
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in env:
                raise EvalError(f"call through variable {func.id!r}")
            if func.id in _BUILTINS:
                try:
                    return _BUILTINS[func.id](*args, **kwargs)
                except (TypeError, ValueError) as e:
                    raise EvalError(str(e)) from None
            if func.id in self.functions:
                return self._call_def(self.functions[func.id], args, kwargs)
            raise EvalError(f"call to unknown function {func.id!r}")
        if isinstance(func, ast.Attribute):
            obj = self.eval_expr(func.value, env)
            allowed = _METHODS.get(type(obj), set())
            if func.attr not in allowed:
                raise EvalError(
                    f"method {type(obj).__name__}.{func.attr} unsupported"
                )
            try:
                return getattr(obj, func.attr)(*args, **kwargs)
            except (TypeError, ValueError, IndexError) as e:
                raise EvalError(str(e)) from None
        raise EvalError("unsupported call target")
