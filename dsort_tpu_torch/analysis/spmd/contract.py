"""Per-module ``SPMD_CONTRACT`` extraction and verification-domain plumbing.

Counterpart of ``dsort_tpu/analysis/spmd/contract.py``.  An
``SPMD_CONTRACT`` is a top-level PURE-LITERAL dict a module declares about
its own SPMD surface — which plane it is on (``device``/``host``), its
closed-form ``ppermute`` tables (``perms``) and shard-axis ``torch.roll``
shifts (``rolls``) with their expected destination forms, its per-step
slot layouts, its capacity functions with the properties each must
satisfy, and its receive-canvas re-pack obligations.  The checkers
(`checkers.spmd`, `checkers.caps`) PROVE the module against its contract
over the bounded domains in `spmd.registry`; the registry's per-file
minima make sure the contract cannot quietly shrink.
"""

from __future__ import annotations

import ast

from dsort_tpu_torch.analysis.spmd.symeval import EvalError, Evaluator


class ContractError(Exception):
    """A contract/registry is present but not a usable pure literal."""

    def __init__(self, lineno: int, msg: str):
        super().__init__(msg)
        self.lineno = lineno


#: The only keys a contract may carry (typo'd sections must not silently
#: verify nothing).
CONTRACT_KEYS = {
    "plane",
    "perms",
    "rolls",
    "layouts",
    "caps",
    "stores",
    "consts",
}

#: Registry names `load_spmd_registry` requires, with the type each must be.
_REGISTRY_SHAPE = {
    "MESH_SIZES": tuple,
    "SIZE_SAMPLES": tuple,
    "CAPS_SAMPLES": tuple,
    "SPMD_REQUIRED": tuple,
    "SPMD_REQUIRED_PERMS": dict,
    "SPMD_REQUIRED_ROLLS": dict,
    "SPMD_REQUIRED_LAYOUTS": dict,
    "SPMD_REQUIRED_CAPS": dict,
    "SPMD_REQUIRED_STORES": dict,
    "SPMD_REQUIRED_CONSTS": dict,
}


def extract_contract(tree: ast.AST) -> tuple[dict | None, int]:
    """The module's ``SPMD_CONTRACT`` literal and its line, else (None, 0).

    Raises `ContractError` when the assignment exists but is not a pure
    literal dict — a computed contract cannot be verified without running
    the tree, which the analysis plane never does.
    """
    for node in getattr(tree, "body", []):
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "SPMD_CONTRACT":
                try:
                    lit = ast.literal_eval(value)
                except (ValueError, SyntaxError, TypeError):
                    raise ContractError(
                        node.lineno,
                        "SPMD_CONTRACT must be a pure literal dict",
                    ) from None
                if not isinstance(lit, dict):
                    raise ContractError(
                        node.lineno, "SPMD_CONTRACT must be a dict"
                    )
                return lit, node.lineno
    return None, 0


def load_spmd_registry(path: str) -> dict:
    """Parse the declaration registry into ``{name: literal}``.

    Raises `ContractError` (anchored to the offending line, or 1) when the
    file is unreadable, unparseable, or misses a required declaration —
    the checkers turn that into a loud DS1200/DS1300, never a silent pass.
    """
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except OSError:
        raise ContractError(1, f"spmd registry unreadable: {path}") from None
    except SyntaxError as e:
        raise ContractError(
            e.lineno or 1, f"spmd registry syntax error: {e.msg}"
        ) from None
    out: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                try:
                    out[t.id] = ast.literal_eval(node.value)
                except (ValueError, SyntaxError, TypeError):
                    raise ContractError(
                        node.lineno,
                        f"registry declaration {t.id} is not a pure literal",
                    ) from None
    for name, kind in _REGISTRY_SHAPE.items():
        if not isinstance(out.get(name), kind):
            raise ContractError(
                1, f"registry misses {name} (expected {kind.__name__})"
            )
    return out


#: Domain-expression tokens that resolve to registry grids.
_DOMAIN_TOKENS = {
    "MESH": "MESH_SIZES",
    "SIZES": "SIZE_SAMPLES",
    "CAPS_SAMPLES": "CAPS_SAMPLES",
}


def iter_domain(domain: dict, registry: dict, ev: Evaluator):
    """Yield one env dict per point of the (ordered) domain product.

    Each value is either a registry token (``"MESH"``/``"SIZES"``/
    ``"CAPS_SAMPLES"``) or a Python expression over the names bound so far
    (``"range(num_workers)"``, ``"[d for d in ... if num_workers % d == 0]"``)
    evaluated by the restricted evaluator.  Raises `EvalError` on a domain
    expression outside the evaluable subset.
    """
    names = list(domain)

    def rec(i: int, env: dict):
        if i == len(names):
            yield dict(env)
            return
        name = names[i]
        spec = domain[name]
        if not isinstance(spec, str):
            raise EvalError(f"domain for {name!r} must be a string")
        token = _DOMAIN_TOKENS.get(spec)
        values = (
            registry[token] if token else ev.eval_str(spec, env)
        )
        if not isinstance(values, (list, tuple, range)):
            raise EvalError(f"domain for {name!r} is not a sequence")
        for v in values:
            env[name] = v
            yield from rec(i + 1, env)
        env.pop(name, None)

    yield from rec(0, {})


def module_const_env(tree: ast.AST, ev: Evaluator) -> dict:
    """Best-effort env of a module's top-level constant assignments.

    Evaluates each top-level ``NAME = <expr>`` with the restricted
    evaluator against the names bound so far (so ``1 << 18`` and derived
    constants resolve); unevaluable assignments are simply skipped — the
    consts checks report a missing name loudly.
    """
    env: dict = {}
    for node in getattr(tree, "body", []):
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                try:
                    env[t.id] = ev.eval_expr(value, env)
                except EvalError:
                    pass
    return env
