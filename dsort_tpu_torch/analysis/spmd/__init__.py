"""SPMD semantics verifier: the symbolic plane behind the DS12xx/DS13xx rules.

Counterpart of ``dsort_tpu/analysis/spmd/``.  The port's exchanges are
built on closed-form schedules — the ring's shard-axis ``torch.roll``
shifts, the hierarchical plane's ``mesh.ppermute`` tables, static slot
offsets — and on a no-retry capacity doctrine ("ring-path overflow is an
invariant violation").  This package lets the lint pass verify them
statically:

- `symeval`: a restricted, stdlib-only evaluator for the pure closed-form
  functions the schedules are built from.  It interprets the AST of THE
  TREE BEING LINTED — never imports it.
- `registry`: the pure-literal declaration registry — bounded verification
  domains, the modules REQUIRED to carry an ``SPMD_CONTRACT``, and the
  minimum each contract must declare (so deleting a declaration cannot
  silence a proof).
- `contract`: extraction of per-module ``SPMD_CONTRACT`` literals and the
  domain-grid iteration shared by both checker families.

The checkers live in `dsort_tpu_torch.analysis.checkers.spmd` (DS12xx,
collective schedules) and `dsort_tpu_torch.analysis.checkers.caps`
(DS13xx, capacity/layout interval checks).
"""

from __future__ import annotations

from dsort_tpu_torch.analysis.spmd.contract import (
    ContractError,
    extract_contract,
    load_spmd_registry,
)
from dsort_tpu_torch.analysis.spmd.symeval import EvalError, Evaluator, extract_functions

__all__ = [
    "ContractError",
    "EvalError",
    "Evaluator",
    "extract_contract",
    "extract_functions",
    "load_spmd_registry",
]
