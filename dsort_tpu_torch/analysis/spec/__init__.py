"""The spec plane: the fleet protocol's state machines (`machines`) and
the journal trace contracts (`contracts`), both pure literals the DS10xx /
DS11xx checkers parse, and the contracts' replay engine."""

from dsort_tpu_torch.analysis.spec.contracts import (  # noqa: F401
    CONTRACT_EXEMPT,
    TRACE_CONTRACTS,
    assert_conformant,
    compile_contract,
    conformance_report,
    format_conformance,
)
from dsort_tpu_torch.analysis.spec.machines import PROTOCOL_SPEC, SPEC_INVARIANTS  # noqa: F401
