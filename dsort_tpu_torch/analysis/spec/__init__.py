"""The spec plane, the counterpart of ``dsort_tpu/analysis/spec``: three
pieces, all stdlib-only at import time (the analysis layer's contract,
DS601, keeps torch and numpy out):

- `machines`: the fleet protocol's controller-side and agent-side job
  lifecycles and the serve admission lifecycle as pure-literal state
  machines (`PROTOCOL_SPEC`, `SPEC_INVARIANTS`), cross-checked against
  the port's handlers by the DS10xx checkers;
- `contracts`: the journal trace contracts (`TRACE_CONTRACTS`), their
  replay engine (``cli report --conform``, `assert_conformant`), linted by
  the DS11xx checkers;
- `model`: the bounded explicit-state model checker behind ``cli spec
  check`` / ``replay``: every interleaving of frame delivery,
  duplication, agent death and controller crash within a bound, over the
  port's `ControlPolicy`, against `SPEC_INVARIANTS`, with minimized,
  deterministically replayable violation fixtures.  It is imported on
  use, not here.
"""

from dsort_tpu_torch.analysis.spec.contracts import (  # noqa: F401
    CONTRACT_EXEMPT,
    TRACE_CONTRACTS,
    assert_conformant,
    compile_contract,
    conformance_report,
    format_conformance,
)
from dsort_tpu_torch.analysis.spec.machines import PROTOCOL_SPEC, SPEC_INVARIANTS  # noqa: F401
