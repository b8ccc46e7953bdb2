"""Checker registry: every project-native rule, one instance each.

Counterpart of ``dsort_tpu/analysis/checkers/__init__.py``.  Adding a
checker = adding a class with ``name``/``codes``/``scope``/``check`` (or
``project = True`` + ``check_project`` for a cross-file rule) and listing
it here; the engine, the CLI, the SARIF rule table and the lint tests pick
it up from this one function.

`SKIPPED` is the other half of the catalog: each code of the reference's
catalog that has nothing to read on the port's tree, with the reason.  A
reference code is in exactly one of the two places.
"""

from __future__ import annotations

from dsort_tpu_torch.analysis.checkers.caps import CapsChecker
from dsort_tpu_torch.analysis.checkers.concurrency import ConcurrencyChecker
from dsort_tpu_torch.analysis.checkers.durability import DurabilityChecker
from dsort_tpu_torch.analysis.checkers.exceptions import ExceptionsChecker
from dsort_tpu_torch.analysis.checkers.layers import LayersChecker
from dsort_tpu_torch.analysis.checkers.lifecycle import LifecycleChecker
from dsort_tpu_torch.analysis.checkers.protocol import ProtocolChecker
from dsort_tpu_torch.analysis.checkers.registry import RegistryChecker
from dsort_tpu_torch.analysis.checkers.spec import SpecChecker
from dsort_tpu_torch.analysis.checkers.spmd import SpmdChecker
from dsort_tpu_torch.analysis.checkers.tracing import TracingChecker

#: Reference codes with no reading on the port, and why.
SKIPPED = {
    "DS302": "a traced value in a Pallas grid: the port's launch geometry "
             "is computed in C++ from tensor shapes, never from a traced "
             "value",
    "DS501": "jax_enable_x64 toggled outside utils/compat.py: the port has "
             "no JAX and no version shim (tests/test_torch_imports.py pins "
             "the no-JAX rule)",
    "DS502": "raw shard_map import outside utils/compat.py: the port has "
             "no shard_map and no version shim",
    "DS901": "a Pallas remote DMA started but never waited: no csrc kernel "
             "starts an asynchronous copy (no cp.async, memcpy_async or "
             "TMA); the ring exchange writes remote slots with plain stores",
    "DS902": "a Pallas remote DMA drained in one direction only: no "
             "asynchronous copy exists to drain (see DS901)",
    "DS1203": "a collective's mesh-axis name: the port's mesh is one "
              "unnamed axis (VirtualMesh / ProcessGroupMesh collectives "
              "take no axis name)",
}


def all_checkers():
    return [
        RegistryChecker(),
        ConcurrencyChecker(),
        TracingChecker(),
        ExceptionsChecker(),
        LayersChecker(),
        DurabilityChecker(),
        ProtocolChecker(),
        LifecycleChecker(),
        SpecChecker(),
        SpmdChecker(),
        CapsChecker(),
    ]


def checker_catalog() -> dict[str, dict[str, str]]:
    """{checker name: {code: description}} — the documented rule set."""
    return {c.name: dict(c.codes) for c in all_checkers()}
