"""Project-native static analysis of the port (``cli lint``).

Counterpart of ``dsort_tpu/analysis/``, its own copy, read on the port's
own tree: event and counter names resolve against ``utils.events`` on both
sides of the Python/C++ boundary (``runtime/native/coordinator.cpp``),
lock-guarded state stays under its lock, functions handed to
``torch.compile`` / ``torch.jit`` / a CUDA graph capture stay free of host
side effects, recovery paths do not swallow errors, the fleet control
plane and the analysis package never import torch, persisted state is
written tmp + fsync + rename, frames and admission reasons resolve against
their registries, threads do not outlive their owners, the fleet handlers
match the protocol spec (`spec.machines`) and every journal emission
belongs to a trace contract (`spec.contracts`), and the exchanges' closed
forms — ring shifts, hier ``ppermute`` tables, per-step slot layouts and
cap ladders — are proven over bounded grids (`spmd`).  All of it by
parsing the tree, never importing it: this package is stdlib-only, so
linting never imports torch or touches a device.

Entry points: ``python -m dsort_tpu_torch.cli lint`` (CLI), `lint_paths`
(API), `all_checkers` / `checker_catalog` (rule catalog).  Suppression:
``# dsort: ignore[DSxxx]``.  The configuration — enabled checkers,
baseline, layer contracts — is `core.ENABLE` / `core.BASELINE` /
`core.LAYERS`; the result cache is ``.lint-cache.torch.json``.

Codes of the reference's catalog with nothing to read on the port
(`checkers.SKIPPED`):

- DS302 (a traced value in a Pallas grid): the port's launch geometry is
  computed in C++ from tensor shapes.
- DS501 / DS502 (the JAX version shim's x64 switch and ``shard_map``): the
  port has no JAX and no version shim; ``tests/test_torch_imports.py``
  pins the no-JAX rule.
- DS901 / DS902 (Pallas remote-DMA start/wait pairing): no CUDA kernel of
  the port starts an asynchronous copy (no ``cp.async``,
  ``memcpy_async`` or TMA).
- DS1203 (a collective's mesh-axis name): the port's mesh is one unnamed
  axis.
"""

from dsort_tpu_torch.analysis.core import (  # noqa: F401
    Diagnostic,
    LintConfig,
    load_baseline,
    load_config,
    write_baseline,
)
from dsort_tpu_torch.analysis.engine import (  # noqa: F401
    CACHE_NAME,
    Checker,
    LintStats,
    format_json,
    format_sarif,
    format_text,
    lint_paths,
)
from dsort_tpu_torch.analysis.checkers import (  # noqa: F401
    SKIPPED,
    all_checkers,
    checker_catalog,
)
