"""The multi-tenant serving layer.

Counterpart of ``dsort_tpu/serve``: jobs are submitted (non-blocking)
through typed admission control, queued per tenant, scheduled by weighted
deficit round robin and dispatched concurrently — small jobs packed onto
slices of the virtual mesh, each slice with a CUDA stream of its own, big
jobs onto the whole mesh through the SPMD scheduler — with the variant
cache keyed on the capacity ladder.

`admission`, `fair`, `policy` and `variants` are pure (stdlib and numpy);
`service` pulls torch and the schedulers and is imported lazily here, so
``from dsort_tpu_torch.serve import ControlPolicy`` stays light.
"""

from dsort_tpu_torch.serve.admission import (  # noqa: F401
    ADMISSION_REASONS,
    Admission,
    AdmissionController,
)
from dsort_tpu_torch.serve.fair import DeficitRoundRobin, parse_weights  # noqa: F401
from dsort_tpu_torch.serve.policy import ControlPolicy  # noqa: F401
from dsort_tpu_torch.serve.variants import VariantCache, fused_variant_key  # noqa: F401

_SERVICE_NAMES = ("JobTicket", "ServiceClosed", "SortService")


def __getattr__(name):  # PEP 562: lazy, so the control plane stays light
    if name in _SERVICE_NAMES:
        from dsort_tpu_torch.serve import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SERVICE_NAMES))
