"""The fleet plane: a control process routing sort jobs over agents on the
card.

Counterpart of ``dsort_tpu/fleet/``: `controller` (the pure control plane:
admission, weighted-DRR fairness, SLO shedding, routing, restart-safe
persistence; no torch) routes jobs over `agent` endpoints (each a
`serve.SortService` over its own virtual workers on the card), speaking
framed JSON over TCP (`proto`), byte for byte the reference's frames, so
either package's controller drives either package's agents.

Import layering: `proto` and `controller` stay torch-free (the controller
runs in a process that never imports torch: test-enforced); `agent` pulls
the sort path and is therefore exported lazily.
"""

from dsort_tpu_torch.fleet.proto import (  # noqa: F401
    FLEET_SMALL_JOB_MAX,
    FRAME_TYPES,
    ProtocolError,
    fused_rung,
    parse_agent_addrs,
)
from dsort_tpu_torch.fleet.controller import (  # noqa: F401
    ControllerClosed,
    FleetController,
    FleetTicket,
    ROUTING_POLICIES,
)

_AGENT_NAMES = ("FleetAgent",)


def __getattr__(name):  # PEP 562: the agent side imports torch
    if name in _AGENT_NAMES:
        from dsort_tpu_torch.fleet import agent

        return getattr(agent, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_AGENT_NAMES))
