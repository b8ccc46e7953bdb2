"""Device resolution — the counterpart of ``dsort_tpu``'s ``_on_tpu()`` seam.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  With no CUDA present and no explicit
CPU request they raise: a sort never falls back to the CPU quietly.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu`` only
    when asked.  Raises when CUDA is asked for (or defaulted to) but absent."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU (the plain PyTorch versions of the kernels)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_scope(device: torch.device):
    """Make ``device`` current on the calling thread (a scheduler's lane
    thread included), so a kernel wrapper's ``current_stream`` never
    assumes which card is current; a no-op for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
