"""The virtual mesh: P shards as the leading axis of one tensor on one device.

Counterpart of ``dsort_tpu/parallel/mesh.py``'s 1-D worker mesh.  Where the
reference runs one program per device under ``shard_map``, this package
batches the P shards as rows, so the collectives become layout changes:
``all_gather`` of per-shard ``(P, s)`` rows is a reshape to ``(P*s,)``, and
``all_to_all`` of the ``(P_src, P_dst, cap)`` send buffer is a transpose to
``(P_dst, P_src, cap)``.
"""

from __future__ import annotations

import torch

from dsort_tpu_torch.device import resolve_device


class VirtualMesh:
    """``num_workers`` shards on one device (``cuda`` unless ``cpu`` is asked)."""

    def __init__(self, num_workers: int, device=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = int(num_workers)
        self.device = resolve_device(device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-shard rows ``(P, s)`` -> the tiled ``(P*s,)`` every shard sees."""
        return x.reshape(-1)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``(P_src, P_dst, ...)`` -> ``(P_dst, P_src, ...)``: row d of the
        result is what shard d receives, ordered by source."""
        return send.transpose(0, 1).contiguous()
