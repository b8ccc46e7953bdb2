"""Per-shard local sort: ``torch.sort`` and the block-bitonic kernel dispatch.

Counterpart of ``dsort_tpu/ops/local_sort.py``.  ``lax.sort`` is XLA's own
sort, not a Pallas kernel, so its fair counterpart here is ``torch.sort``
(the ``lax`` kernel name is kept so configs carry across unchanged).

Shapes: every function takes a 1-D tensor or a 2-D batch of rows and works
along the last axis, so the P shards of a `parallel.mesh.VirtualMesh` sort
in one call.  Padding convention as in the reference: pads hold
`sentinel_for` (the dtype's maximum) so an ascending sort parks them at the
tail and trimming by count recovers the valid keys.
"""

from __future__ import annotations

import numpy as np
import torch

LOCAL_KERNELS = ("auto", "lax", "block")

#: ``auto`` routes to the block kernel only from this row length up: below
#: it the block kernel would pay padding and launches for little work.
_AUTO_BLOCK_MIN = 1 << 16


def sentinel_for(dtype):
    """Largest representable value of ``dtype`` (torch or numpy) — the
    padding sentinel, as a Python scalar."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return float("inf")
    return int(np.iinfo(dtype).max)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis (``torch.sort``, unstable: equal
    keys are indistinguishable)."""
    return torch.sort(keys, dim=-1, stable=False).values


def resolve_kernel(kernel: str, dtype, n: int, device) -> str:
    """Resolve ``auto`` to a concrete kernel for rows of ``n`` keys.

    The reference's rule read on CUDA instead of the TPU: ``block`` for
    32/64-bit integer keys with ``n >= 2^16`` on a CUDA device, ``lax``
    (``torch.sort``) otherwise.  Floats stay on ``lax``: the min/max network
    would scramble NaNs; the pipelines pre-map floats through
    `ops.float_order`, so they still reach the block kernel.
    """
    if kernel != "auto":
        return kernel
    is_int = not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)
    return (
        "block"
        if (
            is_int
            and dtype.itemsize in (4, 8)
            and n >= _AUTO_BLOCK_MIN
            and torch.device(device).type == "cuda"
        )
        else "lax"
    )


def sort_with_kernel(keys: torch.Tensor, kernel: str = "auto") -> torch.Tensor:
    """Ascending sort along the last axis through one of the local kernels:
    ``auto`` (see `resolve_kernel`), ``lax`` (``torch.sort``) or ``block``
    (`ops.block_sort.block_sort`)."""
    if kernel == "auto":
        kernel = resolve_kernel(kernel, keys.dtype, keys.shape[-1], keys.device)
    if kernel == "lax":
        return sort_keys(keys)
    if kernel == "block":
        from dsort_tpu_torch.ops.block_sort import block_sort

        return block_sort(keys)
    if kernel in ("bitonic", "pallas", "radix"):
        raise NotImplementedError(
            f"local kernel {kernel!r} is not yet ported to dsort_tpu_torch"
        )
    raise ValueError(f"unknown local kernel {kernel!r}; options: {LOCAL_KERNELS}")


def sort_padded(
    keys: torch.Tensor, count, kernel: str = "lax"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort fixed-size rows whose first ``count`` entries are valid.

    ``count`` is an int or a tensor of per-row counts (shape ``keys.shape[:-1]``).
    Entries at positions >= ``count`` are overwritten with the sentinel
    before sorting; returns ``(sorted rows with pads at the tail, count)``.
    """
    count = torch.as_tensor(count, device=keys.device)
    pos = torch.arange(keys.shape[-1], device=keys.device)
    masked = torch.where(
        pos < count.unsqueeze(-1), keys,
        torch.full((), sentinel_for(keys.dtype), dtype=keys.dtype, device=keys.device),
    )
    return sort_with_kernel(masked, kernel), count
