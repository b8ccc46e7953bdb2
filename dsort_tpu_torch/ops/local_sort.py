"""Per-shard local sort: ``torch.sort`` and the local kernel dispatch.

Counterpart of ``dsort_tpu/ops/local_sort.py``.  ``lax.sort`` is XLA's own
sort, not a Pallas kernel, so its fair counterpart here is ``torch.sort``
(the ``lax`` kernel name is kept so configs carry across unchanged).  The
other kernels: ``block`` (`ops.block_sort`), ``bitonic`` (`ops.bitonic`,
plain PyTorch as the reference's is jnp), ``pallas`` (`ops.pallas_sort`,
the tile kernel plus the bitonic merge tree) and ``radix`` (`ops.radix`,
plain PyTorch as the reference's is jnp).

Shapes: every function takes a 1-D tensor or a 2-D batch of rows and works
along the last axis, so the P shards of a `parallel.mesh.VirtualMesh` sort
in one call.  Padding convention as in the reference: pads hold
`sentinel_for` (the dtype's maximum) so an ascending sort parks them at the
tail and trimming by count recovers the valid keys.  The key+payload
sorts (`sort_kv`, `sort_kv_padded`, `sort_kv2_padded`) follow at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOCAL_KERNELS = ("auto", "lax", "block", "bitonic", "pallas", "radix")

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


def widened_keys(sort_fn, keys: torch.Tensor) -> torch.Tensor:
    """``sort_fn(keys)`` for the 32/64-bit kernels, whatever the key width.

    8- and 16-bit keys (int8, uint8, int16, uint16, float16) take their
    signed carrier (`ops.float_order.to_signed_keys`), widen to int32 (an
    order-preserving cast), sort, and narrow back: the kernels take 32- and
    64-bit keys only, and the reference sorts these dtypes too.
    """
    if keys.dtype.itemsize >= 4:
        return sort_fn(keys)
    from dsort_tpu_torch.ops.float_order import from_signed_keys, to_signed_keys

    s = to_signed_keys(keys)
    return from_signed_keys(sort_fn(s.to(torch.int32)).to(s.dtype), keys.dtype)


def sort_with_kernel(keys: torch.Tensor, kernel: str = "auto") -> torch.Tensor:
    """Ascending sort along the last axis through one of the local kernels:
    ``auto`` (see `resolve_kernel`), ``lax`` (``torch.sort``), ``block``
    (`ops.block_sort.block_sort`), ``bitonic`` (`ops.bitonic.bitonic_sort`)
    ``pallas`` (`ops.pallas_sort.pallas_sort`) or ``radix``
    (`ops.radix.radix_sort`); ``block`` and ``pallas`` take 8- and 16-bit
    keys through `widened_keys`.  ``auto`` never picks ``radix``."""
    if kernel == "auto":
        kernel = resolve_kernel(kernel, keys.dtype, keys.shape[-1], keys.device)
    if kernel == "lax":
        return sort_keys(keys)
    if kernel == "block":
        from dsort_tpu_torch.ops.block_sort import block_sort

        return widened_keys(block_sort, keys)
    if kernel == "bitonic":
        from dsort_tpu_torch.ops.bitonic import bitonic_sort

        return bitonic_sort(keys)
    if kernel == "pallas":
        from dsort_tpu_torch.ops.pallas_sort import pallas_sort

        return widened_keys(pallas_sort, keys)
    if kernel == "radix":
        from dsort_tpu_torch.ops.radix import radix_sort

        return radix_sort(keys)
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


# -- key + payload (records) -------------------------------------------------
#
# ``torch.sort`` has no multi-key form.  A lexicographic order is built from
# stable sorts, last key first; every permutation comes back as indices and
# the payload rows follow through one `_apply_perm`.  As in the reference
# these are the framework sort on every device (the JAX ``sort_kv_padded``
# is ``lax.sort``), never the block kernels.


def _apply_perm(payload: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute ``payload (*lead, m, *trail)`` along the axis after
    ``perm``'s leading dims: ``perm (*lead, n)`` of row indices in
    ``[0, m)`` -> ``(*lead, n, *trail)``.  One ``index_select`` of whole
    rows (no index expanded over the trailing dims)."""
    lead, n = tuple(perm.shape[:-1]), perm.shape[-1]
    m, trail = payload.shape[len(lead)], tuple(payload.shape[len(lead) + 1 :])
    b = math.prod(lead)
    base = torch.arange(b, device=perm.device).unsqueeze(1) * m
    flat = (perm.reshape(b, n).long() + base).reshape(-1)
    return payload.reshape((b * m,) + trail).index_select(0, flat).reshape(lead + (n,) + trail)


def _stable_order(key: torch.Tensor, perm: torch.Tensor | None = None) -> torch.Tensor:
    """Indices that stably sort ``key`` (taken through ``perm`` when given)
    along the last axis, composed with ``perm``."""
    from dsort_tpu_torch.ops.float_order import to_signed_keys

    k = to_signed_keys(key) if key.dtype != torch.bool else key.to(torch.int8)
    if perm is None:
        return torch.sort(k, dim=-1, stable=True).indices
    order = torch.sort(k.gather(-1, perm), dim=-1, stable=True).indices
    return perm.gather(-1, order)


def sort_kv(
    keys: torch.Tensor, payload: torch.Tensor, stable: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort ``keys`` ascending along the last axis, permuting ``payload``
    rows (shape ``keys.shape + (...)``, or ``keys.shape``) with them.
    ``stable=True`` keeps equal-key records in input order."""
    out_k, perm = torch.sort(keys, dim=-1, stable=stable)
    return out_k, _apply_perm(payload, perm)


def _masked(keys: torch.Tensor, count) -> tuple[torch.Tensor, torch.Tensor]:
    count = torch.as_tensor(count, device=keys.device)
    is_pad = torch.arange(keys.shape[-1], device=keys.device) >= count.unsqueeze(-1)
    sent = torch.full((), sentinel_for(keys.dtype), dtype=keys.dtype, device=keys.device)
    return torch.where(is_pad, sent, keys), is_pad


def sort_kv_padded(
    keys: torch.Tensor, payload: torch.Tensor, count
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key+payload `sort_padded`, reserving no key value: the order is
    ``(key, is_pad)``, so real keys equal to the sentinel keep their
    payloads ahead of the pads.  Pads sit at the tail positions, so one
    stable sort of the sentinel-masked keys already gives that order.
    Returns ``(keys, payload, count)``."""
    masked, _ = _masked(keys, count)
    perm = _stable_order(masked)
    return masked.gather(-1, perm), _apply_perm(payload, perm), torch.as_tensor(count)


def sort_kv2_padded(
    keys: torch.Tensor, secondary: torch.Tensor, payload: torch.Tensor, count
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level `sort_kv_padded`: the order is ``(key, is_pad,
    secondary)`` (TeraSort's 8-byte prefix, then key bytes 8-9), by stable
    sorts from the last key to the first.  Returns ``(keys, secondary,
    payload, count)``, all permuted together."""
    masked, is_pad = _masked(keys, count)
    perm = _stable_order(secondary)
    perm = _stable_order(is_pad, perm)
    perm = _stable_order(masked, perm)
    return (
        masked.gather(-1, perm), secondary.gather(-1, perm),
        _apply_perm(payload, perm), torch.as_tensor(count),
    )


def sort_pairs(
    keys: torch.Tensor, tags: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic ``(key, tag)`` ascending sort along the last axis (the
    reference's two-key ``lax.sort``): stable by tag, then stable by key.
    Returns both, permuted."""
    perm = _stable_order(keys, _stable_order(tags))
    return keys.gather(-1, perm), tags.gather(-1, perm)
