"""Bitonic sorting network and merge tree in plain PyTorch.

Counterpart of ``dsort_tpu/ops/bitonic.py``.  The reference writes these in
jnp, outside any Pallas kernel, so here they are plain tensor code: a
compare-exchange pass at distance ``j`` views the row as ``(n/2j, 2, j)``,
which puts every pair ``(i, i + j)`` side by side, and orders the two
halves with ``torch.minimum`` / ``maximum`` (or a swap mask for key+value
pairs).  Passes update a buffer the function owns in place, so a merge level
keeps one working copy of the data.

Every function works along the last axis and batches over the leading
dims, so the P shards of a `parallel.mesh.VirtualMesh` take one call.  Keys
ride as signed ints (`ops.float_order.to_signed_keys`): unsigned keys
through the sign-bit flip (torch has no ``minimum`` for them), floats
through the order-preserving map, so NaNs sort last.  Lengths handed to the
merges are powers of two, as in the reference.
"""

from __future__ import annotations

import torch

from dsort_tpu_torch.ops.block_sort import _ceil_pow2, _is_pow2
from dsort_tpu_torch.ops.block_sort import _stage_plain as _pass  # one direction-aware stage
from dsort_tpu_torch.ops.float_order import from_signed_keys, to_signed_keys
from dsort_tpu_torch.ops.local_sort import sentinel_for


def _halves(x: torch.Tensor, j: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two members of every pair ``(i, i + j)`` of contiguous ``(...,
    n)`` rows, as views ``(rows, n/2j, j)``."""
    v = x.view(-1, x.shape[-1] // (2 * j), 2, j)
    return v[:, :, 0], v[:, :, 1]


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis through the full bitonic network.

    Rows pad to a power of two with the sentinel and trim, so the result
    equals ``torch.sort(x).values`` for every length.
    """
    n = x.shape[-1]
    if n <= 1:
        return x
    s = to_signed_keys(x)
    buf = torch.full(
        s.shape[:-1] + (_ceil_pow2(n),), sentinel_for(s.dtype), dtype=s.dtype, device=s.device
    )
    buf[..., :n] = s
    p = buf.shape[-1]
    rows = buf.view(-1, p)
    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            _pass(rows, k, j)
            j //= 2
        k *= 2
    return from_signed_keys(buf[..., :n].contiguous(), x.dtype)


def _merge_levels(x: torch.Tensor) -> torch.Tensor:
    """Distances ``n/2 .. 1``, all ascending, on bitonic ``(..., n)`` rows,
    in place: the merge half of the network.  Three launches a stage (a
    ``minimum``, a ``maximum`` into the second half, a copy back) where
    `_pass` takes six: the tree is the ``pallas`` path's largest device
    cost (PERF.md)."""
    j = x.shape[-1] // 2
    while j >= 1:
        a, b = _halves(x, j)
        lo = torch.minimum(a, b)
        torch.maximum(a, b, out=b)
        a.copy_(lo)
        j //= 2
    return x


def _check_runs(n: int, name: str) -> None:
    if not _is_pow2(n):
        raise ValueError(f"{name} needs power-of-two run lengths, got {n}")


def bitonic_merge_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ascending runs of equal power-of-two length ``(..., n)``
    into one ascending ``(..., 2n)``: ``[a, reversed(b)]`` is bitonic and
    the merge half of the network finishes it."""
    if a.shape != b.shape:
        raise ValueError(f"bitonic_merge_pair needs equal shapes, got {tuple(a.shape)}, {tuple(b.shape)}")
    _check_runs(a.shape[-1], "bitonic_merge_pair")
    x = torch.cat([to_signed_keys(a), to_signed_keys(b).flip(-1)], dim=-1)
    return from_signed_keys(_merge_levels(x), a.dtype)


def merge_sorted_runs(runs: torch.Tensor) -> torch.Tensor:
    """Merge ``(..., R, n)`` ascending runs (``R`` and ``n`` powers of two)
    into ``(..., R*n)`` by a ``log2(R)``-deep tree of pair merges; each
    level merges every pair of the batch at once."""
    r, n = runs.shape[-2], runs.shape[-1]
    if not _is_pow2(r):
        raise ValueError(f"merge_sorted_runs needs a power-of-two run count, got {r}")
    _check_runs(n, "merge_sorted_runs")
    s = to_signed_keys(runs)
    while s.shape[-2] > 1:
        s = _merge_levels(torch.cat([s[..., 0::2, :], s[..., 1::2, :].flip(-1)], dim=-1))
    return from_signed_keys(s[..., 0, :].contiguous(), runs.dtype)


def _merge_levels_kv(k: torch.Tensor, v: torch.Tensor) -> None:
    """`_merge_levels` on ``(key, value)`` pairs, in place: a pair swaps
    iff ``(k1 > k2) | ((k1 == k2) & (v1 > v2))`` (dsort_tpu/ops/bitonic.py:129),
    decided once from both members."""
    j = k.shape[-1] // 2
    while j >= 1:
        (k1, k2), (v1, v2) = _halves(k, j), _halves(v, j)
        swap = (k1 > k2) | ((k1 == k2) & (v1 > v2))
        second = torch.where(swap, k1, k2)
        k1.copy_(torch.where(swap, k2, k1))
        k2.copy_(second)
        second = torch.where(swap, v1, v2)
        v1.copy_(torch.where(swap, v2, v1))
        v2.copy_(second)
        j //= 2


def bitonic_merge_pair_kv(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key+value merge of two ``(key, value)``-ascending runs of equal
    power-of-two length.  With the value a global index the merge is
    stable, and sentinel pads carrying indices above every real entry trim
    exactly."""
    if not (ak.shape == av.shape == bk.shape == bv.shape):
        raise ValueError("bitonic_merge_pair_kv needs four equal shapes")
    _check_runs(ak.shape[-1], "bitonic_merge_pair_kv")
    k = torch.cat([to_signed_keys(ak), to_signed_keys(bk).flip(-1)], dim=-1)
    v = torch.cat([to_signed_keys(av), to_signed_keys(bv).flip(-1)], dim=-1)
    _merge_levels_kv(k, v)
    return from_signed_keys(k, ak.dtype), from_signed_keys(v, av.dtype)


def merge_sorted_runs_kv(
    keys: torch.Tensor, vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key+value tree merge of ``(..., R, n)`` ``(key, value)``-ascending
    runs (``R`` and ``n`` powers of two) into ``(..., R*n)`` each."""
    if keys.shape != vals.shape:
        raise ValueError(
            f"merge_sorted_runs_kv needs equal shapes, got {tuple(keys.shape)}, {tuple(vals.shape)}"
        )
    r, n = keys.shape[-2], keys.shape[-1]
    if not _is_pow2(r):
        raise ValueError(f"merge_sorted_runs_kv needs a power-of-two run count, got {r}")
    _check_runs(n, "merge_sorted_runs_kv")
    k, v = to_signed_keys(keys), to_signed_keys(vals)
    while k.shape[-2] > 1:
        k = torch.cat([k[..., 0::2, :], k[..., 1::2, :].flip(-1)], dim=-1)
        v = torch.cat([v[..., 0::2, :], v[..., 1::2, :].flip(-1)], dim=-1)
        _merge_levels_kv(k, v)
    return (
        from_signed_keys(k[..., 0, :].contiguous(), keys.dtype),
        from_signed_keys(v[..., 0, :].contiguous(), vals.dtype),
    )
