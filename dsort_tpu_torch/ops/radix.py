"""LSD radix sort: the ``radix`` local kernel, in plain PyTorch.

Counterpart of ``dsort_tpu/ops/radix.py``, which is jnp (no Pallas), so
this is plain PyTorch too: a stable LSD counting sort, O(passes * n * 2^bits)
dense work, with the reference's bits:

- **key mapping**: every int / uint / float key maps to its ordered-unsigned
  bits (the sign-bit flip for signed ints, the sign fold for floats, which
  keeps each NaN's bit pattern: positive NaNs sort above +inf, negative
  NaNs below -inf, as in the reference).  PyTorch on CUDA has no arithmetic
  on uint32 / uint64, so those bits ride in the same-width *signed* dtype;
  a digit is ``(t >> shift) & mask``, masked after the shift because ``>>``
  on a signed tensor fills with the sign bit;
- **blocked digit pass**: per block of ``_MAX_BLOCK`` keys a one-hot
  ``(block, 2^bits)`` cumsum gives each key's rank among equal digits in
  its block and the block's digit histogram; blocks are processed in
  batches of at most ``_MAX_ONEHOT`` one-hot entries, so a pass's peak
  memory is bounded whatever ``n`` (a one-hot of a whole 2^23-key row would
  be 8 GiB);
- **stable permutation**: one scatter a pass to unique destinations;
  payload rows ride the same permutation.

Rows are padded to a block multiple with the all-ones key (the largest),
and stability keeps the pads after every real key equal to it, so trimming
back to ``n`` is exact, payloads included.  Sorts along the last axis and
batches over any leading axes, as `ops.local_sort.sort_with_kernel` does.
"""

from __future__ import annotations

import math

import torch

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)

_MAX_BLOCK = 8192  # keys a block: the reference's bound on the (block, B) one-hot
_MAX_ONEHOT = 1 << 27  # one-hot entries held at once (512 MiB of int32)


def _to_ordered_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection of any int / uint / float key into its
    ordered-unsigned bits, carried in the same-width signed dtype."""
    sdt = _SIGNED[x.element_size()]
    bits = x.contiguous().view(sdt)
    top = torch.iinfo(sdt).min  # the sign bit alone
    if x.dtype in _UNSIGNED:
        return bits
    if not x.dtype.is_floating_point:
        return bits ^ top
    # Float: negative (sign bit set) -> flip all bits so more-negative sorts
    # first; non-negative -> set the sign bit to sort above.
    return torch.where(bits < 0, ~bits, bits ^ top)


def _from_ordered_unsigned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_to_ordered_unsigned`."""
    top = torch.iinfo(t.dtype).min
    if dtype in _UNSIGNED:
        bits = t
    elif not dtype.is_floating_point:
        bits = t ^ top
    else:
        # Mapped non-negatives have the top bit set; mapped negatives not.
        bits = torch.where(t < 0, t ^ top, ~t)
    return bits.contiguous().view(dtype)


def _radix_pass(t: torch.Tensor, payloads: tuple, shift: int, bits: int, block: int):
    """One stable counting-sort pass of every row of ``t (R, n)`` on digit
    ``(t >> shift) & (2^bits - 1)``; ``n`` is a multiple of ``block``."""
    num_buckets = 1 << bits
    r, n = t.shape
    dev = t.device
    digits = (t >> shift).long() & (num_buckets - 1)  # mask in int64: 255 is no int8
    dig_blocks = digits.view(-1, block)  # every row's blocks, row-major
    bucket_ids = torch.arange(num_buckets, device=dev)
    rank_within = torch.empty_like(dig_blocks)
    block_hist = torch.empty((dig_blocks.shape[0], num_buckets), dtype=torch.long, device=dev)
    step = max(_MAX_ONEHOT // (block * num_buckets), 1)
    for s in range(0, dig_blocks.shape[0], step):
        d = dig_blocks[s : s + step]
        incl = (d.unsqueeze(-1) == bucket_ids).cumsum(1, dtype=torch.int32)
        rank_within[s : s + step] = incl.gather(2, d.unsqueeze(-1)).squeeze(-1) - 1
        block_hist[s : s + step] = incl[:, -1]
    block_hist = block_hist.view(r, n // block, num_buckets)
    # Keys of each digit in earlier blocks of the row, and the row's digit
    # offsets: the scan the reference carries across its blocks.
    base_hist = block_hist.cumsum(1) - block_hist
    total_hist = block_hist.sum(1)
    offsets = total_hist.cumsum(1) - total_hist
    blk = digits.view(r, n // block, block)
    dest = (
        offsets.gather(1, digits)
        + base_hist.gather(2, blk).view(r, n)
        + rank_within.view(r, n)
    )
    flat = (dest + torch.arange(r, device=dev).unsqueeze(1) * n).view(-1)

    def scatter(a):
        out = torch.empty_like(a)
        out.view((r * n,) + a.shape[2:]).index_copy_(0, flat, a.reshape((r * n,) + a.shape[2:]))
        return out

    return scatter(t), tuple(scatter(p) for p in payloads)


def _radix_argapply(t: torch.Tensor, payloads: tuple, bits_per_pass: int):
    """Run every digit pass over the rows of ``t (R, n)``; pads each row to
    a block multiple with the all-ones key (payload rows with zeros)."""
    n = t.shape[1]
    block = min(n, _MAX_BLOCK)
    padded = -(-n // block) * block
    if padded != n:
        r = t.shape[0]
        t = torch.cat([t, torch.full((r, padded - n), -1, dtype=t.dtype, device=t.device)], 1)
        payloads = tuple(
            torch.cat([p, p.new_zeros((r, padded - n) + p.shape[2:])], 1) for p in payloads
        )
    nbits = t.element_size() * 8
    for shift in range(0, nbits, bits_per_pass):
        bits = min(bits_per_pass, nbits - shift)
        t, payloads = _radix_pass(t, payloads, shift, bits, block)
    return t[:, :n], tuple(p[:, :n] for p in payloads)


def radix_sort(x: torch.Tensor, bits_per_pass: int = 8) -> torch.Tensor:
    """Ascending stable LSD radix sort along the last axis of an int / uint /
    float tensor, batched over any leading axes.  NaNs sort by bit pattern:
    positive ones above +inf, negative ones below -inf."""
    if x.dim() == 0:
        raise ValueError("radix_sort takes a tensor of at least one axis")
    n = x.shape[-1]
    if n <= 1:
        return x
    rows = _to_ordered_unsigned(x).reshape(-1, n)
    t, _ = _radix_argapply(rows, (), bits_per_pass)
    return _from_ordered_unsigned(t.reshape(x.shape), x.dtype)


def radix_sort_kv(
    keys: torch.Tensor, payload: torch.Tensor, bits_per_pass: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable key+payload radix sort along the keys' last axis; payload
    rows (shape ``keys.shape + (...)``) follow their keys, and equal keys
    keep their input order."""
    if keys.dim() == 0 or tuple(payload.shape[: keys.dim()]) != tuple(keys.shape):
        raise ValueError(
            "keys must have at least one axis and payload's leading dims must "
            f"match them: {tuple(keys.shape)} vs {tuple(payload.shape)}"
        )
    n = keys.shape[-1]
    if n <= 1:
        return keys, payload
    rows = math.prod(keys.shape[:-1])
    trailing = tuple(payload.shape[keys.dim() :])
    t, (out_v,) = _radix_argapply(
        _to_ordered_unsigned(keys).reshape(rows, n),
        (payload.reshape((rows, n) + trailing),), bits_per_pass,
    )
    return (
        _from_ordered_unsigned(t.reshape(keys.shape), keys.dtype),
        out_v.reshape(payload.shape),
    )
