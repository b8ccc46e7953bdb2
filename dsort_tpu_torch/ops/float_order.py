"""Order-preserving float <-> signed-int key bijection (NaN-safe sorting).

Counterpart of ``dsort_tpu/ops/float_order.py``.  The reference maps float
keys to same-width *unsigned* ints whose unsigned order is the float order
(NaN -> all ones, negatives -> ``~bits``, positives -> ``bits | sign``).
PyTorch has no ``minimum``, ``>>`` or ``searchsorted`` for ``uint32`` /
``uint64``, so this package carries keys as *signed* ints: the reference's
unsigned mapping followed by the sign-bit flip (the trick of
``dsort_tpu/ops/block_sort.py``'s unsigned path).  Composed, the two are

- NaN (any sign, any payload) -> the signed maximum, so NaNs sort last and
  come back canonical (``np.nan``'s bits), one NaN out per NaN in;
- negative floats -> ``bits ^ signed_max`` (more negative sorts first);
- non-negative floats -> ``bits`` unchanged.

-0.0 orders just before +0.0; ±0.0, ±inf and subnormals round-trip
bit-exactly.  `unsigned_to_signed` / `signed_to_unsigned` are the plain
sign-bit flip for unsigned integer keys.  `float_to_ordered_uint` is the
reference's carrier, derived from the signed one by that flip;
`sort_float_keys_via_uint` is the one float boundary every host entry point
goes through, and `sort_narrow_keys_via_int32` the boundary of 8- and
16-bit integer keys.
"""

from __future__ import annotations

import numpy as np
import torch

_FLOAT_TO_INT = {
    torch.float16: torch.int16,
    torch.float32: torch.int32,
    torch.float64: torch.int64,
}
_UNSIGNED_TO_SIGNED = {
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}


def is_float_key_dtype(dtype) -> bool:
    """True for key dtypes that need the ordered-int boundary mapping."""
    return dtype in _FLOAT_TO_INT


def _signed_max(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def float_to_ordered_int(x: torch.Tensor) -> torch.Tensor:
    """Map a float tensor to signed ints whose order is the float order."""
    idt = _FLOAT_TO_INT.get(x.dtype)
    if idt is None:
        raise TypeError(f"not a float key dtype: {x.dtype}")
    b = x.contiguous().view(idt)
    top = _signed_max(idt)
    m = torch.where(b < 0, b ^ top, b)
    return torch.where(torch.isnan(x), torch.full_like(m, top), m)


def ordered_int_to_float(m: torch.Tensor, float_dtype) -> torch.Tensor:
    """Inverse of `float_to_ordered_int` (NaNs come back canonical)."""
    idt = _FLOAT_TO_INT[float_dtype]
    if m.dtype != idt:
        # Value-casting keys that never went through the bijection would
        # silently corrupt them: fail loudly instead.
        raise TypeError(f"expected {idt} mapped keys, got {m.dtype}")
    top = _signed_max(idt)
    b = torch.where(m < 0, m ^ top, m)
    out = b.contiguous().view(float_dtype)
    nan = torch.full_like(out, float("nan"))
    return torch.where(m == top, nan, out)


def unsigned_to_signed(u: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned -> signed map: flip the sign bit."""
    sdt = _UNSIGNED_TO_SIGNED.get(u.dtype)
    if sdt is None:
        raise TypeError(f"not an unsigned key dtype: {u.dtype}")
    return u.contiguous().view(sdt) ^ torch.iinfo(sdt).min


def signed_to_unsigned(s: torch.Tensor, unsigned_dtype) -> torch.Tensor:
    """Inverse of `unsigned_to_signed`."""
    sdt = _UNSIGNED_TO_SIGNED[unsigned_dtype]
    if s.dtype != sdt:
        raise TypeError(f"expected {sdt} mapped keys, got {s.dtype}")
    return (s ^ torch.iinfo(sdt).min).contiguous().view(unsigned_dtype)


def to_signed_keys(x: torch.Tensor) -> torch.Tensor:
    """Any supported key tensor -> its signed carrier (identity for signed
    ints, the sign flip for unsigned, the float bijection for floats)."""
    if is_float_key_dtype(x.dtype):
        return float_to_ordered_int(x)
    if x.dtype in _UNSIGNED_TO_SIGNED:
        return unsigned_to_signed(x)
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(f"unsupported key dtype {x.dtype}")
    return x


def from_signed_keys(s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `to_signed_keys` for the original key ``dtype``."""
    if is_float_key_dtype(dtype):
        return ordered_int_to_float(s, dtype)
    if dtype in _UNSIGNED_TO_SIGNED:
        return signed_to_unsigned(s, dtype)
    return s


# -- the reference's carrier: ordered uints ------------------------------
#
# The reference carries float keys as same-width unsigned ints whose
# unsigned order is the float order.  They are the signed carrier above
# with its sign bit flipped, so the one bijection is `float_to_ordered_int`.
# Every float host entry point, and every store that persists float keys
# (manifest ``storage_dtype`` "uint32" / "uint64"), goes through them, so a
# store either package wrote resumes in the other; on the device the keys
# ride as signed ints again (`unsigned_to_signed`).

_NP_FLOATS = (np.dtype(np.float16), np.dtype(np.float32), np.dtype(np.float64))


def is_float_np_dtype(dtype) -> bool:
    """True for the numpy float key dtypes the ordered-uint map takes."""
    return np.dtype(dtype) in _NP_FLOATS


def ordered_uint_dtype(float_dtype) -> np.dtype:
    """The unsigned dtype a float key dtype maps to (same width)."""
    return np.dtype(f"u{np.dtype(float_dtype).itemsize}")


def _sign_bit(udtype: np.dtype):
    return udtype.type(1 << (8 * udtype.itemsize - 1))


def float_to_ordered_uint(x: np.ndarray) -> np.ndarray:
    """Host float keys -> the reference's ordered uints: `float_to_ordered_int`
    with the sign bit flipped (NaN -> all ones, negatives -> ``~bits``,
    others -> ``bits | sign``)."""
    x = np.ascontiguousarray(x)
    if not is_float_np_dtype(x.dtype):
        raise TypeError(f"not a float key dtype: {x.dtype}")
    if not x.flags.writeable:  # a read-only memmap; torch wants a writable buffer
        x = x.copy()
    udtype = ordered_uint_dtype(x.dtype)
    return float_to_ordered_int(torch.from_numpy(x)).numpy().view(udtype) ^ _sign_bit(udtype)


def ordered_uint_to_float(m: np.ndarray, float_dtype) -> np.ndarray:
    """Inverse of `float_to_ordered_uint` (NaNs come back canonical)."""
    fdt = np.dtype(float_dtype)
    udtype = ordered_uint_dtype(fdt)
    m = np.asarray(m)
    if m.dtype != udtype:
        raise TypeError(f"expected {udtype} mapped keys, got {m.dtype}")
    s = (m ^ _sign_bit(udtype)).view(f"i{udtype.itemsize}")
    tdt = torch.from_numpy(np.empty(0, fdt)).dtype
    return ordered_int_to_float(torch.from_numpy(s), tdt).numpy()


def sort_float_keys_via_uint(sort_fn, keys: np.ndarray, *args, **kwargs):
    """Run a sort of float host keys through the ordered uints: map,
    ``sort_fn(mapped, *args, **kwargs)``, unmap.

    ``sort_fn`` returns the sorted keys, or a tuple whose first element is
    the sorted keys (key+payload drivers).
    """
    keys = np.asarray(keys)
    out = sort_fn(float_to_ordered_uint(keys), *args, **kwargs)
    if isinstance(out, tuple):
        return (ordered_uint_to_float(out[0], keys.dtype),) + out[1:]
    return ordered_uint_to_float(out, keys.dtype)


def is_narrow_int_dtype(dtype) -> bool:
    """True for numpy integer key dtypes under 32 bits (int8, uint8, int16,
    uint16): the kernels and the fused ring take 32- and 64-bit keys."""
    dtype = np.dtype(dtype)
    return dtype.kind in "iu" and dtype.itemsize < 4


def sort_narrow_keys_via_int32(sort_fn, keys: np.ndarray, *args, **kwargs):
    """Run a sort of 8- or 16-bit integer host keys as int32: widen (every
    value fits, so the order is kept), ``sort_fn(wide, *args, **kwargs)``,
    narrow back.  Float16 keys reach it as their uint16 carrier, through
    `sort_float_keys_via_uint`.  ``sort_fn`` returns the sorted keys, or a
    tuple whose first element is the sorted keys."""
    keys = np.asarray(keys)
    out = sort_fn(keys.astype(np.int32), *args, **kwargs)
    if isinstance(out, tuple):
        return (out[0].astype(keys.dtype),) + out[1:]
    return out.astype(keys.dtype)


def narrow_from_int32(wide: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The device side of `sort_narrow_keys_via_int32`: int32 keys that hold
    ``dtype`` values, with int32-sentinel pads, back to ``dtype`` on their
    device.  Pads clamp to ``dtype``'s maximum first (a plain cast would
    wrap the sentinel to -1); uint16 goes through its int16 carrier and a
    view, since PyTorch's uint16 has only partial operator support."""
    top = torch.iinfo(dtype).max
    if dtype == torch.uint16:
        return signed_to_unsigned((wide.clamp(max=top) - (1 << 15)).to(torch.int16), dtype)
    return wide.clamp(max=top).to(dtype)
