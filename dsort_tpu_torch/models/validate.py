"""Sort-output validation: order plus a permutation checksum.

Counterpart of ``dsort_tpu/models/validate.py`` (the valsort role of the
TeraSort tool suite):

- **order**: the output's keys are nondecreasing (TeraSort records compare
  as big-endian byte strings over the 10-byte key);
- **permutation**: an order-independent multiset checksum — the sum mod
  2^64 of every record's FNV-1a hash — over input and output proves the
  output is exactly a permutation of the input: no record dropped,
  duplicated or corrupted.

Binary TeraSort and raw key files stream in bounded chunks (each chunk's
first key is compared with the previous chunk's last), with the
reference's chunk sizes, so a violation at a chunk boundary reports the
same index.  ASCII int files are read whole, as the sort reads them.

The reference hashes through its native C++ library where it is built and
through a numpy byte-column sweep otherwise; both give the same bits, and
this package keeps the numpy sweep only (`_multiset`).  Likewise the order
check of TeraSort chunks is a vectorised numpy compare of ``(8-byte prefix,
bytes 8-9)`` pairs, which returns the index the reference's record-by-record
compare returns.

The device side (`validate_device_result`) runs the same order check and
checksum over a `parallel.device_result.DeviceSortResult`'s ``(P, cap)``
rows in plain PyTorch, on the handle's device: three scalars come back to
the host, not the keys.  A `parallel.mesh.VirtualMesh` keeps every shard
as a row of one tensor, so the reference's two device validators (a
``shard_map`` program over a mesh, a plain jit for one-shard handles) are
one row reduction here.
"""

from __future__ import annotations

import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch

from dsort_tpu_torch.data.ingest import (
    RECORD_BYTES,
    _pack_be64,
    read_ints_file,
    terasort_secondary,
)
from dsort_tpu_torch.ops.float_order import to_signed_keys

_CHUNK_RECORDS = 1 << 20  # ~100 MB of TeraSort records per streamed chunk
_MASK64 = (1 << 64) - 1
_FNV_OFFSET = 1469598103934665603  # the FNV-1a 64-bit basis
_FNV_PRIME = 1099511628211


@dataclass
class ValidationReport:
    """Outcome of one validation run."""

    records: int
    sorted_ok: bool
    first_violation: int | None  # record index of the first order break
    checksum: int  # multiset checksum (mod 2^64)

    @property
    def ok(self) -> bool:
        return self.sorted_ok


def _fnv_multiset_py(buf: np.ndarray, nrec: int, rec_bytes: int) -> int:
    """Sum mod 2^64 of the FNV-1a hash of each of the first ``nrec``
    ``rec_bytes``-byte records of ``buf``: one uint64 sweep per byte
    column."""
    if nrec == 0:
        return 0
    flat = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    rows = flat[: nrec * rec_bytes].reshape(nrec, rec_bytes)
    with np.errstate(over="ignore"):
        h = np.full(nrec, np.uint64(_FNV_OFFSET))
        prime = np.uint64(_FNV_PRIME)
        for b in range(rec_bytes):
            # Per-column astype keeps the transient at 8 * nrec bytes.
            h = (h ^ rows[:, b].astype(np.uint64)) * prime
        total = int(np.sum(h, dtype=np.uint64))
    return total & _MASK64


#: The reference's dispatch point (native library or numpy sweep); the
#: numpy sweep is the one this package has.
_multiset = _fnv_multiset_py


def _check_order_chunk(chunk: np.ndarray, nrec: int) -> int:
    """Index of the first record whose 10-byte key dips below its
    predecessor's (>= 1), or -1."""
    if nrec < 2:
        return -1
    rows = chunk.reshape(nrec, RECORD_BYTES)
    hi, lo = _pack_be64(rows[:, :8]), terasort_secondary(rows[:, 8:10])
    dips = (hi[1:] < hi[:-1]) | ((hi[1:] == hi[:-1]) & (lo[1:] < lo[:-1]))
    i = int(np.argmax(dips))
    return i + 1 if dips[i] else -1


def _iter_record_chunks(path: str | os.PathLike) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(start_record, chunk_bytes)`` over a binary TeraSort file."""
    size = os.path.getsize(path)
    if size % RECORD_BYTES:
        raise ValueError(f"{path}: size {size} not a multiple of {RECORD_BYTES}")
    nrec = size // RECORD_BYTES
    if nrec == 0:
        return
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    for lo in range(0, nrec, _CHUNK_RECORDS):
        hi = min(lo + _CHUNK_RECORDS, nrec)
        yield lo, np.array(mm[lo * RECORD_BYTES : hi * RECORD_BYTES])


def validate_terasort_file(path: str | os.PathLike) -> ValidationReport:
    """Validate a binary TeraSort file: full 10-byte-key order + checksum."""
    nrec = 0
    checksum = 0
    sorted_ok = True
    first_violation: int | None = None
    prev_key: bytes | None = None
    for lo, chunk in _iter_record_chunks(path):
        n = len(chunk) // RECORD_BYTES
        nrec = lo + n
        if sorted_ok:
            # Boundary pair: previous chunk's last key vs this chunk's first.
            if prev_key is not None and bytes(chunk[:10]) < prev_key:
                sorted_ok, first_violation = False, lo
            else:
                v = _check_order_chunk(chunk, n)
                if v >= 0:
                    sorted_ok, first_violation = False, lo + v
        checksum = (checksum + _multiset(chunk, n, RECORD_BYTES)) & _MASK64
        prev_key = bytes(chunk[-RECORD_BYTES : -RECORD_BYTES + 10])
    return ValidationReport(nrec, sorted_ok, first_violation, checksum)


def checksum_terasort_file(path: str | os.PathLike) -> tuple[int, int]:
    """(record count, multiset checksum) of a binary TeraSort file."""
    nrec = 0
    checksum = 0
    for lo, chunk in _iter_record_chunks(path):
        n = len(chunk) // RECORD_BYTES
        nrec = lo + n
        checksum = (checksum + _multiset(chunk, n, RECORD_BYTES)) & _MASK64
    return nrec, checksum


# ---- raw binary key files, streamed ----

_CHUNK_ELEMS = 1 << 24  # 64-128 MB of keys per streamed chunk


def _iter_key_chunks(path: str | os.PathLike, dtype) -> Iterator[tuple[int, np.ndarray]]:
    dtype = np.dtype(dtype)
    size = os.path.getsize(path)
    if size % dtype.itemsize:
        raise ValueError(f"{path}: size {size} not a multiple of itemsize {dtype.itemsize}")
    n = size // dtype.itemsize
    if n == 0:
        return
    mm = np.memmap(path, dtype=dtype, mode="r")
    for lo in range(0, n, _CHUNK_ELEMS):
        yield lo, np.array(mm[lo : min(lo + _CHUNK_ELEMS, n)])


def validate_bin_file(path: str | os.PathLike, dtype=np.int32) -> ValidationReport:
    """Validate a raw binary key file out of core: order + multiset checksum."""
    n_total = 0
    checksum = 0
    sorted_ok = True
    first_violation: int | None = None
    prev_last = None
    for lo, chunk in _iter_key_chunks(path, dtype):
        n_total = lo + len(chunk)
        if sorted_ok:
            if prev_last is not None and chunk[0] < prev_last:
                sorted_ok, first_violation = False, lo
            elif len(chunk) > 1:
                diffs_ok = chunk[1:] >= chunk[:-1]
                if not diffs_ok.all():
                    sorted_ok = False
                    first_violation = lo + int(np.argmin(diffs_ok)) + 1
        checksum = (checksum + _multiset(chunk, len(chunk), chunk.dtype.itemsize)) & _MASK64
        prev_last = chunk[-1]
    return ValidationReport(n_total, sorted_ok, first_violation, checksum)


def checksum_bin_file(path: str | os.PathLike, dtype=np.int32) -> tuple[int, int]:
    """(key count, multiset checksum) of a raw binary key file, streamed."""
    n_total = 0
    checksum = 0
    for lo, chunk in _iter_key_chunks(path, dtype):
        n_total = lo + len(chunk)
        checksum = (checksum + _multiset(chunk, len(chunk), chunk.dtype.itemsize)) & _MASK64
    return n_total, checksum


def validate_ints_file(path: str | os.PathLike, dtype=np.int32) -> ValidationReport:
    """Validate an ASCII one-int-per-line file (the reference output format)."""
    data = read_ints_file(path, dtype=dtype)
    checksum = _multiset(data, len(data), data.dtype.itemsize)
    if len(data) < 2:
        return ValidationReport(len(data), True, None, checksum)
    diffs_ok = data[1:] >= data[:-1]
    sorted_ok = bool(diffs_ok.all())
    first_violation = None if sorted_ok else int(np.argmin(diffs_ok)) + 1
    return ValidationReport(len(data), sorted_ok, first_violation, checksum)


def checksum_ints_file(path: str | os.PathLike, dtype=np.int32) -> tuple[int, int]:
    """(record count, multiset checksum) of an ASCII int file — compare with
    the output's report to prove the permutation."""
    data = read_ints_file(path, dtype=dtype)
    return len(data), _multiset(data, len(data), data.dtype.itemsize)


# ---- device-resident validation -------------------------------------------
#
# The same order check and FNV-1a multiset as the file validators, over a
# `DeviceSortResult`'s rows while they sit on the card.  ``view(uint8)`` of a
# contiguous tensor gives each key's little-endian bytes, what the host
# hashes, so the device checksum of the output equals `_multiset` of the
# input exactly when the output is a permutation of it.  The hash runs in
# int64: XOR, multiply and sum modulo 2^64 give uint64's bits in two's
# complement.

def _fnv1a_u64(keys: torch.Tensor) -> torch.Tensor:
    """Per-element FNV-1a over each key's little-endian bytes, as the int64
    with the hash's bits."""
    width = keys.element_size()
    byts = keys.contiguous().view(torch.uint8).reshape(keys.shape + (width,))
    h = torch.full(keys.shape, _FNV_OFFSET, dtype=torch.int64, device=keys.device)
    for j in range(width):
        h.bitwise_xor_(byts[..., j]).mul_(_FNV_PRIME)
    return h


def _boundary_ok(firsts: torch.Tensor, lasts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Cross-shard order: each nonempty row's first key >= the last valid key
    of the nearest nonempty row before it.  On the device, with no copy to
    the host."""
    p = counts.shape[0]
    idx = torch.arange(p, device=counts.device)
    nonempty = counts > 0
    upto = torch.cummax(torch.where(nonempty, idx, -1), 0).values
    prev = torch.cat([upto.new_full((1,), -1), upto[:-1]])
    ok = ~nonempty | (prev < 0) | (firsts >= lasts[prev.clamp(min=0)])
    return ok.all()


def _rows_order_and_checksum(
    rows: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order_ok, checksum, total)`` of ``(P, cap)`` sorted rows whose first
    ``counts[i]`` entries are valid, as device scalars; the checksum is the
    int64 with the uint64 sum's bits.  Keys compare in their signed carrier
    (`ops.float_order.to_signed_keys`), the order of the caller's dtype."""
    cap = rows.shape[1]
    valid = torch.arange(cap, device=rows.device) < counts.unsqueeze(1)
    checksum = torch.where(valid, _fnv1a_u64(rows), 0).sum()
    s = to_signed_keys(rows)
    in_row_ok = ~((s[:, 1:] < s[:, :-1]) & valid[:, 1:]).any()
    lasts = s.gather(1, (counts - 1).clamp(min=0).unsqueeze(1)).squeeze(1)
    ok = in_row_ok & _boundary_ok(s[:, 0], lasts, counts)
    return ok, checksum, counts.sum()


def validate_device_result(handle) -> ValidationReport:
    """Order + multiset checksum of a `DeviceSortResult`, on its device.

    One copy of three int64 scalars reaches the host.  ``first_violation``
    is not located on the device (that would fetch an index per break): it
    is always None, and an order break reports ``sorted_ok=False``.
    """
    if handle.n == 0:
        return ValidationReport(0, True, None, 0)
    rows = handle._rows()
    counts = torch.as_tensor(handle.shard_lengths, device=rows.device)
    ok, checksum, total = torch.stack(
        [t.to(torch.int64) for t in _rows_order_and_checksum(rows, counts)]
    ).tolist()
    return ValidationReport(
        records=total, sorted_ok=bool(ok), first_violation=None, checksum=checksum & _MASK64,
    )
