"""Text and TeraSort record IO.

Counterpart of ``dsort_tpu/data/ingest.py`` in plain numpy (the native C++
text IO is not ported yet), byte-compatible with the reference:

- ``read_ints_file`` / ``write_ints_file``: one decimal int per line,
  ``\\n``-terminated (the reference's ``input.txt`` / ``output.txt``), read
  in the grammar of the reference's reader: ``#`` comments and ``+`` signs
  as ``np.loadtxt`` takes them, and integral float text (``3.0``, ``3.``,
  ``1e3``) read as the integer it names for integer dtypes, as the
  reference's parser reads it.  Two departures, each an error where the
  reference would return a wrong key: lossy text for an integer dtype
  (``3.5``, ``nan``, ``inf``) raises `ValueError` where the reference
  truncates it, and keys outside the dtype's range raise `OverflowError`
  where the reference wraps them.  ``_`` digit separators (``1_000``)
  raise `ValueError` for every dtype, as in the reference.  Float dtypes
  read and write round-trip decimal text;
- TeraSort's 100-byte binary records (`read_terasort_file`,
  `write_terasort_file`, `gen_terasort`, `gen_terasort_file`);
- the seeded generators of ``gen`` (`gen_uniform`, `gen_uniform_bin_file`,
  `gen_zipf`), which give the reference's bytes for the same seed.
"""

from __future__ import annotations

import decimal
import os
import re

import numpy as np


def _strip_comments(raw: bytes) -> bytes:
    """Drop everything from a ``#`` to the end of its line."""
    if b"#" not in raw:
        return raw
    return b"\n".join(line.split(b"#", 1)[0] for line in raw.split(b"\n"))


_INT_TEXT = re.compile(rb"[+-]?[0-9]+")


def _integral(token: bytes) -> int:
    """The integer a token names: decimal int text, or float text whose
    value is integral (``3.0``, ``3.``, ``-1e3``), read exactly.  Raises
    `ValueError` for anything else, lossy text (``3.5``, ``nan``, ``inf``)
    included."""
    if _INT_TEXT.fullmatch(token):
        return int(token)
    try:
        d = decimal.Decimal(token.decode("ascii"))
    except (decimal.InvalidOperation, UnicodeDecodeError):
        raise ValueError(f"could not read {token!r} as a number") from None
    if not d.is_finite() or d != d.to_integral_value():
        raise ValueError(f"{token!r} is not an integer; read it with a float dtype")
    return int(d)


def read_ints_file(path: str | os.PathLike, dtype=np.int32) -> np.ndarray:
    """Read an ASCII file of whitespace-separated numbers into ``dtype``.

    ``#`` starts a comment, on a line of its own or after a number, and
    numbers may carry a ``+`` sign.  An integer ``dtype`` takes decimal
    ints and integral float text (``3.0``, ``1e3``); lossy text (``3.5``,
    ``nan``) raises `ValueError` and values outside the dtype raise
    `OverflowError`.  A float ``dtype`` also takes ``nan`` / ``inf`` and
    exponents.  ``_`` separators raise `ValueError` (module docstring).
    """
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        text = _strip_comments(f.read())
    if b"_" in text:
        # Python's int() and float(), under numpy's conversion, read
        # "1_000" as 1000; the reference's parser refuses it.
        bad = next(t for t in text.split() if b"_" in t)
        raise ValueError(f"could not read {bad!r}: '_' digit separators are not accepted")
    tokens = text.split()
    if dtype.kind == "f":
        return np.array(tokens, dtype=dtype)
    if dtype.kind not in "iu":
        raise TypeError(f"read_ints_file reads integer or float keys, not {dtype}")
    # Parse at full width (numpy raises OverflowError past 64 bits), then
    # range-check: a narrowing cast would wrap silently.
    wide = np.uint64 if np.issubdtype(dtype, np.unsignedinteger) else np.int64
    try:
        vals = np.array(tokens, dtype=wide)
    except ValueError:  # float text: integral values only, read exactly
        vals = np.array([_integral(t) for t in tokens], dtype=wide)
    info = np.iinfo(dtype)
    if len(vals) and (vals.min() < info.min or vals.max() > info.max):
        raise OverflowError(
            f"integer text does not fit dtype {dtype}; use a wider key dtype"
        )
    return vals.astype(dtype)


def write_ints_file(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write one int per line (byte-compatible with the reference); floats
    with enough digits (9 for float32, 17 for float64) to read back to the
    same value."""
    data = np.asarray(data).reshape(-1)
    if data.dtype.kind == "f":
        digits = 9 if data.dtype.itemsize <= 4 else 17
        text = "".join(f"{v:.{digits}g}\n" for v in data.tolist())
    else:
        text = "".join(f"{v}\n" for v in data.tolist())
    with open(path, "wb") as f:
        f.write(text.encode("ascii"))


def gen_uniform(n: int, dtype=np.int32, seed: int = 0) -> np.ndarray:
    """Uniform random keys over the dtype's range (its maximum excluded)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype, endpoint=False)


def gen_uniform_bin_file(
    path: str | os.PathLike, n: int, dtype=np.int32, seed: int = 0, chunk: int = 1 << 24,
) -> None:
    """Stream ``n`` uniform keys to a raw binary file, ``chunk`` keys at a
    time: the binary twin of `gen_uniform` for jobs too big for text."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    info = np.iinfo(dtype)
    with open(path, "wb") as f:
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            f.write(rng.integers(info.min, info.max, size=m, dtype=dtype, endpoint=False).tobytes())


def gen_zipf(n: int, a: float = 1.3, dtype=np.int64, seed: int = 0) -> np.ndarray:
    """Zipf-skewed keys, clipped (not wrapped) into ``dtype``'s range."""
    rng = np.random.default_rng(seed)
    vals = rng.zipf(a, size=n)
    return np.minimum(vals, np.iinfo(dtype).max).astype(dtype)


RECORD_BYTES = 100  # TeraSort record: 10-byte key + 90-byte value


def read_terasort_file(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Read a binary TeraSort file into ``(packed_keys, payload)``.

    The first 8 key bytes pack big-endian into a uint64 sort key; the other
    92 bytes (key bytes 8-9, then the 90-byte value) ride as the payload, so
    records round-trip byte for byte.  `terasort_secondary` turns payload
    columns 0-1 into the tiebreak that completes the 10-byte order.
    """
    raw = np.fromfile(path, dtype=np.uint8)
    if len(raw) % RECORD_BYTES:
        raise ValueError(f"{path}: size {len(raw)} not a multiple of {RECORD_BYTES}")
    raw = raw.reshape(-1, RECORD_BYTES)
    return _pack_be64(raw[:, :8]), raw[:, 8:].copy()


def _pack_be64(key_bytes: np.ndarray) -> np.ndarray:
    """(n, 8) uint8 big-endian rows -> native uint64."""
    return np.ascontiguousarray(key_bytes).view(">u8").reshape(-1).astype(np.uint64)


def terasort_secondary(payload: np.ndarray) -> np.ndarray:
    """Key bytes 8-9 of TeraSort records (payload columns 0-1) as a
    big-endian uint16: with the packed 8-byte prefix, the full 10-byte key."""
    return (payload[:, 0].astype(np.uint16) << np.uint16(8)) | payload[:, 1]


def write_terasort_file(
    path: str | os.PathLike, keys: np.ndarray, payload: np.ndarray
) -> None:
    """Write ``(packed_keys, payload)`` back as 100-byte records."""
    raw = np.empty((len(keys), RECORD_BYTES), dtype=np.uint8)
    k = keys.astype(np.uint64)
    for b in range(8):
        raw[:, b] = (k >> np.uint64(8 * (7 - b))).astype(np.uint8)
    raw[:, 8:] = payload
    raw.tofile(path)


def gen_terasort(
    n: int, key_bytes: int = 10, payload_bytes: int = 90, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Seeded TeraSort-style records: ``(keys uint64, payload (n, key_bytes
    - 8 + payload_bytes) uint8)``, the same bytes as the reference's
    generator for the same seed."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, key_bytes + payload_bytes), dtype=np.uint8)
    return _pack_be64(raw[:, :8]), raw[:, 8:]


def gen_terasort_file(path: str | os.PathLike, n: int, seed: int = 0) -> None:
    """Write a binary TeraSort input file of ``n`` seeded 100-byte records."""
    keys, payload = gen_terasort(n, seed=seed)
    write_terasort_file(path, keys, payload)
