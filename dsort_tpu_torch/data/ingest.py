"""One-int-per-line text IO (the reference's ``input.txt`` / ``output.txt``).

Counterpart of ``dsort_tpu/data/ingest.py``'s ``read_ints_file`` /
``write_ints_file`` in plain numpy (the native C++ text IO is not ported
yet).  The output is byte-compatible with the reference's: one decimal int
per line, ``\\n``-terminated.  Keys outside the dtype's range raise
`OverflowError` instead of wrapping.
"""

from __future__ import annotations

import os

import numpy as np


def read_ints_file(path: str | os.PathLike, dtype=np.int32) -> np.ndarray:
    """Read an ASCII file of whitespace-separated ints into integer ``dtype``."""
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        tokens = f.read().split()
    # Parse at full width (numpy raises OverflowError past 64 bits), then
    # range-check: a narrowing cast would wrap silently.
    wide = np.uint64 if np.issubdtype(dtype, np.unsignedinteger) else np.int64
    vals = np.array(tokens, dtype=wide)
    info = np.iinfo(dtype)
    if len(vals) and (vals.min() < info.min or vals.max() > info.max):
        raise OverflowError(
            f"integer text does not fit dtype {dtype}; use a wider key dtype"
        )
    return vals.astype(dtype)


def write_ints_file(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write one int per line (byte-compatible with the reference)."""
    data = np.asarray(data).reshape(-1)
    text = "".join(f"{v}\n" for v in data.tolist())
    with open(path, "wb") as f:
        f.write(text.encode("ascii"))
