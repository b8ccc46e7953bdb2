"""The plain reference, its control, and the comparison that decides ``correct``.

NumPy only: nothing here imports ``jax``, ``dsort_tpu`` or anything of
``dsort_tpu_torch``, and nothing takes what the program made.  The
reference works the answer out again from the job's input:

- keys: ``np.sort``, the exact ascending order of the key type;
- records: ascending order of the whole ``key_bytes``-byte key, i.e. the
  packed 8-byte prefix, then the key's remaining bytes (the payload's
  first columns); records with equal whole keys may come in any order, so
  within each such group rows are compared as a multiset.

The number compared is the count of rows that differ from the reference
(with the difference in length added), and its limit is 0: a sort is
exact.  The control is the reference computed one precision lower, the
order taken from the key as a float32 (stable, so keys that round alike
keep their input order): it has to come out not correct.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 20  # rows compared at a time, to bound the temporaries


def reference(kind: str, job_input, config: dict):
    """The exact answer to one job."""
    if kind == "keys":
        return np.sort(job_input)
    keys, payload = job_input
    order = np.lexsort(_key_columns(keys, payload, config))
    return keys[order], payload[order]


def control(kind: str, job_input, config: dict):
    """The reference one precision lower: ordered by the key as a float32."""
    keys = job_input if kind == "keys" else job_input[0]
    order = np.argsort(keys.astype(np.float32), kind="stable")
    if kind == "keys":
        return keys[order]
    return keys[order], job_input[1][order]


def _key_columns(keys, payload, config: dict) -> tuple:
    """np.lexsort's keys, least significant first: the key bytes past the
    packed 8 (payload columns), then the packed prefix."""
    extra = int(config["key_bytes"]) - 8
    return tuple(payload[:, c] for c in reversed(range(extra))) + (keys,)


def mismatched(kind: str, out, ref, config: dict) -> int:
    """Rows of ``out`` that differ from the reference ``ref``, plus the
    difference in length; a wrong dtype or row shape mismatches every row."""
    if kind == "keys":
        return _mismatched_rows(np.asarray(out), None, ref, None)
    (ok, op), (rk, rp) = (np.asarray(out[0]), np.asarray(out[1])), ref
    groups = _tie_groups(rk, rp, config)
    if groups is not None:
        rk, rp = _canonical(rk, rp, *groups)
        ok, op = _canonical(ok, op, *groups)
    return _mismatched_rows(ok, op, rk, rp)


def _mismatched_rows(ok, op, rk, rp) -> int:
    if ok.dtype != rk.dtype or (op is not None and (op.dtype != rp.dtype or op.shape[1:] != rp.shape[1:])):
        return max(len(ok), len(rk))
    n = min(len(ok), len(rk))
    bad = abs(len(ok) - len(rk))
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        diff = ok[lo:hi] != rk[lo:hi]
        if op is not None:
            diff |= (op[lo:hi] != rp[lo:hi]).reshape(hi - lo, -1).any(axis=1)
        bad += int(np.count_nonzero(diff))
    return bad


def _tie_groups(rk, rp, config: dict):
    """``(rows, group)`` of the reference's rows whose whole key equals a
    neighbour's, or None when every key is distinct."""
    extra = int(config["key_bytes"]) - 8
    eq = rk[1:] == rk[:-1]
    if extra:
        eq &= (rp[1:, :extra] == rp[:-1, :extra]).all(axis=1)
    pairs = np.flatnonzero(eq)
    if not pairs.size:
        return None
    group = np.concatenate([[0], np.cumsum(~eq)])
    rows = np.unique(np.concatenate([pairs, pairs + 1]))
    return rows, group[rows]


def _canonical(keys, payload, rows, group):
    """Copies of ``keys`` / ``payload`` with each tie group's rows ordered
    by their payload bytes (rows past the end are left out)."""
    inside = rows < len(keys)
    rows, group = rows[inside], group[inside]
    sub = payload[rows].reshape(len(rows), -1)
    order = np.lexsort(tuple(sub[:, c] for c in reversed(range(sub.shape[1]))) + (group,))
    keys, payload = keys.copy(), payload.copy()
    keys[rows] = keys[rows][order]
    payload[rows] = payload[rows][order]
    return keys, payload
