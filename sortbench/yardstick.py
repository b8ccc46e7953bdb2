"""Peaks of the card, the least time a sort could take, and interval sums.

The least time counts the bytes a sort must move whatever implements it:
each input byte read once and each output byte written once, against the
card's published memory bandwidth.  So a kernel that is replaced changes
the time it is divided by, never the bound.
"""

from __future__ import annotations

#: Published HBM bandwidth (bytes/s) by the name ``torch.cuda.get_device_name``
#: gives: NVIDIA's H100 SXM data sheet, at its full 700 W power limit.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak(kind: str) -> float | None:
    return HBM_BYTES_PER_S.get(kind)


def sort_bytes(items: int, item_bytes: int) -> int:
    """Bytes a sort of ``items`` rows of ``item_bytes`` must move: read once,
    written once."""
    return 2 * int(items) * int(item_bytes)


def merged(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """``(start, end)`` intervals clipped to ``[lo, hi]`` and merged where
    they overlap or touch, in order."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def union_length(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """The length of the union of ``intervals`` inside ``[lo, hi]``: time
    covered by any of them, overlapping streams counted once."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two interval lists."""
    a, b = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
