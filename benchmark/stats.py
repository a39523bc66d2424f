"""Arithmetic on the harness's spans and the device's intervals."""

from __future__ import annotations

import math


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """Length of the overlap of [a0, a1] and [b0, b1]."""
    return max(0.0, min(a1, b1) - max(a0, b0))


def window_work(spans, t0: float, t1: float) -> float:
    """The work done inside the window [t0, t1]: each span's ``work``
    credited by the share of its time that lies inside the window, so an
    encode that the window's close cuts counts for its part."""
    total = 0.0
    for s in spans:
        d = s.end - s.start
        if d <= 0:
            total += s.work if t0 <= s.start <= t1 else 0.0
        else:
            total += s.work * overlap(s.start, s.end, t0, t1) / d
    return total


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (NumPy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, t0: float, t1: float) -> list:
    """Intervals cut to [t0, t1], the empty ones left out."""
    out = []
    for s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            out.append((s, e))
    return out


def busy(intervals, t0: float, t1: float) -> float:
    """Time within [t0, t1] covered by at least one interval."""
    return sum(e - s for s, e in clip(union(intervals), t0, t1))


def gaps(intervals, t0: float, t1: float) -> list:
    """The stretches of [t0, t1] that no interval covers."""
    out = []
    cur = t0
    for s, e in clip(union(intervals), t0, t1):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out

