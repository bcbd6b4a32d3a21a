"""The arithmetic of the metrics: rates, percentiles, intervals."""
from __future__ import annotations

import math


def window_rate(returns):
    """(count, seconds, rate) over a list of return times: the window
    runs from the first return to the last, and counts the returns after
    the first, so no partly decoded item at either end enters it."""
    if len(returns) < 2:
        return 0, 0.0, None
    t = sorted(returns)
    span = t[-1] - t[0]
    if span <= 0:
        return len(t) - 1, 0.0, None
    return len(t) - 1, span, (len(t) - 1) / span


def percentile(values, q):
    """The q-th percentile (0-100) by the nearest rank: the smallest
    value with at least q% of the values at or below it."""
    if not values:
        return None
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]


def union(intervals):
    """Merge [(start, end)] into disjoint sorted intervals."""
    out = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy_seconds(intervals, lo, hi):
    """Seconds of [lo, hi] that at least one interval covers."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_share_pct(intervals, lo, hi):
    if hi <= lo:
        return None
    return 100.0 * (1.0 - busy_seconds(intervals, lo, hi) / (hi - lo))


def roofline_pct(least_s, measured_s):
    """The least time over the measured time, in %; None when nothing
    was measured (a share of a roofline is never reported as 0)."""
    if not measured_s or measured_s <= 0 or not least_s:
        return None
    return 100.0 * least_s / measured_s

