"""The arithmetic of the end-to-end metrics and of the device's idle share.

Every rate is all the work of the window over all the time of the window;
every tail is taken over all requests of the window.
"""

from __future__ import annotations

import math


def per_unit_ms(window_s: float, units: int) -> float:
    """Milliseconds of window per unit of work (an Adam step)."""
    if units <= 0:
        raise ValueError("no work completed in the window")
    return 1e3 * window_s / units


def rate(units: float, window_s: float) -> float:
    """Units of work (observations) per second of window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return units / window_s


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def idle_pct(busy_s: float, window_s: float) -> float:
    """Share of the window in which no device operation ran, in %."""
    return 100.0 * (1.0 - busy_s / window_s)
