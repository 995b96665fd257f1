"""The benchmark's arithmetic on times: percentiles over every request,
unions of device intervals and the spread between runs."""
from __future__ import annotations

import math
import statistics


def percentile(values: list, q: float) -> float:
    """Nearest-rank ``q``-th percentile of ``values``; a request that
    failed or never finished is ``math.inf`` and so misses it."""
    if not values:
        return math.inf
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union(intervals: list) -> list:
    """Merged (start, end) intervals covering the same time."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def covered(intervals: list) -> float:
    """Total time the intervals cover, overlaps counted once."""
    return sum(end - start for start, end in union(intervals))


def gaps(intervals: list) -> list:
    """(start, end) of each idle stretch between merged intervals."""
    merged = union(intervals)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


def spread(values: list) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
