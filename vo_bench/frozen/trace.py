"""Device busy time from a profiler trace: a frozen copy of the arithmetic
of the port's `profile_slice.busy_us` (the union of the device events'
intervals, each instant counted once), with the longest idle gaps between
them. Held equal to its source by `vo_bench/tests/test_vo_bench_frozen.py`.
"""

from __future__ import annotations


def busy_us(spans) -> tuple:
    """(sum of durations, length of the union) of (start, end) spans, us."""
    spans = sorted(spans)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total, union


def idle_gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) gaps inside [lo, hi] that no span covers, us."""
    gaps, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]
