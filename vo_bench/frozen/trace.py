"""Device busy and idle time from a profiler trace: frozen copies of the
arithmetic of the port's `profile_slice.busy_us` (the union of the device
events' intervals, each instant counted once) and of
`utils/profiling.idle_by_span` (the device's idle time split over the
program's spans). Held equal to their sources by
`vo_bench/tests/test_vo_bench_frozen.py`.
"""

from __future__ import annotations

import heapq
from collections import defaultdict


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


def idle_by_span(intervals, spans_, window=None) -> dict:
    """The device's idle time (seconds), split over the innermost span
    that covers each part of each gap, by overlap; what no span covers is
    `unspanned`. `intervals` are the device's (start_ns, end_ns); the gaps
    are those between their union's pieces, over `window` (start_ns,
    end_ns) when given, else from the first device event to the last.
    `spans_` have `name`, `start_ns` and `end_ns`; the innermost span at a
    point is the covering span that started last (on one thread, the
    deepest). Sorted by time, largest first."""
    busy = []
    for a, b in sorted(intervals):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    if not busy and window is None:
        return {}
    lo, hi = window if window is not None else (busy[0][0], busy[-1][1])
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    gaps = [(a, b) for a, b in gaps if b > a]

    # elementary segments between the spans' boundaries, each with the
    # covering span that started last (a heap, ended spans dropped lazily)
    order = sorted(spans_, key=lambda s: (s.start_ns, -s.end_ns))
    points = sorted({p for s in order for p in (s.start_ns, s.end_ns)})
    segs, heap, k = [], [], 0
    for p, q in zip(points, points[1:]):
        while k < len(order) and order[k].start_ns <= p:
            s = order[k]
            heapq.heappush(heap, (-s.start_ns, s.end_ns, k, s.name))
            k += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        if heap:
            segs.append((p, q, heap[0][3]))

    out = defaultdict(int)
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < b:
            p, q, name = segs[i]
            d = min(b, q) - max(a, p)
            if d > 0:
                out[name] += d
                covered += d
            i += 1
        if b - a > covered:
            out["unspanned"] += b - a - covered
    return dict(sorted(((k, v * 1e-9) for k, v in out.items()),
                       key=lambda kv: -kv[1]))
