"""Tracing: an in-memory recorder of the program's host phases, on the
profiler's clock.

  * `begin(name, session=, frame=)` / `end(token)` — a span of the
    program: name, start and end, its parent (the innermost span open on
    the same thread: a per-thread stack, so that the backend worker's
    spans nest on their own thread), its thread (the system's thread id,
    as the profiler names threads) and the ids of its request, the
    session's serial and the frame id (a span given neither takes its
    parent's). `span(name, **ids)` is the same as a context manager. A
    span whose `end` an exception skips is dropped when the span around it
    ends, so only a thread's root span (as `Frontend.run`'s) needs a
    `finally`. Nothing fences the device: a span is the host's time.
  * `count(name, n)` — a counter event at the same sites, under the span
    open at that point.
  * The switch: the recorder is on while a `torch.profiler` session is
    active (whatever its activities) and inside `recording()`. Off, a
    site costs one flag check: `begin` returns None and `end(None)` and
    `count` return at once, with no clock read and no allocation (`span()`
    allocates its context manager: the program's sites are `begin`/`end`
    pairs).
  * Everything stays in memory until read (`spans`, `counts`, `summary`,
    or the `Window` that `recording()` yields); `clear()` empties the
    store, and `trace()` drops its block's spans once it has written
    them. No I/O on the hot path. The store grows for as long as the
    process records: a process that records window after window reads
    each through its `Window`, or clears the store between them.
  * Stamps are `time.time_ns()`, unix-epoch ns: the clock kineto stamps
    its events with, so a span lies over the device trace as it is.
  * `summary()` — by span name: count, inclusive ms and self ms (the
    duration less the union of its children); by counter: events and sum;
    over the whole store unless given a window's spans and counts.
  * `idle_by_span(intervals, spans)` — the device's idle time split over
    the innermost span that covers each part of each gap.
  * `trace()` — profiles a block (CPU, and CUDA with a card), writes its
    Chrome trace with the block's spans on the same timeline, and beside
    it the device's idle time by span.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import json
import os
import threading
import time
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int          # 0: no span was open on the thread
    thread: int
    session: Optional[int]
    frame: Optional[int]


class Count(NamedTuple):
    name: str
    n: float
    t_ns: int
    parent: int
    thread: int
    session: Optional[int]
    frame: Optional[int]


class SpanStat(NamedTuple):
    count: int
    ms: float            # inclusive
    self_ms: float       # less the union of the children's intervals


class CountStat(NamedTuple):
    count: int           # `count()` calls
    total: float         # the sum of their n


class Summary(NamedTuple):
    spans: Dict[str, SpanStat]
    counters: Dict[str, CountStat]


_spans: list = []        # Span fields as tuples, appended at each end
_counts: list = []       # Count fields as tuples
_next_id = itertools.count(1).__next__
_local = threading.local()
_lock = threading.Lock()
_forced = 0              # open `recording()` contexts


def on() -> bool:
    """Whether the recorder records: a `torch.profiler` session (which
    sets `torch.autograd.profiler._is_profiler_enabled` from its start to
    its stop) or a `recording()` context is active."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


def _stack() -> list:
    """This thread's open spans; also sets `_local.thread`, its system id
    (read once: `get_native_id` is a system call)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()
    return stack


def begin(name: str, session: Optional[int] = None,
          frame: Optional[int] = None):
    """Open a span (see the module docstring); returns its token for
    `end`, or None when the recorder is off."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return None
    stack = _stack()
    if stack:
        parent, p_session, p_frame = stack[-1]
        session = p_session if session is None else session
        frame = p_frame if frame is None else frame
    else:
        parent = 0
    sid = _next_id()
    stack.append((sid, session, frame))
    return name, sid, parent, session, frame, time.time_ns()


def end(token) -> None:
    """Close the span `token` opened (None: nothing). Spans opened inside
    it and not closed (an exception passed them) are dropped."""
    if token is None:
        return
    t1 = time.time_ns()
    name, sid, parent, session, frame, t0 = token
    stack = _stack()
    while stack and stack.pop()[0] != sid:
        pass
    _spans.append((name, t0, t1, sid, parent, _local.thread, session,
                   frame))


@contextlib.contextmanager
def span(name: str, **ids):
    """`begin`/`end` around a block; `ids` are `session` and `frame`."""
    token = begin(name, **ids)
    try:
        yield
    finally:
        end(token)


def count(name: str, n: float) -> None:
    """A counter event of `n` under the span open on this thread."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    parent, session, frame = stack[-1] if stack else (0, None, None)
    _counts.append((name, n, time.time_ns(), parent, _local.thread, session,
                    frame))


def spans(start: int = 0, stop: Optional[int] = None) -> List[Span]:
    """The store's spans, in the order they ended (`start`/`stop`: its
    positions, as a `Window` holds them)."""
    return [Span(*s) for s in _spans[start:stop]]


def counts(start: int = 0, stop: Optional[int] = None) -> List[Count]:
    return [Count(*c) for c in _counts[start:stop]]


def clear() -> None:
    del _spans[:], _counts[:]


class Window:
    """What the store received between two points (`recording()`,
    `trace()`); open until its context exits."""

    def __init__(self):
        self.start = (len(_spans), len(_counts))
        self.stop = (None, None)
        _windows.add(self)

    def close(self) -> None:
        self.stop = (len(_spans), len(_counts))

    def spans(self) -> List[Span]:
        return spans(self.start[0], self.stop[0])

    def counts(self) -> List[Count]:
        return counts(self.start[1], self.stop[1])

    def drop(self) -> None:
        """Take the window's spans and counts out of the store (the windows
        around it lose them too; later windows move down)."""
        for store, k in ((_spans, 0), (_counts, 1)):
            a = self.start[k]
            b = len(store) if self.stop[k] is None else self.stop[k]
            del store[a:b]
            for w in list(_windows):
                w.start, w.stop = (
                    tuple(_shift(x, a, b) if i == k else x
                          for i, x in enumerate(pos))
                    for pos in (w.start, w.stop))


def _shift(x: Optional[int], a: int, b: int) -> Optional[int]:
    """A store position after `del store[a:b]`."""
    if x is None or x <= a:
        return x
    return a if x < b else x - (b - a)


_windows: "weakref.WeakSet[Window]" = weakref.WeakSet()


@contextlib.contextmanager
def recording():
    """Record inside the block, with or without a profiler; yields the
    block's `Window`."""
    global _forced
    with _lock:
        _forced += 1
    window = Window()
    try:
        yield window
    finally:
        window.close()
        with _lock:
            _forced -= 1


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------
def _union_ns(intervals: Iterable) -> int:
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def summary(spans_: Optional[Sequence[Span]] = None,
            counts_: Optional[Sequence[Count]] = None,
            outside: Optional[str] = None) -> Summary:
    """By span name: count, inclusive ms and self ms; by counter name:
    events and sum. Defaults to the whole store. `outside` leaves out the
    spans and counter events that have an ancestor of that name (e.g. the
    fresh dispatches: `outside="step.redo"`)."""
    sp = spans() if spans_ is None else list(spans_)
    cs = counts() if counts_ is None else list(counts_)
    by_id = {s.id: s for s in sp}
    children = defaultdict(list)
    for s in sp:
        children[s.parent].append((s.start_ns, s.end_ns))

    def under(parent: int) -> bool:
        while parent:
            p = by_id.get(parent)
            if p is None:
                return False
            if p.name == outside:
                return True
            parent = p.parent
        return False

    acc = defaultdict(lambda: [0, 0, 0])
    for s in sp:
        if outside is not None and under(s.parent):
            continue
        a = acc[s.name]
        dur = s.end_ns - s.start_ns
        a[0] += 1
        a[1] += dur
        a[2] += dur - _union_ns(children.get(s.id, ()))
    cacc = defaultdict(lambda: [0, 0])
    for c in cs:
        if outside is not None and under(c.parent):
            continue
        cacc[c.name][0] += 1
        cacc[c.name][1] += c.n
    return Summary(
        spans={k: SpanStat(v[0], v[1] * 1e-6, v[2] * 1e-6)
               for k, v in acc.items()},
        counters={k: CountStat(v[0], v[1]) for k, v in cacc.items()})


def device_intervals(prof) -> List[tuple]:
    """The (start_ns, end_ns) of a profiler's device events (kineto's),
    sorted."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            a = e.start_ns()
            out.append((a, a + e.duration_ns()))
    out.sort()
    return out


def idle_by_span(intervals: Iterable, spans_: Sequence[Span],
                 window: Optional[tuple] = None) -> Dict[str, float]:
    """The device's idle time (seconds), split over the innermost span
    that covers each part of each gap, by overlap; what no span covers is
    `unspanned`. `intervals` are the device's (start_ns, end_ns), e.g.
    `device_intervals(prof)`; the gaps are those between their union's
    pieces, over `window` (start_ns, end_ns) when given, else from the
    first device event to the last. The innermost span at a point is the
    covering span that started last (on one thread, the deepest).
    Sorted by time, largest first."""
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


# --------------------------------------------------------------------------
# the operator's trace
# --------------------------------------------------------------------------
@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile a block (CPU and, with a card, CUDA activities) and write
    its Chrome trace to `log_dir`/trace_<pid>_<ms>.json with the block's
    spans (category `program_span`) on the same timeline, and beside it
    idle_<pid>_<ms>.json: `idle_by_span` over the block's device events.
    Yields the profiler. The block's spans and counts leave the store once
    written."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        window = Window()
        try:
            yield prof
        finally:
            window.close()
    os.makedirs(log_dir, exist_ok=True)
    stem = f"{os.getpid()}_{int(time.time() * 1e3)}"
    path = os.path.join(log_dir, f"trace_{stem}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # kineto writes `ts` in us after `baseTimeNanoseconds`
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    block = window.spans()
    doc["traceEvents"].extend(
        dict(ph="X", cat="program_span", name=s.name, pid=pid, tid=s.thread,
             ts=(s.start_ns - base) * 1e-3,
             dur=(s.end_ns - s.start_ns) * 1e-3,
             args=dict(id=s.id, parent=s.parent, session=s.session,
                       frame=s.frame))
        for s in block)
    with open(path, "w") as f:
        json.dump(doc, f)
    with open(os.path.join(log_dir, f"idle_{stem}.json"), "w") as f:
        json.dump(idle_by_span(device_intervals(prof), block), f, indent=1)
    window.drop()
