"""The port's span recorder (`ya_vo_tpu_torch/utils/profiling.py`) on the
CPU: off, a site records and allocates nothing and never touches CUDA; on
(under a `torch.profiler` session or `recording()`) spans nest by thread
with their parents, self times and request ids, on kineto's clock;
`idle_by_span` splits idle gaps by overlap; `trace` writes the spans into
its Chrome trace; a tiny `Frontend.run` emits the program's spans; and the
benchmark's ten readers of the store (`vo_bench/metrics/`) read it. The
card's clock is held by tests/test_torch_profiling_card.py."""

import gc
import itertools
import json
import math
import os
import threading
import time
import tracemalloc
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ya_vo_tpu_torch.config import FeatureConfig, TrackConfig, VOConfig
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import profiling, synthetic
from ya_vo_tpu_torch.utils.profiling import Span

READERS = ("driver.upload_ms_per_frame.drives",
           "driver.dispatch_ms_per_frame.drives",
           "graph.replay_ms_per_replay.drives",
           "graph.capture_ms_per_session.drives",
           "driver.resolve_ms_per_frame.drives",
           "driver.wait_ms_per_frame.drives",
           "driver.redo_ms_per_frame.drives",
           "ba.window_ms_per_solve.drives",
           "ba.gn_iters_per_solve.drives",
           "driver.inflight_per_resolve.drives")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _sites(n: int) -> None:
    """`n` span sites as the program writes them, and a counter."""
    for _ in itertools.repeat(None, n):
        sp = profiling.begin("step.dispatch", frame=3)
        profiling.count("ba.gn_iters", 3)
        profiling.end(sp)


def _loop(n: int) -> None:
    for _ in itertools.repeat(None, n):
        pass


def _traced_bytes(fn, n: int):
    """(retained, peak) bytes of `fn(n)` over what was traced before it."""
    fn(n)
    gc.collect()
    base = tracemalloc.get_traced_memory()[0]
    tracemalloc.reset_peak()
    fn(n)
    cur, peak = tracemalloc.get_traced_memory()
    return cur - base, peak - base


def test_off_records_and_allocates_nothing():
    """Off, a site's `begin` gives no token, nothing is retained from
    `profiling`'s code, and 20,000 sites reach no higher a peak than an
    empty loop (one token, 88 bytes, would show; 64 bytes of slack for
    the test runner's own thread, the least of three trials)."""
    assert not profiling.on()
    assert profiling.begin("step.dispatch", frame=3) is None
    tracemalloc.start()
    try:
        empty = min(_traced_bytes(_loop, 20000) for _ in range(3))
        sites = min(_traced_bytes(_sites, 20000) for _ in range(3))
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert snap.statistics("lineno") == []
    assert sites[0] <= empty[0] + 64 and sites[1] <= empty[1] + 64
    with profiling.span("block", session=1):
        pass
    assert profiling.spans() == [] and profiling.counts() == []


@pytest.mark.parametrize("under_profiler", [True, False])
def test_span_accumulates(under_profiler):
    """Spans and counters record under a CPU profiler session and under
    `recording()`, and stop with it."""
    ctx = (profile(activities=[ProfilerActivity.CPU]) if under_profiler
           else profiling.recording())
    with ctx:
        assert profiling.on()
        for _ in range(2):
            with profiling.span("work", session=5):
                torch.ones(64, 64).sum()
            profiling.count("items", 2)
    assert not profiling.on()
    with profiling.span("untimed"):
        pass
    s = profiling.summary()
    assert set(s.spans) == {"work"} and s.spans["work"].count == 2
    assert s.spans["work"].ms > 0
    assert s.counters["items"] == profiling.CountStat(2, 4)
    assert {x.session for x in profiling.spans()} == {5}
    assert not torch.cuda.is_initialized()


def test_recording_window_holds_its_own_spans():
    with profiling.recording():
        with profiling.span("before"):
            pass
    with profiling.recording() as w:
        with profiling.span("inside"):
            pass
    assert [s.name for s in w.spans()] == ["inside"]
    assert [s.name for s in profiling.spans()] == ["before", "inside"]


def test_span_an_exception_skips_is_dropped_with_its_parent():
    """A site's `end` that an exception skips leaves its span open on the
    thread's stack; the span around it, ended in a `finally`, drops it,
    and the thread's next span has no stale parent."""
    with profiling.recording() as w:
        root = profiling.begin("root", session=3)
        try:
            profiling.begin("skipped", frame=8)
            raise ValueError
        except ValueError:
            pass
        finally:
            profiling.end(root)
        with profiling.span("next"):
            pass
    sp = {s.name: s for s in w.spans()}
    assert set(sp) == {"root", "next"}
    assert sp["next"].parent == 0 and sp["next"].session is None


def test_trace_drops_its_spans_from_the_store(tmp_path):
    """Once written, `trace()`'s spans leave the store; a window open
    around it keeps what it recorded before and after, and a later
    window still reads its own."""
    with profiling.recording() as outer:
        with profiling.span("before"):
            pass
        with profiling.trace(str(tmp_path)):
            with profiling.span("traced"):
                profiling.count("n", 1)
        with profiling.span("after"):
            pass
    with profiling.recording() as later:
        with profiling.span("later"):
            pass
    assert [s.name for s in outer.spans()] == ["before", "after"]
    assert outer.counts() == []
    assert [s.name for s in later.spans()] == ["later"]
    assert [s.name for s in profiling.spans()] == ["before", "after",
                                                    "later"]
    (name,) = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    with open(tmp_path / name) as fp:
        events = json.load(fp)["traceEvents"]
    assert [e["name"] for e in events
            if e.get("cat") == "program_span"] == ["traced"]


def test_nested_parents_self_time_and_ids():
    with profiling.recording():
        root = profiling.begin("root", session=7)
        a = profiling.begin("a", frame=3)
        time.sleep(0.002)
        profiling.count("c", 5)
        profiling.end(a)
        b = profiling.begin("b")
        time.sleep(0.001)
        profiling.end(b)
        time.sleep(0.001)
        profiling.end(root)
    sp = {s.name: s for s in profiling.spans()}
    assert sp["root"].parent == 0
    assert sp["a"].parent == sp["b"].parent == sp["root"].id
    assert (sp["a"].session, sp["a"].frame) == (7, 3)
    assert (sp["b"].session, sp["b"].frame) == (7, None)
    (c,) = profiling.counts()
    assert (c.parent, c.session, c.frame) == (sp["a"].id, 7, 3)
    s = profiling.summary()
    dur = {k: (v.end_ns - v.start_ns) * 1e-6 for k, v in sp.items()}
    assert s.spans["root"].ms == pytest.approx(dur["root"])
    assert s.spans["root"].self_ms == pytest.approx(
        dur["root"] - dur["a"] - dur["b"])
    assert s.spans["a"].self_ms == pytest.approx(dur["a"])
    assert s.spans["root"].self_ms >= 0.9


def test_self_time_is_less_the_union_of_children_and_outside():
    """Synthetic spans: overlapping children are counted once; `outside`
    drops what lies under a span of that name."""
    sp = [Span("top", 0, 100, 1, 0, 1, None, None),
          Span("c", 10, 40, 2, 1, 1, None, None),
          Span("c", 30, 60, 3, 1, 1, None, None),
          Span("redo", 70, 90, 4, 1, 1, None, None),
          Span("c", 75, 85, 5, 4, 1, None, None)]
    cs = [profiling.Count("n", 2, 80, 5, 1, None, None),
          profiling.Count("n", 1, 20, 2, 1, None, None)]
    s = profiling.summary(sp, cs)
    assert tuple(s.spans["top"]) == pytest.approx((1, 100e-6, 30e-6))
    assert tuple(s.spans["c"]) == pytest.approx((3, 70e-6, 70e-6))
    assert s.spans["redo"].self_ms == pytest.approx(10e-6)
    assert s.counters["n"] == profiling.CountStat(2, 3)
    o = profiling.summary(sp, cs, outside="redo")
    assert tuple(o.spans["c"]) == pytest.approx((2, 60e-6, 60e-6))
    assert o.counters["n"] == profiling.CountStat(1, 1)


def test_spans_on_two_threads_nest_on_their_own_thread():
    barrier = threading.Barrier(2)

    def work(k):
        outer = profiling.begin("outer", session=k)
        barrier.wait()
        inner = profiling.begin("inner", frame=k)
        time.sleep(0.002)
        barrier.wait()
        profiling.end(inner)
        profiling.end(outer)

    with profiling.recording():
        ts = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    sp = profiling.spans()
    assert len(sp) == 4
    by_id = {s.id: s for s in sp}
    for s in sp:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.session == p.session == s.frame
        else:
            assert s.parent == 0
    assert len({s.thread for s in sp}) == 2
    s = profiling.summary()
    assert s.spans["inner"].count == 2
    assert s.spans["outer"].self_ms < s.spans["outer"].ms


def test_idle_by_span_splits_gaps_by_overlap():
    busy = [(0, 10), (20, 30), (25, 40), (60, 70)]   # gaps 10-20, 40-60
    sp = [Span("root", 0, 100, 1, 0, 1, None, None),
          Span("a", 12, 35, 2, 1, 1, None, None),
          Span("b", 45, 55, 3, 1, 1, None, None),
          Span("b_inner", 50, 53, 4, 3, 1, None, None)]
    got = profiling.idle_by_span(busy, sp)
    assert got == pytest.approx({"root": 12e-9, "a": 8e-9, "b": 7e-9,
                                 "b_inner": 3e-9})
    got = profiling.idle_by_span(busy, sp[1:])
    assert got == pytest.approx({"unspanned": 12e-9, "a": 8e-9, "b": 7e-9,
                                 "b_inner": 3e-9})
    # over a window: the leading and trailing idle time too
    got = profiling.idle_by_span(busy, sp, window=(-5, 110))
    assert got["root"] == pytest.approx(42e-9)
    assert got["unspanned"] == pytest.approx(15e-9)
    assert sum(got.values()) == pytest.approx(
        (115 - 10 - 20 - 10) * 1e-9)
    assert profiling.idle_by_span([], sp) == {}


def test_spans_on_kineto_clock():
    """A span around a `record_function` range encloses kineto's event for
    it on the same clock (unix-epoch ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            sp = profiling.begin("outer")
            with record_function("inner_range"):
                torch.randn(64, 64).sum()
            profiling.end(sp)
            time.sleep(0.002)
    evs = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "inner_range")
    rngs = {e.start_ns(): e.start_ns() + e.duration_ns()
            for e in prof.profiler.kineto_results.events()
            if e.name() == "inner_range"}
    spans = sorted(profiling.spans(), key=lambda s: s.start_ns)
    assert len(evs) == len(spans) == 3
    for a, s in zip(evs, spans):
        assert s.start_ns <= a and rngs[a] <= s.end_ns
        assert a - s.start_ns < 5e6 and s.end_ns - rngs[a] < 5e6


def test_trace_writes_a_chrome_trace(tmp_path):
    """The Chrome trace holds the block's ops and its spans on the same
    timeline (a span encloses the op run inside it), and the idle table
    lies beside it."""
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.span("matmul_block", frame=4):
            torch.randn(128, 128) @ torch.randn(128, 128)
    assert prof is not None
    files = sorted(os.listdir(log_dir))
    assert len(files) == 2
    assert files[0].startswith("idle_") and files[1].startswith("trace_")
    with open(log_dir / files[1]) as fp:
        events = json.load(fp)["traceEvents"]
    mm = [e for e in events if e.get("name") in ("aten::mm", "aten::matmul")]
    (sp,) = [e for e in events if e.get("cat") == "program_span"]
    assert mm and sp["name"] == "matmul_block" and sp["args"]["frame"] == 4
    for e in mm:
        assert sp["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= sp["ts"] + sp["dur"]
    with open(log_dir / files[0]) as fp:
        assert json.load(fp) == {}        # no device on the CPU


def test_span_does_not_fence(monkeypatch):
    def fence(*a, **k):
        raise AssertionError("span fenced the device")

    monkeypatch.setattr(torch.cuda, "synchronize", fence)
    for ctx in (profiling.recording(), profile(
            activities=[ProfilerActivity.CPU])):
        with ctx:
            with profiling.span("block"):
                pass
            profiling.end(profiling.begin("site"))
    with profiling.span("off"):
        pass
    assert len(profiling.spans()) == 4
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------
WORLD = dict(synthetic.STAMPS, n_frames=14, height=256, width=768)


@pytest.fixture(scope="module")
def frontend_runs():
    """A frontend's run off, then one under `recording()`: the stamps
    world at 256x768 with window BA on (two solves, a redo)."""
    profiling.clear()
    imgs, _, _, cam = synthetic.render_sequence(**WORLD)
    cfg = VOConfig(image_height=256, image_width=768,
                   features=FeatureConfig(max_keypoints=1024),
                   tracking=TrackConfig(min_ba_inliers=15,
                                        min_flow_inliers=5))
    off = Frontend(cfg, cam, device="cpu")
    off.run(list(imgs), pipelined=True)
    n_off = (len(profiling.spans()), len(profiling.counts()))
    with profiling.recording() as w:
        fe = Frontend(cfg, cam, device="cpu")
        fe.run(list(imgs), pipelined=True)
    return dict(n_off=n_off, fe=fe, spans=w.spans(), counts=w.counts(),
                n=len(imgs))


def test_frontend_off_leaves_the_store_empty(frontend_runs):
    assert frontend_runs["n_off"] == (0, 0)


def test_frontend_run_emits_its_spans(frontend_runs):
    fe, sp = frontend_runs["fe"], frontend_runs["spans"]
    n = frontend_runs["n"]
    names = Counter(s.name for s in sp)
    assert names["session.run"] == names["session.create"] == 1
    assert names["frame.upload"] == n
    assert names["session.bootstrap"] >= 2
    assert names["ba.window"] == names["ba.build"] == names["ba.solve"] \
        == names["ba.apply"] == fe.n_ba_runs >= 1
    assert names["step.redo"] >= 1 and fe.n_redone >= 1
    assert {s.session for s in sp} == {fe.serial}
    by_id = {s.id: s for s in sp}
    run = next(s for s in sp if s.name == "session.run")
    assert [s.frame for s in sp if s.name == "frame.upload"] == list(range(n))
    resolved = [s.frame for s in sp if s.name == "step.resolve"]
    assert len(resolved) == len(set(resolved))
    fresh = [s for s in sp if s.name == "step.dispatch"
             and by_id[s.parent].name != "step.redo"]
    assert all(by_id[s.parent] is run for s in fresh)
    assert sorted(s.frame for s in fresh) == sorted(resolved)
    redone = [s for s in sp if s.name == "step.dispatch"
              and by_id[s.parent].name == "step.redo"]
    assert len(redone) == fe.n_redone
    for s in sp:
        if s.name in ("ba.build", "ba.solve", "ba.apply"):
            w = by_id[s.parent]
            assert w.name == "ba.window" and s.frame == w.frame
            assert by_id[w.parent].name == "step.resolve"
            assert by_id[w.parent].frame == w.frame
    iters = [c for c in frontend_runs["counts"] if c.name == "ba.gn_iters"]
    assert len(iters) == fe.n_ba_runs
    assert all(1 <= c.n <= fe.cfg.ba.iters for c in iters)
    assert all(by_id[c.parent].name == "ba.solve" for c in iters)
    # the session's spans lie inside its run, each on the same thread
    assert all(run.start_ns <= s.start_ns and s.end_ns <= run.end_ns
               and s.thread == run.thread
               for s in sp if s.name != "session.create")


def test_frontend_counts_frames_in_flight_a_resolve(frontend_runs):
    """One `driver.inflight` event a resolve, under its `step.resolve`: the
    frames in flight, the resolved one included; the CPU resolves at the
    depth cap, so a full queue reads `pipeline_depth`. The benchmark's
    reader returns their mean."""
    from vo_bench import run as bench_run

    fe, sp = frontend_runs["fe"], frontend_runs["spans"]
    by_id = {s.id: s for s in sp}
    counts = [c for c in frontend_runs["counts"]
              if c.name == "driver.inflight"]
    resolves = [s for s in sp if s.name == "step.resolve"]
    assert len(counts) == len(resolves) >= 1
    assert all(by_id[c.parent].name == "step.resolve" for c in counts)
    assert sorted(by_id[c.parent].frame for c in counts) == \
        sorted(s.frame for s in resolves)
    depth = fe.cfg.tracking.pipeline_depth
    assert all(1 <= c.n <= depth for c in counts)
    assert max(c.n for c in counts) == depth
    read = bench_run.load_reader(bench_run.HERE,
                                 "driver.inflight_per_resolve.drives")
    run = SimpleNamespace(frames_done=frontend_runs["n"])
    assert read(run) is None                    # no counter in the store
    with profiling.recording():
        for c in counts:
            profiling.count(c.name, c.n)
    assert read(run) == sum(c.n for c in counts) / len(counts)


# ---------------------------------------------------------------------------
# the benchmark's readers of the store
# ---------------------------------------------------------------------------
def _synthetic_run() -> None:
    """The spans a traced window of two sessions would leave, as the
    program opens them."""
    def leaf(name, **ids):
        profiling.end(profiling.begin(name, **ids))

    for session in (1, 2):
        run = profiling.begin("session.run", session=session)
        for f in range(4):
            leaf("frame.upload", frame=f)
            d = profiling.begin("step.dispatch", frame=f)
            if f == 0:
                leaf("graph.capture")
            leaf("graph.replay")
            profiling.end(d)
            r = profiling.begin("step.resolve", frame=f)
            profiling.count("driver.inflight", 1 + (f == 2))
            leaf("step.wait")
            if f == 2:
                w = profiling.begin("ba.window")
                leaf("ba.build")
                s = profiling.begin("ba.solve")
                profiling.count("ba.gn_iters", 3)
                profiling.end(s)
                leaf("ba.apply")
                profiling.end(w)
                leaf("state.push")
            profiling.end(r)
            if f == 2:
                redo = profiling.begin("step.redo")
                leaf("state.push")
                d = profiling.begin("step.dispatch", frame=3)
                leaf("graph.replay")
                profiling.end(d)
                profiling.end(redo)
        profiling.end(run)


@pytest.mark.parametrize("metric", READERS)
def test_benchmark_reader(metric):
    from vo_bench import run as bench_run

    read = bench_run.load_reader(bench_run.HERE, metric)
    run = SimpleNamespace(frames_done=8)
    assert read(run) is None                    # an empty store
    with profiling.recording():
        _synthetic_run()
    v = read(run)
    assert v is not None and math.isfinite(v) and v > 0
    if metric == "ba.gn_iters_per_solve.drives":
        assert v == 3.0
    if metric == "driver.inflight_per_resolve.drives":
        assert v == 10 / 8
    if metric == "driver.dispatch_ms_per_frame.drives":
        fresh = profiling.summary(outside="step.redo").spans["step.dispatch"]
        assert fresh.count == 8 and v == fresh.self_ms / 8
    if "_per_frame." in metric:                  # a pose returned
        assert read(SimpleNamespace(frames_done=0)) is None
