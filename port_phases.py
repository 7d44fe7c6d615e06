#!/usr/bin/env python3
"""The drives cell's host phases by the program's spans, on one CUDA card.

    python3 port_phases.py [--seed N] [--pairs 2] [--seconds 30]
                           [--out build/phases.json]

One process sets the cell `kitti_default.drives` up as the benchmark does
(`vo_bench/run.py`: its configuration's host environment, its routes,
its warm session, the audit's wrappers on every session) and then drives
its closed loop (`vo_bench.run.drive_routes`) in windows of four kinds:

- `profiled`: the traffic's `trace_seconds` under `torch.profiler` with
  CUDA activity only, as the benchmark's traced run profiles it, which
  switches the span recorder (`ya_vo_tpu_torch.utils.profiling`) on;
- `recorded`: the same length under `profiling.recording()` alone, no
  profiler;
- `off` and `rec`: `--seconds` each with the recorder off and under
  `recording()`, in the order off, rec, rec, off, `--pairs` times, for the
  recorder's cost in frames/s.

For the two first it prints the benchmark's nine readings of the store
(`vo_bench/metrics/`), each phase's count, inclusive and self ms a pose,
and for `profiled` the device's idle time by span
(`profiling.idle_by_span` over the window), the idle share, and the
coverage: the share of the window's wall under `session.run`, the share
of `session.run` under its direct children, the graph replays under fresh
dispatches and under redos against all replays and against the growth of
`_build.REPLAYS["graphs"]`. It also times a span site (`begin`/`end`)
off and on, less the bare call (`site_cost`). Writes everything as JSON
to `--out`.

The set-up (`setup`) copies `vo_bench.run.run_cell`'s, and `_Window`
stands in for the harness's `Tracer`: once the harness's tracer can enter
`profiling.recording()` itself, call the harness's set-up and tracer here
instead of these copies.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CELL = "kitti_default.drives"
PHASES = ("session.run", "session.create", "session.bootstrap",
          "frame.upload", "step.dispatch", "graph.capture", "graph.replay",
          "step.resolve", "step.wait", "state.push", "step.redo",
          "ba.window", "ba.build", "ba.solve", "ba.apply")


class _Window:
    """A tracer for `drive_routes`: the window's recorder mode, with the
    unix-ns bounds of the window and the step graphs' replays in it."""

    def __init__(self, mode: str):
        self.mode, self.on, self.prof, self.window_s = mode, False, None, None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ya_vo_tpu_torch import _build
        from ya_vo_tpu_torch.utils import profiling
        profiling.clear()
        self._rec = None
        if self.mode == "profiled":
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU])
            self.prof.start()
        elif self.mode in ("recorded", "rec"):
            self._rec = profiling.recording()
            self._rec.__enter__()
        self.replays0 = _build.REPLAYS["graphs"]
        self.t0_ns = time.time_ns()

    def stop(self, t0: float) -> None:
        import torch

        from ya_vo_tpu_torch import _build
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.window_s = time.perf_counter() - t0
        self.replays = _build.REPLAYS["graphs"] - self.replays0
        if self.prof is not None:
            self.prof.stop()
        if self._rec is not None:
            self._rec.__exit__(None, None, None)


def _phases(summary, frames: int) -> dict:
    out = {}
    for name in PHASES:
        st = summary.spans.get(name)
        if st is not None:
            out[name] = dict(count=st.count, ms_per_pose=st.ms / frames,
                             self_ms_per_pose=st.self_ms / frames)
    return out


def _coverage(spans, win: _Window) -> dict:
    """The coverage checks of the profiled window (module docstring)."""
    from ya_vo_tpu_torch.utils import profiling

    by_id = {s.id: s for s in spans}
    run = profiling.summary(spans, []).spans["session.run"]
    fresh = redo = 0
    for s in spans:
        if s.name != "graph.replay":
            continue
        d = by_id.get(s.parent)
        if d is None or d.name != "step.dispatch":
            continue
        p = by_id.get(d.parent)
        if p is not None and p.name == "session.run":
            fresh += 1
        elif p is not None and p.name == "step.redo":
            redo += 1
    n_replay = sum(s.name == "graph.replay" for s in spans)
    return dict(
        session_run_share_of_window=run.ms * 1e-3 / win.window_s,
        children_share_of_session_run=1 - run.self_ms / run.ms,
        replays=n_replay, replays_fresh=fresh, replays_redo=redo,
        replays_counted=win.replays)


def drive(spec, routes, make_frontend, seed: int, mode: str,
          seconds: float) -> dict:
    import torch

    from vo_bench import audit as audit_lib
    from vo_bench import run as bench_run
    from ya_vo_tpu_torch.tracking.frontend import RECORD_KEYS
    from ya_vo_tpu_torch.utils import profiling

    run = bench_run.Run(spec)
    au = spec.traffic["audit"]
    audit = audit_lib.Audit(*audit_lib.draw(
        au, seed, seconds, au["first_frame"],
        min(au["last_frame"], spec.traffic["frames_per_route"])))
    win = _Window(mode)
    bench_run.drive_routes(run, routes, make_frontend, audit, win,
                           RECORD_KEYS, seconds)
    out = dict(mode=mode, frames=run.frames_done, window_s=run.window_s,
               frames_per_s=run.frames_done / run.window_s,
               sessions=len(run.create_ms), redone=run.counters["redone"],
               ba_runs=run.counters["ba_runs"])
    if mode in ("profiled", "recorded"):
        readings = {m["name"]: bench_run.load_reader(spec.here, m["name"])(
            run) for m in spec.per_layer}
        out["metrics"] = {k: v for k, v in readings.items()
                          if v is not None}
        out["phases"] = _phases(profiling.summary(), run.frames_done)
        out["phases_fresh_dispatch"] = _phases(
            profiling.summary(outside="step.redo"), run.frames_done)[
                "step.dispatch"]
        out["spans"] = len(profiling.spans())
    if mode == "profiled":
        spans = profiling.spans()
        busy = profiling.device_intervals(win.prof)
        idle = profiling.idle_by_span(busy, spans,
                                      window=(win.t0_ns, win.t1_ns))
        idle_s = sum(idle.values())
        out["idle_by_span_s"] = idle
        out["idle_s"] = idle_s
        out["idle_share"] = idle_s * 1e9 / (win.t1_ns - win.t0_ns)
        out["named_idle_share"] = 1 - idle.get("unspanned", 0.0) / idle_s
        out["busy_ms_per_pose"] = (win.t1_ns - win.t0_ns) * 1e-6 * (
            1 - out["idle_share"]) / run.frames_done
        out["coverage"] = _coverage(spans, win)
        win.prof = None
    profiling.clear()
    del run, audit
    torch.cuda.empty_cache()
    return out


def site_cost(n: int = 1_000_000) -> dict:
    """ns a span site (a `begin`/`end` pair in a method) costs off and on,
    less the bare method's call (the best of five repeats)."""
    import timeit

    from ya_vo_tpu_torch.utils import profiling

    class Site:
        frame_id = 2

        def bare(self, x, y=None):
            return x

        def pair(self, x, y=None):
            sp = profiling.begin("site", frame=self.frame_id)
            profiling.end(sp)
            return x

    site = Site()

    def ns(fn, k):
        return min(timeit.repeat(lambda: fn(1, y=2), number=k,
                                 repeat=5)) / k * 1e9

    out = {}
    for mode in ("off", "on"):
        k = n if mode == "off" else n // 10
        ctx = profiling.recording() if mode == "on" else None
        if ctx is not None:
            ctx.__enter__()
        bare = ns(site.bare, k)
        out[mode] = dict(bare_ns=bare, pair_ns=ns(site.pair, k) - bare)
        if ctx is not None:
            ctx.__exit__(None, None, None)
        profiling.clear()
    return out


def setup(seed: int):
    """The cell's spec, routes and frontend factory, set up as the
    benchmark sets them up, and the card's name and power limit."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sys.path.insert(0, str(ROOT))
    from vo_bench import run as bench_run
    spec = bench_run.Spec(bench, CELL, ROOT)
    os.environ.update(spec.config.get("host_environment", {}))
    import torch

    import ya_vo_tpu_torch
    from vo_bench import generator
    from ya_vo_tpu_torch import _build
    from ya_vo_tpu_torch.config import VOConfig
    from ya_vo_tpu_torch.core.camera import Camera

    dev = torch.device("cuda")
    torch.empty(1, device=dev)
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    routes = generator.make(spec.traffic, seed, dev)
    cfg = VOConfig.from_dict(spec.config["vo"])
    cam = Camera.create(*generator.camera(spec.traffic))

    def make_frontend():
        return ya_vo_tpu_torch.create_frontend(cfg, cam, device=dev)

    return spec, routes, make_frontend, card.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3_700_000_017)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default="build/phases.json")
    args = ap.parse_args(argv)
    spec, routes, make_frontend, card = setup(args.seed)
    import torch

    trace_s = float(spec.traffic["trace_seconds"])
    plan = [("profiled", trace_s), ("recorded", trace_s)]
    for _ in range(args.pairs):
        plan += [("off", args.seconds), ("rec", args.seconds),
                 ("rec", args.seconds), ("off", args.seconds)]
    cost = site_cost()
    print("site cost:", json.dumps(cost), flush=True)
    results = []
    for i, (mode, seconds) in enumerate(plan):
        r = drive(spec, routes, make_frontend, args.seed + i, mode, seconds)
        results.append(r)
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("phases", "idle_by_span_s")}),
              flush=True)
    out = dict(card=card, seed=args.seed, torch=torch.__version__,
               site_cost=cost, results=results)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for r in results[:2]:
        print(f"\n{r['mode']}: {r['frames_per_s']:.2f} frames/s")
        for k, v in r["phases"].items():
            print(f"  {k:18s} n {v['count']:6d}  {v['ms_per_pose']:.4f} "
                  f"ms/pose  self {v['self_ms_per_pose']:.4f}")
    print("\nidle by span (profiled):",
          json.dumps(results[0]["idle_by_span_s"]))
    for mode in ("off", "rec"):
        fps = [r["frames_per_s"] for r in results if r["mode"] == mode]
        print(mode, "frames/s", fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
