"""The benchmark of the PyTorch / CUDA port: one run of one cell.

    python3 -m vo_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the cell's entry in
`BENCHMARK.json` names its configuration (`vo_bench/configs/<config>.json`)
and its traffic mix (`vo_bench/traffic/<mix>.json`, read by
`vo_bench/generator.py`); the mix's `driver` names its loop,
`vo_bench/drivers/<driver>.py`'s `drive` (`load_driver`; the contract is
`vo_bench/drivers/__init__.py`'s docstring); each metric is a reader of
its own (`vo_bench/metrics/<metric>.py`); the comparison's limits are
`vo_bench/limits/<cell>.json`. All of them are read from the checkout's
own `vo_bench/`. A new cell, metric or driver is new files and entries,
not an edit.

A run: set-up (process start to the window's start, `setup_s`): the
configuration's `host_environment` set, the program's import and CUDA
context, the kernel library's load (built into
`build/kernels/<hash>/` in the checkout on a checkout's first run), the
routes rendered on the card by the frozen renderer and kept as host uint8
arrays, and then the driver's own set-up: for `drives`, a warm session
through the bootstrap, the first dispatch (where the step graphs are
captured) and `precompile()`. Then the window of `--seconds`, driven by
the mix's driver: `drives` takes the routes in order, each through
`Frontend.run(frames, pipelined=True)` of a fresh `create_frontend`
session, until the window closes (the frame source stops handing frames
at the deadline); the window ends at the return of the last call. A run
with `--trace 1` reports only the per-layer metrics: its window is the
mix's `trace_seconds`, all of it under a `torch.profiler` session (CUDA
activity); its `breakdown.idle_gaps` splits the device's idle time in
that window over the program's spans (`idle_gaps`).

After the window: the device's memory peak, the per-layer readings, the
program's sessions freed, then the comparison (`vo_bench/compare.py`) of
the sampled steps, window solves and their applies against the plain
reference. The last line of stdout is the result's JSON; the earlier line
`run:` holds ATE_sim3, KITTI's segment errors, resets, relocalizations
and the solves; the last lines of stderr are the numbers compared beside
their limits.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ya_vo_tpu")


def _process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux's
    /proc); else the import of this module."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()


def log(msg: str) -> None:
    print(f"[vo_bench +{time.perf_counter() - T_PROCESS:7.2f}s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------
class Spec:
    """A cell as `BENCHMARK.json` and its files under `root` (a checkout)
    give it."""

    def __init__(self, bench: dict, cell: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise SystemExit(f"vo_bench: no workload {cell!r} in "
                             "BENCHMARK.json")
        self.cell = cells[cell]
        self.name = cell
        self.here = Path(root) / HERE.name
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = json.loads((Path(root) / conf["file"]).read_text())
        self.traffic = json.loads((self.here / "traffic" /
                                   f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads(
            (self.here / "limits" / f"{cell}.json").read_text())
        self.chips = int(self.cell["chips"])
        e2e = bench["end_to_end"]
        self.end_to_end = [m for m in e2e if cell in m.get("workloads",
                                                           [cell])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(here: Path, name: str):
    """The metric's reader, `<here>/metrics/<name>.py`'s `read(run)`."""
    return _load(here / "metrics" / f"{name}.py",
                 "vo_bench_metric_" + name.replace(".", "_")).read


def load_driver(here: Path, name: str):
    """The traffic's driver, `<here>/drivers/<name>.py`'s `drive` (the
    contract: `vo_bench/drivers/__init__.py`)."""
    path = here / "drivers" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"vo_bench: no driver {name!r} ({path})")
    return _load(path, "vo_bench_driver_" + name.replace(".", "_")).drive


# --------------------------------------------------------------------------
# the run's record, which the metric readers read
# --------------------------------------------------------------------------
class Run:
    def __init__(self, spec: Spec):
        self.spec = spec
        self.vo = spec.config["vo"]
        self.device = None            # the run's torch device
        self.setup_s = math.nan
        self.window_s = math.nan
        self.attempted = 0
        self.failed = 0
        self.frames_done = 0          # poses returned in the window
        self.create_ms = []           # create_frontend, a session
        self.counters = dict(redone=0, ba_runs=0, ba_discarded=0,
                             ba_deferred=0, resets=0, relocalizations=0)
        self.trajectories = []        # (poses returned, ground truth)
        self.traced = None            # the trace's reduction (reduce_trace)
        self.traced_frames = []       # frames handed in a traced window
        self.setup = {}               # seconds of each phase of set-up


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------
class Tracer:
    """A CUDA profiler session (`torch.profiler`, device activity and the
    CUDA runtime's calls) over the whole window of a traced run, started at
    the end of set-up, so that CUPTI's start-up stays out of the window;
    a no-op when off. `t0_ns`/`t1_ns` bound the window on the profiler's
    clock (unix-epoch ns, as kineto and the program's spans stamp)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.window_s = None
        self.t0_ns = self.t1_ns = None

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self, t0: float) -> None:
        """Stop once the device is done; the traced window ran from
        `t0`."""
        if self.prof is None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t0
        self.t1_ns = time.time_ns()
        self.prof.stop()


def idle_gaps(intervals, spans, window) -> tuple:
    """The breakdown's `idle_gaps`: the device's idle time over `window`
    ((start_ns, end_ns) on the profiler's clock) between the device's
    `intervals` ((start_ns, end_ns)), split over the innermost of the
    program's `spans` that covers each part, `unspanned` where none does
    (the frozen `idle_by_span`). Returns the ten largest parts as [[name,
    seconds], ...] and every part, by name."""
    from vo_bench.frozen import trace as ftrace

    parts = ftrace.idle_by_span(intervals, spans, window=window)
    return [[n, v] for n, v in parts.items()][:10], parts


def program_spans() -> list:
    """The program's span store (`ya_vo_tpu_torch.utils.profiling`, on
    while a profiler runs); empty where the program has none."""
    try:
        from ya_vo_tpu_torch.utils import profiling
    except ImportError:
        return []
    return profiling.spans()


def reduce_trace(prof, tracer: Tracer) -> dict:
    """Device busy time (the union of the device events), each kernel's
    summed device time and events, and the device's idle time in the
    traced window by the program's spans (`idle_gaps`)."""
    from torch.autograd import DeviceType

    from vo_bench.frozen import trace as ftrace

    t = time.perf_counter()
    intervals, kernels = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            a = e.start_ns()
            d = e.duration_ns()
            intervals.append((a, a + d))
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += d * 1e-9
            k[1] += 1
    t_events = time.perf_counter() - t
    _, union_ns = ftrace.busy_us(intervals)
    gaps, parts = idle_gaps(intervals, program_spans(),
                            (tracer.t0_ns, tracer.t1_ns))
    log(f"the trace's {len(intervals)} device events read in "
        f"{t_events:.1f} s, busy and idle time in "
        f"{time.perf_counter() - t - t_events:.1f} s")
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(busy_s=union_ns * 1e-9, window_s=tracer.window_s,
                kernels=kernels,
                device_ops=[[n[:160], v[0]] for n, v in top_ops],
                idle_gaps=gaps, idle_by_span=parts)


# --------------------------------------------------------------------------
# what the drivers share (`vo_bench/drivers/`)
# --------------------------------------------------------------------------
def _finite(pose) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(pose)).all())


def _count(run: Run, fe) -> None:
    c = run.counters
    c["redone"] += fe.n_redone
    c["ba_runs"] += fe.n_ba_runs
    c["ba_discarded"] += fe.n_ba_discarded
    c["ba_deferred"] += fe.n_ba_deferred
    c["resets"] += fe.n_resets
    c["relocalizations"] += fe.n_relocalizations


def __getattr__(name: str):
    # `drive_routes`, the drives driver's name before drivers were files,
    # for `port_phases.py`, which still calls it so
    if name == "drive_routes":
        return load_driver(HERE, "drives")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------
def accuracy(run: Run) -> dict:
    """ATE_sim3 and KITTI's segment errors of each trajectory against the
    world's ground truth (the frozen `viz/evaluation`)."""
    import numpy as np

    from vo_bench.frozen import evaluation as ev

    out = []
    for est, gt_wc in run.trajectories:
        if len(est) < 3:
            continue
        gt_cw = np.linalg.inv(gt_wc)
        t_pct, r_deg, n_seg = ev.kitti_segment_errors(est, gt_cw)
        out.append(dict(frames=len(est),
                        ate_sim3_m=ev.ate_rmse(est, gt_cw, with_scale=True),
                        kitti_t_pct=t_pct, kitti_r_deg_per_m=r_deg,
                        kitti_segments=n_seg))
    return out


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device=None, control: bool = False) -> dict:
    """Set-up, the window, the readings and the comparison; returns the
    result's dict (the last line). `control` (for `vo_bench/control.py`,
    never the benchmark's runs) adds the control's numbers on the same
    samples under "control"."""
    import torch

    import ya_vo_tpu_torch
    from ya_vo_tpu_torch.config import VOConfig
    from ya_vo_tpu_torch.core.camera import Camera
    from ya_vo_tpu_torch.geometry import ransac
    from ya_vo_tpu_torch.tracking.frontend import RECORD_KEYS

    from vo_bench import audit as audit_lib
    from vo_bench import compare, generator

    dev = torch.device(device or "cuda")
    run = Run(spec)
    run.device = dev
    t = time.perf_counter()
    run.setup["import_s"] = t - T_PROCESS
    tr = spec.traffic
    drive = load_driver(spec.here, tr["driver"])
    cfg = VOConfig.from_dict(spec.config["vo"])
    if dev.type == "cuda":
        from ya_vo_tpu_torch import _build
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        run.setup["cuda_context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _build.library()
        run.setup["kernels_s"] = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"{spec.name}: rendering the routes (seed {seed})")
    routes = generator.make(tr, seed, dev, times=run.setup)
    fcam = generator.camera(tr)
    cam = Camera.create(*fcam)

    def make_frontend():
        return ya_vo_tpu_torch.create_frontend(cfg, cam, device=dev)

    window = float(tr["trace_seconds"]) if trace else seconds
    au = tr["audit"]
    audit = audit_lib.Audit(*audit_lib.draw(
        au, seed, window, au["first_frame"],
        min(au["last_frame"], tr["frames_per_route"])))
    tracer = Tracer(trace)
    log(f"{spec.name}: set-up done, the {tr['driver']} driver starts")
    two_view = audit.watch_bootstraps(ransac)
    try:
        drive(run, routes, make_frontend, audit, tracer, RECORD_KEYS,
              window)
    finally:
        ransac.estimate_two_view = two_view
    log(f"{spec.name}: the window closed after {run.window_s:.3f} s, "
        f"{run.frames_done} poses")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"vo_bench: the run loaded {bad}")
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    if tracer.prof is not None:
        t = time.perf_counter()
        run.traced = reduce_trace(tracer.prof, tracer)
        tracer.prof = None
        log(f"the trace reduced in {time.perf_counter() - t:.1f} s")
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = load_reader(spec.here, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    info = dict(accuracy=accuracy(run), counters=run.counters,
                setup_s=run.setup_s, setup=run.setup,
                attempted=run.attempted, failed=run.failed,
                frames=run.frames_done, window_s=run.window_s,
                sessions=len(run.create_ms))
    if run.traced is not None:
        info["idle_by_span_s"] = run.traced["idle_by_span"]
    print("run: " + json.dumps(info, default=float), flush=True)

    # the program's sessions are gone; the comparison runs on what the
    # audit kept
    routes = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = compare.judge(audit, spec.config["vo"], fcam)
    detail = numbers.pop("detail")
    correct, rows = compare.verdict(numbers, spec.limits)
    log(f"comparison of {numbers['samples']} steps, {numbers['solves']} "
        f"solves, {numbers['applies']} applies, {numbers['pushes']} pushes "
        f"and {numbers['bootstraps']} bootstraps in "
        f"{time.perf_counter() - t:.1f} s")
    out = dict(correct=correct, attempted=run.attempted, failed=run.failed,
               metrics=metrics,
               device=dict(platform="gpu" if dev.type == "cuda"
                           else dev.type,
                           kind=(torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else dev.type),
                           count=spec.chips, memory_peak_bytes=int(mem)))
    if run.traced is not None:
        out["device"]["busy_s"] = run.traced["busy_s"]
        out["device"]["window_s"] = run.traced["window_s"]
        out["breakdown"] = dict(device_ops=run.traced["device_ops"],
                                idle_gaps=run.traced["idle_gaps"])
    if control:
        out["detail"] = detail
        out["control"] = compare.judge(audit, spec.config["vo"], fcam,
                                       control=True)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    out["checks"]["samples"] = {"value": numbers["samples"], "limit": 1}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = Spec(bench, args.workload)
    # the deployment's host environment, as its configuration states it
    # (before torch and numpy load)
    os.environ.update(spec.config.get("host_environment", {}))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"vo_bench: {spec.name} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # one module whether run as `-m vo_bench.run` or imported by a driver,
    # so that a driver reads this process's `T_PROCESS`
    sys.modules.setdefault("vo_bench.run", sys.modules[__name__])
    sys.exit(main())
