"""Profile the port's main path on one CUDA card: wall time, device busy
time, idle share, launches and the ops that take the device time.

    python -m ya_vo_tpu_torch.profile_slice [--production | --textured]
                                            [--eager] [--trace PATH]

Runs `chip_smoke.py`'s workload (the 40-frame 376x1241 stamps world at
VOConfig() with window BA off, or with `--production` VOConfig()
unmodified: sync window BA and the redo of in-flight frames; or with
`--textured` VOConfig() unmodified over the first 40 frames of bench.py's
textured world, rendered on the card inside the run): frames 0-11 warm
the path, frames 12-39 run under `torch.profiler`. Device busy time
is the union of the intervals of the profiler's device events (kernels and
copies), each counted once. The fused step runs as the frontend's step
graphs (`--eager`: the eager step): a frame's `cudaLaunchKernel` and
`cudaGraphLaunch` calls are counted apart, and its kernels on the device
(`device_kernels`: the profiler's kernel events, those a graph launched
included, each once), with each hand-written kernel's device events a
frame beside its launches a frame (`_build.LAUNCHES`, which a replay
counts) and the graph replays a frame. Also prints the window solves and
redone dispatches in the profiled window.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch.config import VOConfig, with_option
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.utils.scene import TexturedSequence

WARM = 12


def busy_us(events) -> tuple:
    """(sum of durations, length of the union) of the device events, us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total, union


def device_kernels(events, name: str = None) -> int:
    """The kernels among the profiler's device events (not copies or
    memsets), each counted once; with `name`, those of that kernel."""
    return sum(e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and (name is None or name in e.name)
               for e in events)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write a Chrome trace here")
    ap.add_argument("--eager", action="store_true",
                    help="run the eager step, not the step graphs")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--production", action="store_true",
                      help="VOConfig() unmodified (window BA on)")
    mode.add_argument("--textured", action="store_true",
                      help="VOConfig() unmodified on bench.py's textured "
                      "world, rendered on the card")
    args = ap.parse_args()
    if args.textured:
        seq = TexturedSequence(n_frames=410, seed=5, device="cuda")
        frame, cam = seq.frame, seq.cam
    else:
        imgs, _, _, cam = synthetic.render_sequence(**synthetic.STAMPS)
        frame = imgs.__getitem__
    n_frames = synthetic.STAMPS["n_frames"]
    cfg = VOConfig()
    if not (args.production or args.textured):
        cfg = with_option(cfg, "ba", enabled=False)
    fe = create_frontend(cfg, cam, device="cuda",
                         step_graphs=not args.eager)
    fe.run(frame(f) for f in range(WARM))
    torch.cuda.synchronize()
    _build.reset_launches()
    solves, redone = fe.n_ba_runs, fe.n_redone
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fe.run(frame(f) for f in range(WARM, n_frames))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = n_frames - WARM
    total, union = (x / 1e3 for x in busy_us(prof.events()))
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    graph_launches = sum(e.count for e in ka if e.key == "cudaGraphLaunch")
    evs = prof.events()
    print(f"profiled {n} frames ({'eager step' if args.eager else 'step graphs'}"
          f"): wall {wall_ms:.1f} ms "
          f"({wall_ms / n:.2f} ms/frame); device events {total:.1f} ms, "
          f"busy (union) {union:.1f} ms ({union / n:.2f} ms/frame); "
          f"idle share {1 - union / wall_ms:.4f}; "
          f"cudaLaunchKernel {launches / n:.1f} a frame, cudaGraphLaunch "
          f"{graph_launches / n:.2f} a frame, kernels on the device "
          f"{device_kernels(evs) / n:.1f} a frame")
    print("hand-written kernel launches a frame: " + ", ".join(
        f"{k} {v / n:.2f}" for k, v in _build.LAUNCHES.items())
        + f"; graph replays {_build.REPLAYS['graphs'] / n:.2f} a frame")
    print("hand-written kernels' device events a frame: " + ", ".join(
        f"{k} {device_kernels(evs, _build.DEVICE_NAMES[k]) / n:.2f}"
        for k in _build.KERNELS))
    print(f"window BA solves {fe.n_ba_runs - solves}, redone dispatches "
          f"{fe.n_redone - redone}, resets {fe.n_resets} in the window")
    print(ka.table(sort_by="self_device_time_total", row_limit=25))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
