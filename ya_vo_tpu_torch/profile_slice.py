"""Profile the port's main path on one CUDA card: wall time, device busy
time, idle share, launches and the ops that take the device time.

    python -m ya_vo_tpu_torch.profile_slice [--production] [--trace PATH]

Runs `chip_smoke.py`'s workload (the 40-frame 376x1241 stamps world at
VOConfig() with window BA off, or with `--production` VOConfig()
unmodified: sync window BA and the redo of in-flight frames): frames 0-11
warm the path, frames 12-39 run under `torch.profiler`. Device busy time
is the union of the intervals of the profiler's device events (kernels and
copies), each counted once. Also prints the hand-written kernels' launches
a frame (`_build.LAUNCHES`), and the window solves and redone dispatches
in the profiled window.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.utils import synthetic

SEQ = dict(n_frames=40, n_landmarks=1200, height=376, width=1241, step=0.5,
           yaw_rate=0.002, seed=11, corridor=True)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write a Chrome trace here")
    ap.add_argument("--production", action="store_true",
                    help="VOConfig() unmodified (window BA on)")
    args = ap.parse_args()
    frames, _, _, cam = synthetic.render_sequence(**SEQ)
    cfg = VOConfig()
    if not args.production:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba,
                                                              enabled=False))
    fe = create_frontend(cfg, cam, device="cuda")
    fe.run(frames[:WARM])
    torch.cuda.synchronize()
    _build.reset_launches()
    solves, redone = fe.n_ba_runs, fe.n_redone
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fe.run(frames[WARM:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(frames) - WARM
    total, union = (x / 1e3 for x in busy_us(prof.events()))
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    print(f"profiled {n} frames: wall {wall_ms:.1f} ms "
          f"({wall_ms / n:.2f} ms/frame); device events {total:.1f} ms, "
          f"busy (union) {union:.1f} ms ({union / n:.2f} ms/frame); "
          f"idle share {1 - union / wall_ms:.4f}; "
          f"cudaLaunchKernel {launches / n:.0f} a frame")
    print("hand-written kernel launches a frame: " + ", ".join(
        f"{k} {v / n:.2f}" for k, v in _build.LAUNCHES.items()))
    print(f"window BA solves {fe.n_ba_runs - solves}, redone dispatches "
          f"{fe.n_redone - redone}, resets {fe.n_resets} in the window")
    print(ka.table(sort_by="self_device_time_total", row_limit=25))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
