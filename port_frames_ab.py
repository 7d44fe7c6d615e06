#!/usr/bin/env python3
"""Frames/s of the port's main path, two checkouts against each other.

    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR [--pairs 6] [--runs 2]
    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR --detect [--pairs 2]

Each side runs in a process of its own from its own checkout (so each
imports its own `ya_vo_tpu_torch` and builds its own kernels), on one CUDA
card: `chip_smoke.py`'s workload, the 40-frame 376x1241 stamps world at
VOConfig() with window BA off, one warm-up run, then `--runs` timed runs of
frames 2-39 (`Frontend.run(pipelined=True)`, host clock around work that
ends in `torch.cuda.synchronize()`). Pairs alternate which side runs first.
Prints each side's runs, then medians, quartiles and the pairs each side
won (by the mean of its runs).

With `--detect`, each side instead times one `fast.detect` call at the main
path's parameters on frame 1 of that sequence, 20 calls under
`torch.profiler`: device ms a call (the sum of all device events), device
events and CUDA runtime launch calls a call, and the call's time by CUDA
events around 20 calls (host issue included). Prints one JSON line a run.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import dataclasses, sys, time
import torch
import chip_smoke as cs
from ya_vo_tpu_torch import create_frontend
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.utils import synthetic
frames, *_, cam = synthetic.render_sequence(**cs.SEQ)
cfg = VOConfig()
cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, enabled=False))
for rep in range(int(sys.argv[1]) + 1):
    fe = create_frontend(cfg, cam, device="cuda")
    fe.run(frames[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe.run(frames[2:], pipelined=True)
    torch.cuda.synchronize()
    if rep:
        print(38 / (time.perf_counter() - t0), flush=True)
"""

DETECT_CHILD = r"""
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.features import fast
from ya_vo_tpu_torch.utils import synthetic
frames, *_ = synthetic.render_sequence(**{**cs.SEQ, "n_frames": 2})
fc = VOConfig().features
# written out as `_extract` passes them: older checkouts lack detect_kwargs
kw = dict(max_keypoints=fc.max_keypoints, threshold=fc.fast_threshold,
          arc_length=fc.fast_arc_length, nms_radius=fc.nms_radius,
          border=fc.brief_patch_radius + fc.blur_ksize // 2 + 4,
          harris_k=fc.harris_k)
img = torch.as_tensor(frames[1]).cuda()
fn = lambda: fast.detect(img, **kw)
reps = 20
fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
dev = [e for e in p.events() if e.device_type == DeviceType.CUDA]
launch = [e for e in p.events() if e.device_type == DeviceType.CPU
          and e.name.startswith("cudaLaunch")]
print(json.dumps(dict(
    device_ms=sum(e.time_range.end - e.time_range.start for e in dev)
    / reps / 1e3,
    device_events=len(dev) / reps, runtime_launches=len(launch) / reps,
    call_ms=cs.time_ms(fn), n_valid=int(fn().mask.sum()),
    card=cs.card_line())))
"""


def run_side(tree: str, runs: int, detect: bool = False) -> list:
    args = ["-c", DETECT_CHILD] if detect else ["-c", CHILD, str(runs)]
    out = subprocess.run([sys.executable, *args],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stderr[-2000:]}")
    if detect:
        return out.stdout.strip().splitlines()[-1:]
    return [float(x) for x in out.stdout.split()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--detect", action="store_true",
                    help="time one fast.detect call instead of frames/s")
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    if args.detect:
        for i in range(args.pairs):
            for name in (("parent", "change") if i % 2 == 0
                         else ("change", "parent")):
                line, = run_side(sides[name], 0, detect=True)
                print(f"pair {i} {name} detect: {line}", flush=True)
        return 0
    got = {name: [] for name in sides}
    wins = {name: 0 for name in sides}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        pair = {}
        for name in order:
            pair[name] = run_side(sides[name], args.runs)
            got[name] += pair[name]
            print(f"pair {i} {name}: " + " ".join(f"{x:.2f}"
                                                  for x in pair[name]),
                  flush=True)
        means = {name: float(np.mean(v)) for name, v in pair.items()}
        if means["parent"] != means["change"]:
            wins[max(means, key=means.get)] += 1
    for name, v in got.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"{name}: median {med:.2f} frames/s, quartiles {q1:.2f}-"
              f"{q3:.2f}, range {min(v):.2f}-{max(v):.2f}, "
              f"pairs won {wins[name]} of {args.pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
