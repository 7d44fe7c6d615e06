#!/usr/bin/env python3
"""Frames/s of the port's main path, two checkouts against each other.

    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR [--pairs 6] [--runs 2]

Each side runs in a process of its own from its own checkout (so each
imports its own `ya_vo_tpu_torch` and builds its own kernels), on one CUDA
card: `chip_smoke.py`'s workload, the 40-frame 376x1241 stamps world at
VOConfig() with window BA off, one warm-up run, then `--runs` timed runs of
frames 2-39 (`Frontend.run(pipelined=True)`, host clock around work that
ends in `torch.cuda.synchronize()`). Pairs alternate which side runs first.
Prints each side's runs, then medians, quartiles and the pairs each side
won (by the mean of its runs).
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
try:
    from ya_vo_tpu_torch.config import VOConfig
except ImportError:       # a checkout before the port had its own config
    from ya_vo_tpu.config import VOConfig
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


def run_side(tree: str, runs: int) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD, str(runs)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stderr[-2000:]}")
    return [float(x) for x in out.stdout.split()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
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
