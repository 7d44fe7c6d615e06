#!/usr/bin/env python3
"""Frames/s of the port's main path, two checkouts against each other.

    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR [--pairs 6] [--runs 2]
    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR --detect [--pairs 2]
    python3 port_frames_ab.py PARENT_DIR CHANGE_DIR --bench [--pairs 2]
                              [--runs 1]
    python3 port_frames_ab.py --apply-mode [TREE] [--pairs 4] [--runs 1]
                              [--warm 8 ...] [--world-seed S ...]
    python3 port_frames_ab.py --orders [TREE] [--order-seed 0 1 ...]
                              [--solver plain kernel]
    python3 port_frames_ab.py --graphs [TREE] [--pairs 2]

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

With `--bench`, each side runs the bench's primary: `bench.run_bench`
with its extras cut to their least (a 1-step issue probe, a 7-frame stamps
secondary, no selfcheck; the refine still runs), `--runs` reps (the
410-frame textured world, `VOConfig()` unmodified, per rep a fresh
frontend through 8 warm frames and `precompile()`, then the timed
`run(pipelined=True)` of the other 402 with the render inside the window).
Prints each rep's frames/s, resets, redone dispatches, solves and ATE_sim3
as the bench rounds them; where the checkout's `chip_smoke.py` has
`pose_gn_iterations`, also the iterations pose GN's kernel ran in each
solve of the call (median, max, histogram; the warm frames, the probe's 2
dispatches and the stamps secondary's 7 frames included).

With `--orders`, one checkout (TREE, default the current directory) runs
the same bench call once for each pose solver ("plain", the eager version
the card ran before K4, and "kernel", K4) and each `--order-seed`: every
solve takes its points in a permuted order (seed 0: as given; seed S: one
seeded permutation), which changes only the order of the normal
equations' sums. Prints each run's ATE_sim3, resets, solves and frames/s,
so the spread of the trajectory under float-level perturbations of the
pose solve shows beside the two solvers' difference.

With `--graphs`, the two sides are the fused step of one checkout (TREE,
default the current directory) as its CUDA graphs and as the eager step
(`step_graphs=False`), both in one process, which renders the bench's
world once: the bench's primary (`bench.primary_rep`: 8 warm frames and
`precompile()`, then the timed pipelined run of the other 402 frames,
rendered inside the window), in turns, eager first in even pairs (ABBA).
Prints each run's frames/s, resets, redone dispatches, solves and
ATE_sim3 (bit-equal trajectories on both sides are checked), then the
medians, quartiles and pairs won.

With `--apply-mode`, the two sides are the window BA's apply modes of one
checkout (TREE, default the current directory), "push" and "device", on
`chip_smoke.py` phase 8's workload: the first TEXTURED_N frames of the
bench's textured world rendered on the card, `VOConfig()` with only
`ba.apply_mode` set. Each process warms up (8 frames through `process`,
`precompile()`), then times `--runs` fresh frontends for each `--warm`
count W: W frames through `process` and `precompile()` (none at W = 0),
then `run(pipelined=True)` over the rest, the render inside the window.
`--world-seed` repeats it on other seeds of the world. Prints each run's
frames/s, redone dispatches, resets, solves and ATE_sim3, then the
medians, quartiles and pairs won of each seed.
"""

from __future__ import annotations

import argparse
import json
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


BENCH_CHILD = r"""
import contextlib, json, sys
import chip_smoke as cs
from ya_vo_tpu_torch import bench
counted = getattr(cs, "pose_gn_iterations", None)
with (counted() if counted else contextlib.nullcontext()) as counts:
    out = bench.run_bench(reps=int(sys.argv[1]), probe_steps=1,
                          stamps_frames=bench.STAMPS_WARM + 1,
                          selfcheck=lambda: "skipped")
for i, fps in enumerate(out["fps_reps"]):
    print(json.dumps(dict(
        frames_per_s=fps, resets=out["resets_reps"][i],
        redone=out["redone_reps"][i], ba_solves=out["ba_runs_reps"][i],
        ba_discarded=out["ba_discarded_reps"][i],
        ate_sim3=out["ate_reps"][i], card=out["card"])), flush=True)
if counted:
    print(json.dumps(dict(pose_gn_iterations=cs.iteration_summary(counts))))
"""


ORDERS_CHILD = r"""
import json, sys
import torch
from ya_vo_tpu_torch import bench
from ya_vo_tpu_torch.tracking import pose_solver
solver, seed = sys.argv[1], int(sys.argv[2])
solve = dict(plain=pose_solver.solve_pose_plain,
             kernel=pose_solver.solve_pose)[solver]


def ordered(T, pts, uv, mask, cam, **kw):
    n = len(mask)
    perm = (torch.arange(n) if seed == 0 else torch.randperm(
        n, generator=torch.Generator().manual_seed(seed))).to(mask.device)
    out = solve(T, pts[perm], uv[perm], mask[perm], cam, **kw)
    inliers = torch.empty_like(out.inlier_mask)
    inliers[perm] = out.inlier_mask
    return out._replace(inlier_mask=inliers)


pose_solver.solve_pose = ordered
out = bench.run_bench(reps=1, probe_steps=1,
                      stamps_frames=bench.STAMPS_WARM + 1,
                      selfcheck=lambda: "skipped")
print(json.dumps(dict(
    solver=solver, order_seed=seed, ate_sim3=out["ate_reps"][0],
    resets=out["resets_reps"][0], ba_solves=out["ba_runs_reps"][0],
    redone=out["redone_reps"][0], frames_per_s=out["fps_reps"][0],
    card=out["card"])), flush=True)
"""


GRAPHS_CHILD = r"""
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from ya_vo_tpu_torch import bench
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz import evaluation
dev = torch.device("cuda")
seq = TexturedSequence(n_frames=bench.N_FRAMES, seed=5, device=dev)
gt_cw = np.linalg.inv(seq.poses[:bench.N_FRAMES])
ref = None
for i in range(int(sys.argv[1])):
    for side in (("eager", "graphs") if i % 2 == 0 else ("graphs", "eager")):
        fe, fps = bench.primary_rep(seq, dev, step_graphs=side == "graphs")
        traj = np.stack(fe.trajectory)
        if ref is None:
            ref = traj
        print(json.dumps(dict(
            pair=i, side=side, frames_per_s=fps, resets=fe.n_resets,
            redone=fe.n_redone, ba_solves=fe.n_ba_runs,
            ate_sim3=evaluation.ate_rmse(traj, gt_cw, with_scale=True),
            bit_equal=bool(np.array_equal(traj.view(np.int32),
                                          ref.view(np.int32))),
            card=cs.card_line())), flush=True)
        del fe
"""


APPLY_CHILD = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from ya_vo_tpu_torch import create_frontend
from ya_vo_tpu_torch.config import VOConfig, with_option
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz import evaluation
runs, mode = int(sys.argv[1]), sys.argv[2]
seed = cs.TEXTURED["seed"] if sys.argv[4] == "None" else int(sys.argv[4])
warms = [int(w) for w in sys.argv[3].split(",")]
cfg = with_option(VOConfig(), "ba", apply_mode=mode)
seq = TexturedSequence(**dict(cs.TEXTURED, seed=seed), device="cuda")
n = cs.TEXTURED_N
gt_cw = np.linalg.inv(seq.poses[:n])
fe = create_frontend(cfg, seq.cam, device="cuda")      # warm-up, untimed
for f in range(8):
    fe.process(seq.frame(f))
fe.precompile()
for rep in range(runs):
    for warm in warms:
        fe = create_frontend(cfg, seq.cam, device="cuda")
        for f in range(warm):
            fe.process(seq.frame(f))
        if warm:
            fe.precompile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe.run((seq.frame(f) for f in range(warm, n)), pipelined=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(json.dumps(dict(
            seed=seed, warm=warm, frames_per_s=(n - warm) / dt,
            redone=fe.n_redone, resets=fe.n_resets, ba_solves=fe.n_ba_runs,
            ba_discarded=fe.n_ba_discarded,
            ate_sim3=evaluation.ate_rmse(np.stack(fe.trajectory), gt_cw,
                                         with_scale=True),
            card=cs.card_line())), flush=True)
"""


def run_side(tree: str, runs: int, detect: bool = False,
             apply_mode: str = None, warms=(8,), seed: int = None,
             bench: bool = False, order=None) -> list:
    if detect:
        args = ["-c", DETECT_CHILD]
    elif order:
        args = ["-c", ORDERS_CHILD, *map(str, order)]
    elif bench:
        args = ["-c", BENCH_CHILD, str(runs)]
    elif apply_mode:
        args = ["-c", APPLY_CHILD, str(runs), apply_mode,
                ",".join(map(str, warms)), str(seed)]
    else:
        args = ["-c", CHILD, str(runs)]
    out = subprocess.run([sys.executable, *args],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stderr[-2000:]}")
    if detect:
        return out.stdout.strip().splitlines()[-1:]
    if apply_mode or bench or order:
        return [json.loads(x) for x in out.stdout.split("\n") if x]
    return [float(x) for x in out.stdout.split()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", default=".")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--detect", action="store_true",
                    help="time one fast.detect call instead of frames/s")
    ap.add_argument("--bench", action="store_true",
                    help="the bench's primary frames/s (402 textured "
                    "frames) instead of the stamps world's")
    ap.add_argument("--apply-mode", action="store_true",
                    help="push against device BA apply in one checkout")
    ap.add_argument("--warm", type=int, nargs="+", default=[8],
                    help="with --apply-mode: frames through `process` "
                    "before each timed run, one run each (0: pipelined "
                    "from frame 0, as chip_smoke.py phase 11 (a))")
    ap.add_argument("--world-seed", type=int, nargs="+", default=None,
                    help="with --apply-mode: the textured world's seeds, "
                    "each alternated in turn (default chip_smoke.py "
                    "phase 8's)")
    ap.add_argument("--graphs", action="store_true",
                    help="the bench's primary with the step graphs "
                    "against the eager step, in one process")
    ap.add_argument("--orders", action="store_true",
                    help="the bench's ATE_sim3 under permuted point orders "
                    "of each pose solver, in one checkout")
    ap.add_argument("--order-seed", type=int, nargs="+", default=[0, 1, 2],
                    help="with --orders: 0 keeps the points' order, S > 0 "
                    "permutes them with seed S")
    ap.add_argument("--solver", nargs="+", default=["plain", "kernel"],
                    choices=["plain", "kernel"],
                    help="with --orders: the pose solvers to run")
    args = ap.parse_args()
    if args.orders:
        for solver in args.solver:
            for seed in args.order_seed:
                rec, = run_side(os.path.abspath(args.parent), 1,
                                order=(solver, seed))
                print(json.dumps(rec), flush=True)
        return 0
    if args.graphs:
        out = subprocess.run(
            [sys.executable, "-c", GRAPHS_CHILD, str(args.pairs)],
            cwd=os.path.abspath(args.parent), capture_output=True, text=True,
            timeout=1800)
        if out.returncode != 0:
            raise RuntimeError(out.stderr[-2000:])
        recs = [json.loads(x) for x in out.stdout.split("\n") if x]
        got = {side: [r["frames_per_s"] for r in recs if r["side"] == side]
               for side in ("eager", "graphs")}
        wins = {side: sum(
            max((r for r in recs if r["pair"] == i),
                key=lambda r: r["frames_per_s"])["side"] == side
            for i in range(args.pairs)) for side in got}
        for r in recs:
            print(json.dumps(r), flush=True)
        summarize(got, wins, args.pairs)
        return 0 if all(r["bit_equal"] for r in recs) else 1
    if args.apply_mode:
        return apply_modes(os.path.abspath(args.parent), args.pairs,
                           args.runs, args.warm, args.world_seed)
    if args.change is None:
        ap.error("PARENT_DIR and CHANGE_DIR are required")
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    if args.detect:
        for i in range(args.pairs):
            for name in (("parent", "change") if i % 2 == 0
                         else ("change", "parent")):
                line, = run_side(sides[name], 0, detect=True)
                print(f"pair {i} {name} detect: {line}", flush=True)
        return 0
    if args.bench:
        got, wins = alternate(
            ("parent", "change"), args.pairs,
            lambda name: run_side(sides[name], args.runs, bench=True),
            lambda recs: " ".join(json.dumps(r) for r in recs))
        summarize(got, wins, args.pairs)
        return 0
    got, wins = alternate(
        ("parent", "change"), args.pairs,
        lambda name: run_side(sides[name], args.runs),
        lambda xs: " ".join(f"{x:.2f}" for x in xs))
    summarize(got, wins, args.pairs)
    return 0


def alternate(names, pairs: int, side, show):
    """`pairs` pairs of runs of the two sides `names`, the first side
    first in even pairs; `side(name)` returns a run's frames/s list (or
    records with `frames_per_s`). Returns (frames/s by side, pairs won)."""
    got = {name: [] for name in names}
    wins = {name: 0 for name in names}
    for i in range(pairs):
        order = names if i % 2 == 0 else names[::-1]
        pair = {}
        for name in order:
            out = side(name)
            print(f"pair {i} {name}: {show(out)}", flush=True)
            pair[name] = [x["frames_per_s"] if isinstance(x, dict) else x
                          for x in out
                          if not isinstance(x, dict) or "frames_per_s" in x]
            got[name] += pair[name]
        means = {name: float(np.mean(v)) for name, v in pair.items()}
        if len(set(means.values())) > 1:
            wins[max(means, key=means.get)] += 1
    return got, wins


def apply_modes(tree: str, pairs: int, runs: int, warms, seeds) -> int:
    """`--apply-mode`: push against device apply, alternating, on each
    world seed in turn."""
    for seed in seeds or [None]:
        print(f"world seed {'of phase 8' if seed is None else seed}:",
              flush=True)
        got, wins = alternate(
            ("push", "device"), pairs,
            lambda mode: run_side(tree, runs, apply_mode=mode, warms=warms,
                                  seed=seed),
            lambda recs: " ".join(json.dumps(r) for r in recs))
        summarize(got, wins, pairs)
    return 0


def summarize(got: dict, wins: dict, pairs: int) -> None:
    for name, v in got.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"{name}: median {med:.2f} frames/s, quartiles {q1:.2f}-"
              f"{q3:.2f}, range {min(v):.2f}-{max(v):.2f}, "
              f"pairs won {wins[name]} of {pairs}")


if __name__ == "__main__":
    sys.exit(main())
