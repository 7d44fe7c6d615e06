#!/usr/bin/env python3
"""Pose GN's kernel (K4) on recorded inputs, on one CUDA card.

    python3 port_pose_gn.py collect [--csrc DIR] [--out DIR] [--max 6]
                            [--all-out FILE]
    python3 port_pose_gn.py norms [--csrc DIR] [--data DIR] [--out FILE]
    python3 port_pose_gn.py record [--csrc DIR] [--data DIR] [--out FILE]
    python3 port_pose_gn.py time [--csrc-list DIR ...] [--data DIR]
                            [--pairs 2]
    python3 port_pose_gn.py frames [--csrc-list DIR ...] [--pairs 2]
                            [--preload DIR]
    python3 port_pose_gn.py launch_cost [--csrc DIR]

Run from the root of a checkout. DIR defaults to tests/torch_data/pose_gn
(`selfcheck.POSE_DATA`). collect, norms and record launch the K4 built from
--csrc (another checkout's `ya_vo_tpu_torch/csrc`; default this
checkout's).

collect: a real step's solve inputs (`selfcheck.textured_solve_inputs()`)
to DIR/step.npz, then the bench's call as `port_frames_ab.py --bench`
runs it (`bench.run_bench`, one rep of the 410-frame textured world at
VOConfig(), a 1-step probe and a 7-frame stamps secondary; the eager
step, as a step graph's replay calls no Python) with the inputs of every
`solve_pose` call kept. Prints the histogram of the iterations K4
ran, and writes up to --max of the solves that ran to the 40-iteration
cap, spread over the call, to DIR/capped_s<solve>.npz
(`selfcheck.save_pose_inputs`; <solve> is the solve's index in the call).
With --all-out, every solve's inputs and K4's iterations go to FILE too
(npz, keys `<solve>:<name>`; `port_jax_reference.py --runs pose_caps`
reads it).

norms: for each capped file, the poses T_n after n = 0..40 iterations of K4
(`iters=n`) and of `solve_pose_plain` on the card; each step's norm
||se3_log(T_n T_{n-1}^-1)|| in float64; at each T_n the valid points past
the chi2 gate and how many crossed it since T_{n-1}; and the iterations of
K4, of the plain version and of the plain version in float64; and the norm
of the plain version's step (`pose_solver.gn_step`, the step its exit
reads) at each of K4's poses T_0..T_39, free of the rounding of T that the
logarithm sees. One JSON line an input, and all of them in FILE.

record: the outputs of K4 on every case of
`selfcheck.pose_gn_golden_cases` to FILE (default DIR/golden.npz).

time: the K4 of each --csrc-list directory (a checkout's
`ya_vo_tpu_torch/csrc`, or a copy with a variant of pose_gn.cu; default
this checkout's), each built into its own library, all loaded in this one
process: each held to DIR/golden.npz, then in turns (the list's order,
then reversed, for --pairs rounds) each one's device ms a call (profiler
events of `pose_gn_kernel`) and call ms (CUDA events, host issue
included) at the real step (step.npz) and at the first capped input (40
iterations); then the medians.

frames: the bench's primary (`bench.primary_rep`: a fresh frontend through
8 warm frames and `precompile()`, then the timed pipelined run of the
other 402 frames of the 410-frame textured world at VOConfig(), rendered
inside the window) once each --csrc-list K4 in turns, in this one
process, for --pairs rounds, the list's order in even rounds and reversed
in odd ones (with two builds and an even --pairs, ABBA): frames/s, resets,
solves, redone dispatches, ATE_sim3, K4's launches and the step graphs'
replays a run; then each build's medians, overall and at each position in
its round, and the rounds each won. Each frontend captures its step graphs
with the K4 loaded when it starts, so every run's K4 launches from a
graph of its own. Unlike `port_frames_ab.py --bench`, whose sides are
processes of their own, the K4 builds share one process and its state, so
what differs between them is the kernel alone. --preload DIR first runs
one solve of the real step with the K4 built from DIR.

launch_cost: the host's issue time of a tiny PyTorch kernel, 20,000 back
to back, alone, then with one K4 solve (built from --csrc) after every 700
of them, then alone again, three times each, in a process that launches
no other K4.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ya_vo_tpu_torch import _build, bench
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.tracking import pose_solver
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz import evaluation


def collect(out: Path, n_max: int, all_out: Path = None) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    *step, gn = sc.textured_solve_inputs()
    sc.save_pose_inputs(out / "step.npz", *step, gn)
    solves = []
    solve = pose_solver.solve_pose

    def kept(T, pts, uv, mask, cam, **kw):
        res, n = solve(T, pts, uv, mask, cam, with_iters=True, **kw)
        solves.append((n, [t.clone() for t in (T, pts, uv, mask)], cam, kw))
        return res

    pose_solver.solve_pose = kept
    try:
        rec = bench.run_bench(reps=1, probe_steps=1,
                              stamps_frames=bench.STAMPS_WARM + 1,
                              selfcheck=lambda: "skipped", step_graphs=False)
    finally:
        pose_solver.solve_pose = solve
    capped = [i for i, (n, _, _, kw) in enumerate(solves)
              if int(n) == kw["iters"]]
    picks = sorted({capped[i] for i in np.linspace(
        0, len(capped) - 1, min(n_max, len(capped))).round().astype(int)}
    ) if capped else []
    for i in picks:
        _, ts, cam, kw = solves[i]
        sc.save_pose_inputs(out / f"capped_s{i:04d}.npz", *ts, cam, kw,
                            solve=np.int64(i))
    if all_out:
        arrays = dict(n=np.int64(len(solves)))
        for i, (n, ts, cam, kw) in enumerate(solves):
            arrays.update(sc.pose_inputs_arrays(*ts, cam, kw,
                                                prefix=f"{i}:"))
            arrays[f"{i}:iterations"] = np.int64(int(n))
        np.savez_compressed(all_out, **arrays)
    return dict(cs.iteration_summary([n for n, *_ in solves]),
                capped=len(capped), capped_solves=capped, saved=picks,
                ate_sim3=rec["ate_reps"][0], resets=rec["resets_reps"][0],
                ba_solves=rec["ba_runs_reps"][0], card=sc.card_line())


def step_norms(T_init, pts, uv, mask, cam, gn: dict) -> dict:
    thr = gn["chi2_threshold"]

    def poses(solve):
        return [T_init] + [solve(T_init, pts, uv, mask, cam,
                                 **dict(gn, iters=n)).pose
                           for n in range(1, gn["iters"] + 1)]

    def steps(Ts):
        return [float(torch.linalg.norm(lie.se3_log(
            b.double() @ lie.se3_inverse(a.double()))))
            for a, b in zip(Ts, Ts[1:])]

    kern = poses(pose_solver.solve_pose)
    kw = {k: v for k, v in gn.items() if k != "iters"}
    plain_at_kernel = [float(torch.linalg.norm(pose_solver.gn_step(
        T, pts, uv, mask, cam, **kw))) for T in kern[:-1]]
    gated = []
    for T in kern:
        r, _, Z = pose_solver._residuals_and_jacobian(T, pts, uv, cam)
        gated.append(mask & (Z > 1e-3) & ((r * r).sum(-1) > thr))
    f64 = [t.double() for t in (T_init, pts, uv)]
    return dict(
        n_points=len(mask), n_masked_in=int(mask.sum()),
        t_abs_max=float(T_init[:3, 3].abs().max()),
        iterations_kernel=int(pose_solver.solve_pose(
            T_init, pts, uv, mask, cam, with_iters=True, **gn)[1]),
        iterations_plain=int(pose_solver.solve_pose_plain(
            T_init, pts, uv, mask, cam, with_iters=True, **gn)[1]),
        iterations_plain_f64=int(pose_solver.solve_pose_plain(
            *f64, mask, cam, with_iters=True, **gn)[1]),
        steps_kernel=steps(kern),
        steps_plain=steps(poses(pose_solver.solve_pose_plain)),
        plain_steps_at_kernel_poses=plain_at_kernel,
        gated=[int(g.sum()) for g in gated],
        gate_crossings=[int((a != b).sum())
                        for a, b in zip(gated, gated[1:])])


def use_library(csrc) -> None:
    """Make the wrappers launch the kernels built from `csrc`."""
    _build._lib = _build.load_library(_build.build(Path(csrc)))


def time_kernels(csrcs, data: Path, pairs: int) -> list:
    libs = {str(c): _build.load_library(_build.build(Path(c)))
            for c in csrcs}
    for name, lib in libs.items():
        _build._lib = lib
        print(f"{name} goldens: " + json.dumps(sc.check_pose_gn_goldens(
            data / sc.POSE_GOLDEN.name)), flush=True)
    inputs = {"step": sc.load_pose_inputs(data / "step.npz")}
    capped = sorted(data.glob("capped_*.npz"))
    if capped:
        inputs["capped"] = sc.load_pose_inputs(capped[0])
    rows = []
    for i in range(pairs):
        for name in (list(libs) if i % 2 == 0 else list(libs)[::-1]):
            _build._lib = libs[name]
            for case, (*args, gn) in inputs.items():
                def fn(args=args, gn=gn):
                    return pose_solver.solve_pose(*args, **gn)
                it = pose_solver.solve_pose(*args, with_iters=True, **gn)[1]
                rows.append(dict(
                    pair=i, kernel=name, case=case, iterations=int(it),
                    device_ms=sc.device_ms(fn, "pose_gn_kernel",
                                           launches_per_call=1),
                    call_ms=sc.time_ms(fn)))
                print(json.dumps(rows[-1]), flush=True)
    return rows


def frames_two(csrcs, pairs: int, preload=None, data=sc.POSE_DATA) -> list:
    """The bench's primary (`bench.primary_rep`) once a K4 build in turns,
    all in this process: frames/s, resets, solves, redone dispatches,
    ATE_sim3, K4's launches and graph replays a run, with the run's
    position in its round. With `preload`, first one solve of the real
    step with the K4 built from it."""
    libs = {str(c): _build.load_library(_build.build(Path(c)))
            for c in csrcs}
    if preload is not None:
        _build._lib = _build.load_library(_build.build(Path(preload)))
        *args, gn = sc.load_pose_inputs(data / "step.npz")
        pose_solver.solve_pose(*args, **gn)
        torch.cuda.synchronize()
    dev = torch.device("cuda")
    seq = TexturedSequence(n_frames=bench.N_FRAMES, seed=5, device=dev)
    gt_cw = np.linalg.inv(seq.poses[:bench.N_FRAMES])
    rows = []
    for i in range(pairs):
        order = list(libs) if i % 2 == 0 else list(libs)[::-1]
        for pos, name in enumerate(order):
            _build._lib = libs[name]
            _build.reset_launches()
            fe, fps = bench.primary_rep(seq, dev)
            rows.append(dict(
                pair=i, position=pos, kernel=name, frames_per_s=fps,
                resets=fe.n_resets, ba_solves=fe.n_ba_runs,
                redone=fe.n_redone,
                ate_sim3=float(evaluation.ate_rmse(
                    np.stack(fe.trajectory), gt_cw, with_scale=True)),
                pose_gn_launches=_build.LAUNCHES["pose_gn"],
                graph_replays=_build.REPLAYS["graphs"]))
            print(json.dumps(rows[-1]), flush=True)
            del fe
    return rows


def launch_cost(csrc, data=sc.POSE_DATA, reps: int = 20000,
                every: int = 700) -> dict:
    """The host's time to issue a tiny PyTorch kernel (`x.add_(1)` on one
    element, `reps` back to back, the clock stopped before the closing
    synchronize), three times each: alone before any K4 launch; with one
    K4 solve of the real step (built from `csrc`) after every `every` of
    them, as a frame interleaves its kernels (the solves' own issue time
    taken out); alone again after them. Also the wall time of each loop,
    synchronize included, a tiny kernel."""
    x = torch.zeros(1, device="cuda")
    _build._lib = _build.load_library(_build.build(Path(csrc)))
    *args, gn = sc.load_pose_inputs(data / "step.npz")

    def loop(with_k4: bool) -> dict:
        torch.cuda.synchronize()
        solve_s = 0.0
        t0 = time.perf_counter()
        for i in range(reps):
            x.add_(1.0)
            if with_k4 and i % every == every - 1:
                s0 = time.perf_counter()
                pose_solver.solve_pose(*args, **gn)
                solve_s += time.perf_counter() - s0
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return dict(host_us=(t1 - t0 - solve_s) / reps * 1e6,
                    wall_us=(t2 - t0) / reps * 1e6,
                    k4_issue_us=solve_s / (reps // every) * 1e6
                    if with_k4 else None)

    loop(False)
    return dict(csrc=str(csrc), before=[loop(False) for _ in range(3)],
                interleaved=[loop(True) for _ in range(3)],
                after=[loop(False) for _ in range(3)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["collect", "norms", "record", "time",
                                     "frames", "launch_cost"])
    ap.add_argument("--data", type=Path, default=sc.POSE_DATA)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--max", type=int, default=6)
    ap.add_argument("--all-out", type=Path, default=None)
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--csrc-list", type=Path, nargs="+", default=None)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--preload", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_pose_gn: no CUDA device", file=sys.stderr)
        return 2
    card = sc.card_line()
    print(card, flush=True)
    if args.what in ("collect", "norms", "record"):
        use_library(args.csrc)
    if args.what == "collect":
        print(json.dumps(collect(args.out or args.data, args.max,
                                 args.all_out)))
    elif args.what == "norms":
        rows = {}
        for path in sorted(args.data.glob("capped_*.npz")):
            *inputs, gn = sc.load_pose_inputs(path)
            rows[path.stem] = step_norms(*inputs, gn)
            print(json.dumps({path.stem: rows[path.stem]}), flush=True)
        if args.out:
            args.out.write_text(json.dumps(dict(rows, card=card), indent=1))
    elif args.what == "record":
        out = args.out or args.data / sc.POSE_GOLDEN.name
        n = sc.record_pose_gn_goldens(out, data=args.data)
        print(json.dumps(dict(recorded=n, csrc=str(args.csrc),
                              out=str(out))))
    elif args.what == "launch_cost":
        print(json.dumps(dict(launch_cost(args.csrc, args.data), card=card)))
    elif args.what == "frames":
        csrcs = args.csrc_list or [_build.CSRC]
        rows = frames_two(csrcs, args.pairs, args.preload, args.data)
        for name in map(str, csrcs):
            fps = [x["frames_per_s"] for x in rows if x["kernel"] == name]
            q1, med, q3 = np.percentile(fps, [25, 50, 75])
            by_pos = {p: float(np.median(
                [x["frames_per_s"] for x in rows
                 if x["kernel"] == name and x["position"] == p]))
                for p in sorted({x["position"] for x in rows})}
            print(json.dumps(dict(kernel=name, frames_per_s_median=med,
                                  quartiles=[q1, q3], runs=len(fps),
                                  median_by_position=by_pos, card=card)))
        wins = [max((x for x in rows if x["pair"] == i),
                    key=lambda x: x["frames_per_s"])["kernel"]
                for i in range(args.pairs)]
        print(json.dumps({"pairs_won": {str(c): wins.count(str(c))
                                        for c in csrcs}}))
    else:
        csrcs = args.csrc_list or [_build.CSRC]
        rows = time_kernels(csrcs, args.data, args.pairs)
        for name in map(str, csrcs):
            for case in ("step", "capped"):
                r = [x for x in rows if x["kernel"] == name
                     and x["case"] == case]
                if not r:
                    continue
                print(json.dumps(dict(
                    kernel=name, case=case, iterations=r[0]["iterations"],
                    device_ms_median=float(np.median(
                        [x["device_ms"] for x in r])),
                    call_ms_median=float(np.median(
                        [x["call_ms"] for x in r])), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
