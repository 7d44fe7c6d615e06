#!/usr/bin/env python3
"""The window BA's kernel (K5) on one CUDA card: its recorded bits, its
time, its phases, and its distance to float64 solves.

    python3 port_window_gn.py record [--out FILE]
    python3 port_window_gn.py time [--pairs 2] [--reps 50] [SRC.cu ...]
    python3 port_window_gn.py phases [--reps 50] SRC.cu [SRC.cu ...]
    python3 port_window_gn.py accuracy [--no-fma] [--seeds 12] [SRC.cu ...]
    python3 port_window_gn.py improvements [CASE ...]

Run from the root of a checkout. SRC.cu is a window_gn.cu (another
checkout's, or a variant under build/) built alone with the build's flags
and loaded in place of the kernel library.

record: phase 5's last window problem of chip_smoke.py (VOConfig() over
the 40-frame stamps world, pipelined), then K5's outputs (poses,
landmarks, cost_initial, cost_final, n_obs and n_iters, as bits) on every
case of `selfcheck.window_bits_keys()`: the five recorded windows of
tests/torch_data/window_gn at their settings, phase 5's last window,
`synthetic`, `full_width` and phase 5's window again at iters 0 and at 8
iterations with no early exit, the card tests' other shapes, and seeded
windows of `scaling_bench.window_problem` at L 4096 (16 at W 8, 4 at W 12,
4 at W 16) at the live settings. Writes FILE (default
`selfcheck.WINDOW_BITS`, tests/torch_data/window_gn/k5_bits.npz) with
phase 5's problem and each case's input digest; `selfcheck.
check_window_gn_bits` holds K5 to it.

time: this checkout's K5 and each SRC.cu's, all in this one process: each
first held to the recorded bits on phase 5's window and the full-width
golden, then in turns (the builds' order, then reversed, for --pairs
rounds: with one SRC.cu and an even --pairs, ABBA) on phase 5's last
window, the full-width golden and the 16 seeded W 8 windows: K5's device
ms a launch (CUDA events around --reps launches queued behind a sleep on
the card, so the host's issue is not inside), the whole solve's
(`solve_window`: the layout's sort and search too, the same way) and the
call's ms (host clock around a call and a synchronize, median of --reps).
One JSON line a build and round, then each build's medians and the
card's name and power limit.

phases: each SRC.cu built with -DYAVO_K5_PHASES, which makes thread 0 of
every block add clock64() differences at the ends of the kernel's phases
(`PHASES`) into a device array read by `yavo_window_gn_phases`; over
--reps launches on phase 5's last window and on the full-width golden,
block 0's cycles a launch by phase with their share, the mean and the
largest over the blocks, and K5's device ms a launch (as `time`).

accuracy: for this checkout's K5 and each variant (--no-fma adds this
checkout's source with its fmaf calls written as a multiply and an add,
each rounded on its own), every recorded window
(`selfcheck.WINDOW_CASES`) held to JAX's solve at
`selfcheck.hold_window_solution`'s tolerances (pass, iterations,
reprojection px), and over --seeds windows of
`scaling_bench.window_problem` (W 8, L 1024, pose noise 0.03, the live
settings) the medians of the largest pose difference and of the relative
cost difference to the float64 plain solve after 1 and 2 iterations, with
the plain version's on the card and on the CPU beside them. One JSON line
a build.

improvements: each iteration's relative cost decrease (cost plus the
prior's, evaluated in float64 on the CPU at each version's state after
1, 2, ... iterations) of K5, of the plain version on the card and on the
CPU, on the recorded windows (default frontend0, frontend1, synthetic):
where it sits beside `rel_tol` decides the iterations each runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.ba import window, window_cuda
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.parallel import scaling_bench
from ya_vo_tpu_torch.utils import synthetic

LIVE = dict(huber_delta=2.4477, damping=1e-4, n_fixed_poses=2,
            pose_prior_weight=100.0)
# the phases that -DYAVO_K5_PHASES times, in the order of their indices
PHASES = ("start", "A terms", "A accumulate", "round trip", "B assembly",
          "B LU", "back-substitution", "C", "C barrier", "D", "end")
PHASE_BLOCKS, N_PHASE_SLOTS = 256, 12
# cycles of the sleep that holds the card while the host queues launches
SLEEP_CYCLES = 100_000_000
SOURCE = _build.CSRC / "window_gn.cu"
# after the includes: every fmaf a multiply and an add, each rounded
NO_FMA = "#define fmaf(a, b, c) ((a) * (b) + (c))\n"


def variant_libraries(srcs, out: Path, defines=()) -> dict:
    """Each window_gn.cu of `srcs` built alone into `out` (with the -D
    `defines`), every nvcc started at once, and loaded: {src: library}."""
    jobs = []
    for i, src in enumerate(srcs):
        lib = out / f"{Path(src).stem}_{len(defines)}_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o",
               str(lib), str(src)]
        jobs.append((str(src), lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for src, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}: {err}")
        libs[src] = _build.load_library(lib)
    return libs


def variant_library(src: Path, out: Path):
    """window_gn.cu at `src` built alone into `out` and loaded."""
    return variant_libraries([src], out)[str(src)]


def no_fma_source(out: Path) -> Path:
    s = SOURCE.read_text()
    anchor = "namespace cg = cooperative_groups;\n"
    path = out / "window_gn_no_fma.cu"
    path.write_text(s.replace(anchor, anchor + NO_FMA, 1))
    return path


def phase5_window():
    """(prob, cam, kw) of phase 5's last window solve: chip_smoke.py's
    production path, VOConfig() over the 40-frame stamps world,
    pipelined."""
    from ya_vo_tpu_torch import create_frontend
    from ya_vo_tpu_torch.config import VOConfig

    frames, _, _, cam = synthetic.render_sequence(**synthetic.STAMPS)
    fe = create_frontend(VOConfig(), cam, device="cuda")
    fe.run(frames[:2])
    fe.run(frames[2:], pipelined=True)
    if fe._last_ba_prob is None:
        raise RuntimeError("phase 5's run solved no window")
    # the frontend's keywords, with solve_window's rel_tol
    return fe._last_ba_prob, fe.cam, {"rel_tol": 1e-3, **fe._window_kw}


def record(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    phase5 = phase5_window()
    t0 = time.perf_counter()
    n = sc.record_window_gn_bits(args.out, phase5)
    with np.load(args.out) as z:
        iters = {k: int(z[f"{k}:n_iters"]) for k in json.loads(
            str(z["keys"]))}
    print(json.dumps(dict(out=str(args.out), cases=n, n_iters=iters,
                          seconds=time.perf_counter() - t0,
                          launches=_build.LAUNCHES["window_gn"])),
          flush=True)
    print(sc.card_line(), flush=True)
    return 0


def timing_problems(seeded: bool = True) -> dict:
    """name -> [(prob, cam, kw), ...] on the card: phase 5's last window
    (kept in the recorded bits), the full-width golden and, with
    `seeded`, the 16 seeded W 8 windows of the recorded bits."""
    with np.load(sc.WINDOW_BITS) as z:
        out = {"phase5": [sc.load_window_problem(
            z, sc.WINDOW_PHASE5_INPUT)]}
    prob, cam, kw, _ = sc.load_window_case("full_width")
    out["full_width"] = [(prob, cam, kw)]
    if seeded:
        n = dict(sc.WINDOW_BITS_SEEDED)[8]
        out["seeded_w8"] = [sc.window_bits_case(f"seeded_w8_s{s}")
                            for s in range(n)]
    return out


def queued_ms(fn, reps: int) -> float:
    """Device ms a call of fn over `reps` calls issued while a sleep holds
    the card, timed by CUDA events around them: back to back on the card,
    with the host's issue outside."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of a call of fn and a synchronize."""
    fn()
    torch.cuda.synchronize()
    v = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        v.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(v)


def solve_times(problems, reps: int) -> dict:
    """K5's, the solve's and the call's ms (means over the problems) and
    the iterations K5 ran on each."""
    k5, solve, call, iters = [], [], [], []
    for prob, cam, kw in problems:
        layout = window.csr(prob.obs_lm, prob.landmarks.shape[0])
        k5.append(queued_ms(lambda: window_cuda.solve(
            prob, cam, layout, **kw), reps))
        solve.append(queued_ms(lambda: window.solve_window(
            prob, cam, **kw), reps))
        call.append(host_ms(lambda: window.solve_window(prob, cam, **kw),
                            reps))
        iters.append(int(window.solve_window(prob, cam, **kw).n_iters))
    return dict(k5_device_ms=statistics.fmean(k5),
                solve_device_ms=statistics.fmean(solve),
                call_ms=statistics.fmean(call), n_iters=iters)


def load_builds(sources, tmp: Path, defines=(), checkout: bool = True):
    builds = {"checkout": _build.library()} if checkout else {}
    builds.update(variant_libraries(sources, tmp, defines))
    return builds


def time_builds(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = sc.card_line()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT.parent) as tmp:
        builds = load_builds(args.sources, Path(tmp))
        problems = timing_problems()
        bits = {}
        for name, lib in builds.items():
            _build._lib = lib
            try:
                bits[name] = sc.check_window_gn_bits(
                    keys=(sc.WINDOW_PHASE5, "full_width"))
            except RuntimeError as e:
                bits[name] = dict(error=str(e))
            print(f"{name} bits: " + json.dumps(bits[name]), flush=True)
        rows = []
        for r in range(args.pairs):
            order = list(builds) if r % 2 == 0 else list(builds)[::-1]
            for pos, name in enumerate(order):
                _build._lib = builds[name]
                row = dict(round=r, position=pos, build=name,
                           **{k: solve_times(v, args.reps)
                              for k, v in problems.items()})
                rows.append(row)
                print(json.dumps(row), flush=True)
    summary = {name: {case: {m: statistics.median(
        row[case][m] for row in rows if row["build"] == name)
        for m in ("k5_device_ms", "solve_device_ms", "call_ms")}
        for case in problems} for name in builds}
    print("medians: " + json.dumps(dict(summary, bits_equal={
        k: "error" not in v for k, v in bits.items()}, card=card)),
        flush=True)
    print(card, flush=True)
    return 0


def phases(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = sc.card_line()
    size = PHASE_BLOCKS * N_PHASE_SLOTS
    buf = (ctypes.c_ulonglong * size)()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT.parent) as tmp:
        builds = load_builds(args.sources, Path(tmp),
                             defines=("-DYAVO_K5_PHASES",), checkout=False)
        problems = timing_problems(seeded=False)
        for name, lib in builds.items():
            _build._lib = lib
            read = lib.yavo_window_gn_phases
            read.argtypes = [ctypes.c_void_p]
            read.restype = ctypes.c_int
            for case, [(prob, cam, kw)] in problems.items():
                layout = window.csr(prob.obs_lm, prob.landmarks.shape[0])

                def k5():
                    return window_cuda.solve(prob, cam, layout, **kw)

                n_iters = int(k5()[5])
                ms = queued_ms(k5, args.reps)
                torch.cuda.synchronize()
                if read(ctypes.addressof(buf)) != 0:
                    raise RuntimeError("yavo_window_gn_phases failed")
                for _ in range(args.reps):
                    k5()
                torch.cuda.synchronize()
                if read(ctypes.addressof(buf)) != 0:
                    raise RuntimeError("yavo_window_gn_phases failed")
                c = np.frombuffer(buf, np.uint64).reshape(
                    PHASE_BLOCKS, N_PHASE_SLOTS)[:, :len(PHASES)]
                c = c.astype(np.float64) / args.reps
                blocks = c[c.sum(1) > 0]
                total = float(blocks[0].sum())
                print(json.dumps(dict(
                    build=name, case=case, n_iters=n_iters,
                    k5_device_ms=ms, blocks=len(blocks),
                    block0_cycles=total,
                    mhz=total / ms / 1e3,
                    phases={ph: dict(block0_cycles=float(blocks[0][i]),
                                     share=float(blocks[0][i]) / total,
                                     ms=float(blocks[0][i]) / total * ms,
                                     mean_cycles=float(blocks[:, i].mean()),
                                     max_cycles=float(blocks[:, i].max()))
                            for i, ph in enumerate(PHASES)},
                    card=card)), flush=True)
    print(card, flush=True)
    return 0


def accuracy(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    cam = synthetic.kitti_camera()
    probs = [scaling_bench.window_problem(1024, 8, seed=s, device="cuda",
                                          pose_pert=0.03)
             for s in range(args.seeds)]
    exact = {(s, it): window.solve_window_plain(
        sc._as_float64(p), cam, iters=it, rel_tol=-1.0, **LIVE)
        for s, p in enumerate(probs) for it in (1, 2)}

    def seeds(solve, device):
        out = {}
        for it in (1, 2):
            v = []
            for s, p in enumerate(probs):
                p = window.BAProblem(*(t.to(device) for t in p))
                o = solve(p, cam, iters=it, rel_tol=-1.0, **LIVE)
                ex = exact[s, it]
                v.append((float((o.poses.cpu().double()
                                 - ex.poses.cpu()).abs().max()),
                          abs(float(o.cost_final) - float(ex.cost_final))
                          / float(ex.cost_final)))
            v = np.array(v)
            out[f"iters{it}"] = dict(poses_median=float(np.median(v[:, 0])),
                                     cost_rel_median=float(
                                         np.median(v[:, 1])))
        return out

    print("plain: " + json.dumps(dict(
        card=seeds(window.solve_window_plain, "cuda"),
        cpu=seeds(window.solve_window_plain, "cpu"))), flush=True)
    builds = {"checkout": _build.library()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT.parent) as tmp:
        tmp = Path(tmp)
        srcs = [Path(s) for s in args.sources]
        if args.no_fma:
            srcs.insert(0, no_fma_source(tmp))
        for src in srcs:
            builds[src.stem] = variant_library(src, tmp)
        for name, lib in builds.items():
            _build._lib = lib
            rec = {}
            for case in sc.WINDOW_CASES:
                prob, c, kw, ref = sc.load_window_case(case, "cuda")
                r = window.solve_window(prob, c, **kw)
                try:
                    d = sc.hold_window_solution(
                        prob, c, kw, r, ref,
                        strict_poses=case in sc.WINDOW_STRICT_POSES)
                    rec[case] = dict(ok=True, iterations=d["n_iters"],
                                     reproj_px=d["reproj_px"])
                except RuntimeError as e:
                    rec[case] = dict(ok=False, error=str(e))
            rec["seeds"] = seeds(window.solve_window, "cuda")
            print(f"{name}: " + json.dumps(rec), flush=True)
    print(sc.card_line(), flush=True)
    return 0


def improvements(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.cases or ("frontend0", "frontend1", "synthetic"):
        p64, cam, kw, _ = sc.load_window_case(name, "cpu")
        p64 = sc._as_float64(p64)
        init_inv = torch.linalg.inv(p64.poses)
        seg = window.segments(p64.obs_lm, p64.landmarks.shape[0])

        def total(poses, lms):
            c = window._obs_terms(poses.cpu().double(), lms.cpu().double(),
                                  p64, cam, kw["huber_delta"], seg)[4]
            d = lie.se3_log(poses.cpu().double() @ init_inv)
            return float(c + 0.5 * kw["pose_prior_weight"] * (d * d).sum())

        out = {}
        for label, dev, solve in (
                ("k5", "cuda", window.solve_window),
                ("plain_card", "cuda", window.solve_window_plain),
                ("plain_cpu", "cpu", window.solve_window_plain)):
            prob = sc.load_window_case(name, dev)[0]
            costs = [total(prob.poses, prob.landmarks)]
            for it in range(1, 6):
                r = solve(prob, cam, **dict(kw, iters=it, rel_tol=-1.0))
                costs.append(total(r.poses, r.landmarks))
            r = solve(prob, cam, **kw)
            out[label] = dict(iterations=int(r.n_iters), improvements=[
                (a - b) / a for a, b in zip(costs[:-1], costs[1:])])
        print(f"{name}: " + json.dumps(out), flush=True)
    print(sc.card_line(), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("--out", type=Path, default=sc.WINDOW_BITS)
    t = sub.add_parser("time")
    t.add_argument("sources", nargs="*")
    t.add_argument("--pairs", type=int, default=2)
    t.add_argument("--reps", type=int, default=50)
    ph = sub.add_parser("phases")
    ph.add_argument("sources", nargs="+")
    ph.add_argument("--reps", type=int, default=50)
    a = sub.add_parser("accuracy")
    a.add_argument("sources", nargs="*")
    a.add_argument("--no-fma", action="store_true")
    a.add_argument("--seeds", type=int, default=12)
    i = sub.add_parser("improvements")
    i.add_argument("cases", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_window_gn: no CUDA device", file=sys.stderr)
        return 2
    return dict(record=record, time=time_builds, phases=phases,
                accuracy=accuracy, improvements=improvements)[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
