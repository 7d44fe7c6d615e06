#!/usr/bin/env python3
"""The window BA's kernel (K5) against float64 solves, on one CUDA card.

    python3 port_window_gn.py accuracy [--no-fma] [--seeds 12] [SRC.cu ...]
    python3 port_window_gn.py improvements [CASE ...]

Run from the root of a checkout.

accuracy: for this checkout's K5 and each variant (SRC.cu, a window_gn.cu
built alone with the build's flags and loaded in place of the kernel
library; --no-fma adds this checkout's source with its fmaf calls written
as a multiply and an add, each rounded on its own), every recorded window
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
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.ba import window
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.parallel import scaling_bench
from ya_vo_tpu_torch.utils import synthetic

LIVE = dict(huber_delta=2.4477, damping=1e-4, n_fixed_poses=2,
            pose_prior_weight=100.0)
SOURCE = _build.CSRC / "window_gn.cu"
# after the includes: every fmaf a multiply and an add, each rounded
NO_FMA = "#define fmaf(a, b, c) ((a) * (b) + (c))\n"


def variant_library(src: Path, out: Path):
    """window_gn.cu at `src` built alone into `out` and loaded."""
    lib = out / (src.stem + ".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {proc.stderr}")
    return _build.load_library(lib)


def no_fma_source(out: Path) -> Path:
    s = SOURCE.read_text()
    anchor = "namespace cg = cooperative_groups;\n"
    path = out / "window_gn_no_fma.cu"
    path.write_text(s.replace(anchor, anchor + NO_FMA, 1))
    return path


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
    if not torch.cuda.is_available():
        print("port_window_gn: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("accuracy")
    a.add_argument("sources", nargs="*")
    a.add_argument("--no-fma", action="store_true")
    a.add_argument("--seeds", type=int, default=12)
    i = sub.add_parser("improvements")
    i.add_argument("cases", nargs="*")
    args = ap.parse_args()
    return accuracy(args) if args.cmd == "accuracy" else improvements(args)


if __name__ == "__main__":
    sys.exit(main())
