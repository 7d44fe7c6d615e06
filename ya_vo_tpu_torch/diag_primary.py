"""Diagnose the bench's primary workload on one CUDA card: run the bench's
primary loop once with per-frame telemetry, and print where the inlier
margin thins, where resets and BA discards happen, and the keyframe and BA
cadence around them.

    python -m ya_vo_tpu_torch.diag_primary [--frames N] [--seed S]
        [--out PATH] [--window W] [--every-n N] [--stale N] [--prior P]
        [--refine-sweep] [--apply-mode push|device] [--maxdepth R]
        [--kf-trans T] [--sync] [--device cpu]

Port of `tools/diag_primary.py`, with its flags, observer rows, printed
summary, refine sweep and outputs: `TexturedSequence(n_frames, seed)`
rendered on the card, `VOConfig()` with the flags' overrides, 8 frames
through `process`, `precompile()`, then `run(pipelined=True)` over the
rest (the kernels' launch counts are this run's alone: set to 0 after
`precompile()` and read after the run's `finish`). An observer records
each frame's row (`f, st, kp, flow, ba, new, kf, reset`, and the BA
applies and discards so far, `nba, ndisc`). Prints the resets, solves,
discards, keyframes, ATE_sim3 and frames/s; scale drift and RPE over 10
frames; the BA inliers' minimum, 5th percentile and median; the frames
under 150 BA inliers; each reset's context; the deciles of the
Sim(3)-aligned per-frame error; and the local Sim(3) scale of each
60-frame window. `--refine-sweep` then runs the offline refine
(`ba.global_refine`) at six (passes, prior, iters) settings from the same
map. Writes the record (rows, ate, scale_drift, rpe10_t, resets,
discards) as JSON to `--out` (default build/diag_primary.json in the
repository) and the trajectory with its ground truth to `<out>.npz`.
`torch.cuda.synchronize()` ends the timed run where the tool has
`jax.effects_barrier()`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from ya_vo_tpu_torch import _build, require_device
from ya_vo_tpu_torch.config import VOConfig, with_option
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz import evaluation

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_REPO, "build", "diag_primary.json")
WARM = 8
# the refine sweep's (passes, offline pose prior, iters)
SWEEP = ((2, 100.0, None), (2, 10.0, None), (2, 0.0, None), (4, 10.0, None),
         (2, 10.0, 24), (4, 0.0, 24))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=410)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--window", type=int, default=0,
                    help="override map.window_size")
    ap.add_argument("--every-n", type=int, default=0,
                    help="override ba.every_n_keyframes")
    ap.add_argument("--stale", type=int, default=0,
                    help="override ba.max_stale_keyframes")
    ap.add_argument("--prior", type=float, default=-1,
                    help="override ba.pose_prior_weight")
    ap.add_argument("--refine-sweep", action="store_true",
                    help="after the run, try offline-refine variants")
    ap.add_argument("--apply-mode", default="",
                    help="override ba.apply_mode (push|device)")
    ap.add_argument("--maxdepth", type=float, default=0,
                    help="override tracking.max_depth_baseline_ratio")
    ap.add_argument("--kf-trans", type=float, default=0,
                    help="override tracking.keyframe_max_translation")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous BA: deterministic ATE for config A/Bs "
                         "(asynchronous applies land at timing-dependent "
                         "frames)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small worlds only)")
    return ap.parse_args(argv)


def make_config(a: argparse.Namespace) -> VOConfig:
    """VOConfig() with the flags' overrides."""
    cfg = VOConfig()
    if a.window:
        cfg = with_option(cfg, "map", window_size=a.window)
    if a.every_n:
        cfg = with_option(cfg, "ba", every_n_keyframes=a.every_n)
    if a.stale:
        cfg = with_option(cfg, "ba", max_stale_keyframes=a.stale)
    if a.prior >= 0:
        cfg = with_option(cfg, "ba", pose_prior_weight=a.prior)
    if a.apply_mode:
        cfg = with_option(cfg, "ba", apply_mode=a.apply_mode)
    if a.sync:
        cfg = with_option(cfg, "ba", asynchronous=False)
    if a.maxdepth:
        cfg = with_option(cfg, "tracking", max_depth_baseline_ratio=a.maxdepth)
    if a.kf_trans:
        cfg = with_option(cfg, "tracking", keyframe_max_translation=a.kf_trans)
    return cfg


def observe(fe: Frontend, rows: list) -> None:
    """Append each frame's row to `rows` as the frontend emits it."""
    def obs(res):
        rows.append(dict(
            f=res.frame_id, st=res.status, kp=res.n_keypoints,
            flow=res.n_flow_inliers, ba=res.n_ba_inliers,
            new=res.n_new_landmarks, kf=bool(res.is_keyframe),
            reset=bool(res.reset),
            # BA apply/discard counters at resolve time: correlates applies
            # with inlier-count jumps in the per-frame trace
            nba=fe.n_ba_runs, ndisc=fe.n_ba_discarded))

    fe.observers.append(obs)


def refine_sweep(fe: Frontend, gt_cw, ate: float) -> None:
    """The offline refine at each of SWEEP's settings, each from the run's
    map (restored after each)."""
    from ya_vo_tpu_torch.ba.global_refine import global_refine

    n = fe.map.n_keyframes
    kf_snap = fe.map.kf_pose[:n].copy()
    lm_snap = fe.map.landmark_pos.copy()
    for passes, prior, iters in SWEEP:
        fe.map.kf_pose[:n] = kf_snap
        fe.map.landmark_pos[:] = lm_snap
        c0 = fe.cfg
        fe.cfg = with_option(c0, "ba", offline_pose_prior_weight=prior)
        try:
            traj_r = global_refine(fe, passes=passes, iters=iters)
        finally:
            fe.cfg = c0
        ate_r = float(evaluation.ate_rmse(traj_r, gt_cw, with_scale=True))
        print(f"refine passes={passes} prior={prior:5.1f} "
              f"iters={iters}: ATE {ate:.4f} -> {ate_r:.4f}")
    fe.map.kf_pose[:n] = kf_snap
    fe.map.landmark_pos[:] = lm_snap


def main(argv=None, **world):
    """Run the diagnosis with the flags `argv`; `world` goes to
    `TexturedSequence` (a smaller world: height, width, cam, tex_size...).
    Prints the summary and returns (the record, the frontend, the kernels'
    launches over the pipelined run)."""
    a = parse(argv)
    require_device(a.device)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    N = a.frames
    seq = TexturedSequence(n_frames=N, seed=a.seed, device=a.device,
                           **world)
    cfg = make_config(a)
    fe = Frontend(cfg, seq.cam, device=a.device)
    rows = []
    observe(fe, rows)

    for f in range(WARM):
        fe.process(seq.frame(f))
    fe.precompile()
    fe._sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    fe.run((seq.frame(f) for f in range(WARM, N)), pipelined=True)
    fe._sync()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    gt_cw = np.linalg.inv(seq.poses[:N])
    est = np.stack(fe.trajectory)
    ate = float(evaluation.ate_rmse(est, gt_cw, with_scale=True))
    # per-frame sim3-aligned position error trace (where does drift grow?)
    err = evaluation.ate_trace(est, gt_cw)
    sd = evaluation.scale_drift(est, gt_cw)
    rpe_t, rpe_r = evaluation.rpe(est, gt_cw, delta=10)

    print(f"\n=== {fe.n_resets} resets, {fe.n_ba_runs} BA applies, "
          f"{fe.n_ba_discarded} BA discards, "
          f"{sum(r['kf'] for r in rows)} keyframes / {len(rows)} frames, "
          f"ATE_sim3={ate:.4f}, {((N - WARM) / dt):.2f} fps")
    print(f"scale_drift rms_log={sd['rms_log']:.4f}, rpe10 trans="
          f"{rpe_t:.4f} rot={rpe_r:.4f} deg "
          f"(cfg: W={cfg.map.window_size}, every_n="
          f"{cfg.ba.every_n_keyframes}, stale={cfg.ba.max_stale_keyframes},"
          f" prior={cfg.ba.pose_prior_weight})")

    ba = np.array([r["ba"] for r in rows if not r["reset"]])
    track = [r for r in rows if r["st"] == "TRACKING"]
    print(f"n_ba inliers over tracking frames: min={ba[ba > 0].min()} "
          f"p5={np.percentile(ba[ba > 0], 5):.0f} "
          f"median={np.median(ba[ba > 0]):.0f}")
    thin = [r for r in track if 0 < r["ba"] < 150]
    print(f"{len(thin)} frames with n_ba < 150 (gate 100):")
    for r in thin[:20]:
        print("  ", r)
    for i, r in enumerate(rows):
        if r["reset"]:
            lo, hi = max(0, i - 6), min(len(rows), i + 4)
            print(f"--- reset at frame {r['f']} (context {lo}..{hi}):")
            for rr in rows[lo:hi]:
                print("  ", rr)
    # drift growth: error at each decile of the route
    q = [round(float(np.percentile(err, p)), 3)
         for p in (10, 25, 50, 75, 90, 100)]
    print(f"sim3-aligned per-frame error deciles (10/25/50/75/90/max): {q}")
    # LOCAL scale along the route: windowed Sim(3) factors. A monotone
    # slope here (not the rms wander scale_drift reports) is systematic
    # monocular scale decay
    locs = [evaluation.sim3_scale(est[s:s + 60], gt_cw[s:s + 60])
            for s in range(0, len(est) - 60, 60)]
    slope_pct = (locs[-1] / locs[0] - 1) * 100 if len(locs) > 1 else 0.0
    print(f"local sim3 scale by 60-frame window: "
          f"{[round(s, 4) for s in locs]}  (end/start: {slope_pct:+.2f}%)")

    if a.refine_sweep:
        refine_sweep(fe, gt_cw, ate)

    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out + ".npz", est=est, gt_cw=gt_cw)
    record = dict(rows=rows, ate=ate, scale_drift=sd["rms_log"],
                  rpe10_t=rpe_t, resets=fe.n_resets,
                  discards=fe.n_ba_discarded)
    with open(a.out, "w") as f:
        json.dump(record, f)
    print(f"wrote {a.out} (+.npz trajectory)")
    return record, fe, launches


if __name__ == "__main__":
    main()
