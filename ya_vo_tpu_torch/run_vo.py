"""CLI runner of the port: `run_vo.py`'s entry point on the CUDA card.

    python -m ya_vo_tpu_torch.run_vo --config configs/KITTI.json
        [--max-frames N] [--checkpoint out.npz] [--resume in.npz]
        [--checkpoint-every N] [--traj out_poses.txt] [--plot traj.png]
        [--refine] [--live PORT] [--synthetic] [--device cuda|cpu]

The flags, the synchronous `Frontend.process` loop and the summary line
(its keys, rounding and place as the last line of stdout) are
`run_vo.py`'s. One flag more, `--device` (default `cuda`): without a card
the run raises unless given `--device cpu`. `--synthetic` runs the
built-in synthetic KITTI-resolution sequence and reports ATE against its
ground truth; `--config` reads a KITTI odometry tree (`base_path`,
`sequence`). With `--resume` the state is restored and the stream is still
read from its first frame, as `run_vo.py` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="visual odometry on the card")
    ap.add_argument("--config", default=None, help="config JSON path")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--traj", default=None, help="KITTI-format pose output")
    ap.add_argument("--plot", default=None, help="trajectory PNG output")
    ap.add_argument("--checkpoint", default=None, help="save state npz")
    ap.add_argument("--resume", default=None, help="load state npz")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N frames (requires --checkpoint)")
    ap.add_argument("--refine", action="store_true",
                    help="offline full-map BA refinement before reporting")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the built-in synthetic sequence")
    ap.add_argument("--synthetic-frames", type=int, default=30)
    ap.add_argument("--synthetic-size", type=int, nargs=2, default=[376, 1241],
                    metavar=("H", "W"))
    ap.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve a live trajectory/map view on "
                         "http://127.0.0.1:PORT (0 = pick a free port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the CUDA card)")
    return ap


def session(argv=None, observers=()):
    """Run the CLI; returns (frontend, summary dict). `observers` are
    attached to the frontend before its first frame; the frontend is
    handed back for inspection (counters, the live viewer)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_vo runs on the card by "
                           "default; pass --device cpu to run on the CPU")

    from ya_vo_tpu_torch.config import TrackConfig, VOConfig
    from ya_vo_tpu_torch.tracking.frontend import Frontend
    from ya_vo_tpu_torch.utils import checkpoint as ckpt
    from ya_vo_tpu_torch.viz import evaluation, render

    gt_cw = None
    if args.synthetic:
        from ya_vo_tpu_torch.utils import synthetic

        H, W = args.synthetic_size
        imgs, poses_gt, lms, cam = synthetic.render_sequence(
            n_frames=args.synthetic_frames,
            n_landmarks=max(200, (H * W) // 400),
            height=H, width=W, step=0.4, yaw_rate=0.002, seed=11)
        gt_cw = np.linalg.inv(poses_gt)
        cfg = VOConfig(
            image_height=H, image_width=W,
            tracking=TrackConfig(min_ba_inliers=20, min_flow_inliers=5))
        frames = imgs
    else:
        if not args.config:
            ap.error("--config required unless --synthetic")
        cfg = VOConfig.from_json(args.config)
        from ya_vo_tpu_torch.io import kitti

        calib_path = (f"{kitti.sequence_dir(cfg.base_path, cfg.sequence)}"
                      f"/calib.txt")
        left, _ = kitti.load_calib(calib_path)
        cam = left.camera()
        frames = iter(kitti.ImageStream(cfg.base_path, cfg.sequence))
        gt_cw = kitti.load_gt_poses(cfg.base_path, cfg.sequence)

    fe = Frontend(cfg, cam, device=args.device)
    fe.observers.extend(observers)
    if args.live is not None:
        from ya_vo_tpu_torch.viz import live

        viewer = live.attach(fe, port=args.live)
        print(f"[run_vo] live view: http://127.0.0.1:{viewer.port}/",
              file=sys.stderr)
    if args.resume:
        ckpt.load_frontend(fe, args.resume)
        print(f"[run_vo] resumed at frame {fe.frame_id}", file=sys.stderr)

    t0 = time.perf_counter()
    n_done = 0
    for img in frames:
        if args.max_frames and n_done >= args.max_frames:
            break
        r = fe.process(np.asarray(img))
        n_done += 1
        if n_done % 50 == 0 or r.reset:
            el = time.perf_counter() - t0
            print(
                f"[run_vo] frame {r.frame_id} {r.status} "
                f"kp={r.n_keypoints} flow={r.n_flow_inliers} "
                f"ba={r.n_ba_inliers} map={fe.map.stats()['n_alive']} "
                f"({n_done/el:.1f} fps)",
                file=sys.stderr,
            )
        if (args.checkpoint and args.checkpoint_every
                and n_done % args.checkpoint_every == 0):
            ckpt.save_frontend(fe, args.checkpoint)

    dt = time.perf_counter() - t0
    traj = np.stack(fe.trajectory)
    if args.refine:
        from ya_vo_tpu_torch.ba.global_refine import global_refine

        traj = global_refine(fe)

    summary = {
        "frames": int(len(traj)),
        "fps": round(len(traj) / dt, 2),
        "resets": int(fe.n_resets),
        "ba_runs": int(fe.n_ba_runs),
        **fe.map.stats(),
    }
    if gt_cw is not None:
        # both alignments: Sim(3) hides global scale error, SE(3) shows it
        summary["ate_sim3_m"] = round(
            evaluation.ate_rmse(traj, gt_cw, with_scale=True), 4)
        summary["ate_se3_m"] = round(
            evaluation.ate_rmse(traj, gt_cw, with_scale=False), 4)
        rpe_t, rpe_r = evaluation.rpe(traj, gt_cw)
        summary["rpe_trans_m"] = round(rpe_t, 4)
        summary["rpe_rot_deg"] = round(rpe_r, 4)
        drift = evaluation.scale_drift(traj, gt_cw)
        summary["scale_drift_rms_log"] = round(drift["rms_log"], 4)
        seg_t, seg_r, n_seg = evaluation.kitti_segment_errors(traj, gt_cw)
        if n_seg:
            summary["kitti_t_err_pct"] = round(seg_t, 3)
            summary["kitti_r_err_deg_per_m"] = round(seg_r, 5)

    if args.traj:
        from ya_vo_tpu_torch.io.kitti import save_trajectory_kitti

        save_trajectory_kitti(args.traj, np.linalg.inv(traj))
    if args.plot:
        pos, _ = fe.map.alive_landmarks()
        render.plot_trajectory(traj, gt_cw, pos, out_path=args.plot)
    if args.checkpoint:
        ckpt.save_frontend(fe, args.checkpoint)
    return fe, summary


def main(argv=None) -> int:
    _, summary = session(argv)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
