"""Full-length sequence run of the port on one CUDA card: a KITTI-00-scale
route (4,000 frames by default) through the map's lifecycle (landmark
retirement and recycling, keyframe eviction at `max_keyframes`), with
accuracy and lifecycle reporting.

    python -m ya_vo_tpu_torch.longrun [--frames N] [--seed S] [--out PATH]
                                      [--no-photo] [--stdout-only]
                                      [--device DEV]

Port of `tools/longrun.py`: the same route (straights and turns in both
directions, cycled to length), `TexturedSequence(..., light_period=900.0,
q_max=128)` rendered on the card inside the timed window, `VOConfig()`
unmodified; 8 warm frames through `process`, `precompile()`, then the
timed `run(pipelined=True)` and `finish()`, with a heartbeat on stderr
every 200 frames. The record of a variant has the tool's keys (fps,
resets, keyframes, solves, ATE and RPE, scale drift, lifecycle counters,
host RSS, the KITTI segment errors past 100 m, and the KITTI round trip of
the trajectory through `io/kitti.py`), `backend` reading the device type,
plus PORT_KEYS: the card's `nvidia-smi` name and power limit, the fused
step's issue rate from a short `device_throughput_probe`, kernel launches
a timed frame, redone dispatches, and the first frames at which a keyframe
was evicted and a landmark retired (None when none was).

The tool's photo variant blends in the reference's KITTI render
(`PHOTO_FIXTURE`), which this repository does not hold: the CLI records
the variant as skipped, in the tool's wording (the fixture absent, or
`--no-photo`). `main(photo=...)` runs it on a caller's grayscale image.
Writes the combined record to `docs/LONGRUN_TORCH.json` unless
`--stdout-only`. Runs on the CUDA card and raises without one; `--device
cpu` runs the plain versions. `main()` and `run()` take the frame size,
camera, atlas size and map capacities as keyword arguments, so a CPU test
can run it small.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch.config import VOConfig, with_option
from ya_vo_tpu_torch.io import kitti as kitti_io
from ya_vo_tpu_torch.selfcheck import card_line
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz.evaluation import (ate_rmse, kitti_segment_errors,
                                            rpe, scale_drift)

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "docs" / "LONGRUN_TORCH.json"
# the reference checkout's KITTI render, the tool's photo texture
PHOTO_FIXTURE = "reference/tests/epilines.png"
# a route with straights and turns in both directions, cycled to length
SEGMENTS = ((0.0, 220), (0.010, 40), (0.0, 180), (-0.012, 35),
            (0.0, 260), (0.008, 55), (0.0, 150), (-0.009, 45))
WARM = 8
# the keys a variant's record adds to tools/longrun.py's
PORT_KEYS = ("card", "device_step_ms", "launches_per_frame",
             "redone_dispatches", "first_eviction_frame",
             "first_retirement_frame")


def main(n_frames: int = 4000, seed: int = 11, photo=None,
         device="cuda", **kw) -> dict:
    """One variant's run (`run`); prints its record and returns it."""
    out, _, _ = run(n_frames, seed, photo, device, **kw)
    print(json.dumps(out), flush=True)
    return out


def run(n_frames: int = 4000, seed: int = 11, photo=None, device="cuda",
        height: int = 376, width: int = 1241, cam=None, tex_size: int = 2048,
        max_keyframes=None, max_landmarks=None, probe_steps: int = 20,
        world_frames=None):
    """One variant's run: (its record, the frontend, the kernel launches
    of the timed window, `run` and `finish`; the counts are set to 0 just
    before it). At least 13 frames:
    the render is timed over frames 1-12. `world_frames` (default
    `n_frames`) is the route's length: the street world is built along the
    whole route, so the first `n_frames` of a longer route are the frames
    a longer run starts with."""
    device = torch.device(device)
    world_frames = n_frames if world_frames is None else world_frames
    # q_max=128, not the default 64: over a 4,000-frame world the
    # 64-nearest-quad cull pops geometry in and out through the turns
    seq = TexturedSequence(n_frames=world_frames, seed=seed,
                           segments=SEGMENTS,
                           light_period=900.0, photo=photo, q_max=128,
                           height=height, width=width, cam=cam,
                           tex_size=tex_size, device=device)
    caps = {k: v for k, v in (("max_keyframes", max_keyframes),
                              ("max_landmarks", max_landmarks))
            if v is not None}
    cfg = with_option(VOConfig(), "map", **caps)
    fe = create_frontend(cfg, seq.cam, device=device)

    t_start = time.perf_counter()
    first = {"evicted": None, "retired": None}

    def _observe(res):
        # the lifecycle's first firings, and a heartbeat that flushes: a
        # long run with no output looks like a hang
        m = fe.map
        if first["evicted"] is None and m.n_evicted_keyframes:
            first["evicted"] = res.frame_id
        if first["retired"] is None and m.n_retired:
            first["retired"] = res.frame_id
        if res.frame_id % 200 == 0 and res.frame_id:
            el = time.perf_counter() - t_start
            print(f"[longrun] frame {res.frame_id}/{n_frames} "
                  f"({res.frame_id / el:.1f} fps avg, {el:.0f}s, "
                  f"resets={fe.n_resets}, kf={m.n_keyframes}, "
                  f"evicted={m.n_evicted_keyframes}, "
                  f"retired={m.n_retired})", file=sys.stderr, flush=True)

    fe.observers.append(_observe)

    # the render's cost alone: 12 frames, one synchronize
    seq.frame(0)
    fe._sync()
    t0 = time.perf_counter()
    rend = [seq.frame(f) for f in range(1, 13)]
    fe._sync()
    render_ms = (time.perf_counter() - t0) / 12 * 1e3

    for f in range(WARM):
        fe.process(seq.frame(f))
    fe.precompile()
    fe._sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    fe.run((seq.frame(f) for f in range(WARM, n_frames)), pipelined=True)
    fe.finish()
    fe._sync()
    wall = time.perf_counter() - t0
    timed = n_frames - WARM
    launches = dict(_build.LAUNCHES)
    est = np.stack(fe.trajectory)
    probe = fe.device_throughput_probe(rend[:4], n_steps=probe_steps)

    gt_cw = np.linalg.inv(seq.poses[:n_frames])
    stats = fe.map.stats()
    rpe_t, rpe_r = rpe(est, gt_cw, delta=10)
    out = {
        "n_frames": n_frames,
        "texture": "photo" if photo is not None else "procedural",
        "backend": device.type,
        "fps_incl_render": round(timed / wall, 2),
        "render_ms_per_frame": round(render_ms, 2),
        "resets": fe.n_resets,
        "keyframes": int(sum(r.is_keyframe for r in fe.results)),
        "ba_runs": fe.n_ba_runs,
        "ate_sim3_m": round(float(ate_rmse(est, gt_cw, with_scale=True)), 4),
        "ate_se3_m": round(float(ate_rmse(est, gt_cw, with_scale=False)), 4),
        "rpe10_trans_m": round(rpe_t, 4),
        "rpe10_rot_deg": round(rpe_r, 4),
        "scale_drift_rms_log": round(scale_drift(est, gt_cw)["rms_log"], 4),
        "relocalizations": fe.n_relocalizations,
        "ba_discarded": fe.n_ba_discarded,
        "ba_capacity_lm_dropped": fe.n_ba_lm_dropped,
        "evicted_keyframes": stats["n_evicted_keyframes"],
        "recycled_slots": stats["n_recycled"],
        "retired_slots": stats["n_retired"],
        "dropped_landmarks": stats["n_dropped_landmarks"],
        "landmark_hwm": stats["n_landmarks"],
        "rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
    }
    seg_t, seg_r, n_seg = kitti_segment_errors(est, gt_cw)
    if n_seg:
        out["kitti_t_err_pct"] = round(seg_t, 3)
        out["kitti_r_err_deg_per_m"] = round(seg_r, 5)
        out["kitti_n_segments"] = n_seg

    # the KITTI round trip: the trajectory written as a poses file
    # (camera->world rows) through io/kitti.py, loaded back and scored again
    fd, traj_path = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    try:
        kitti_io.save_trajectory_kitti(traj_path, np.linalg.inv(est))
        reloaded = np.linalg.inv(kitti_io.load_poses(traj_path))
    finally:
        os.unlink(traj_path)
    out["kitti_roundtrip_ate_sim3_m"] = round(
        float(ate_rmse(reloaded, gt_cw, with_scale=True)), 4)
    out["kitti_roundtrip_frames"] = int(len(reloaded))

    out.update(
        card=card_line() if device.type == "cuda" else f"none ({device.type})",
        device_step_ms=probe["device_step_ms"],
        launches_per_frame={k: v / timed for k, v in launches.items()},
        redone_dispatches=fe.n_redone,
        first_eviction_frame=first["evicted"],
        first_retirement_frame=first["retired"])
    return out, fe, launches


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="record path (default docs/LONGRUN_TORCH.json)")
    ap.add_argument("--no-photo", action="store_true",
                    help="skip the photo-textured variant")
    ap.add_argument("--stdout-only", action="store_true",
                    help="do not write the record file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)

    record = {
        "generated_by": "ya_vo_tpu_torch/longrun.py",
        "date": time.strftime("%Y-%m-%d"),
        "frames_per_variant": a.frames,
        "seed": a.seed,
        "variants": {},
    }
    record["variants"]["procedural"] = main(a.frames, a.seed,
                                            device=a.device)
    record["variants"]["photo"] = {
        "skipped": "--no-photo" if a.no_photo
        else f"reference fixture absent ({PHOTO_FIXTURE})"}

    if not a.stdout_only:
        with open(a.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"[longrun] wrote {a.out}", file=sys.stderr)
    return record


if __name__ == "__main__":
    cli()
