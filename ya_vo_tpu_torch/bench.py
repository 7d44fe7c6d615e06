"""Benchmark of the port: full-pipeline VO frames/s at KITTI resolution on
one CUDA card, production gates, the textured street world rendered on the
card.

    python -m ya_vo_tpu_torch.bench        # BENCH_REPS=3 by default

Port of `bench.py`'s primary. Prints ONE JSON line with `bench.py`'s keys
(`metric`, `value`, `unit`, `vs_baseline`, the reps, `render_ms_per_frame`,
`ate_raw_m`, resets and BA discards by rep, `ate_refined_m`, `selfcheck`,
`device_step_ms`, `fps_device`, `n_steps`), plus `redone_reps` and
`ba_runs_reps` (the redo of in-flight frames sets this path's frames/s),
`card` (`nvidia-smi`'s name and power limit) and `device`.

The primary run, as `bench.py:248-300`: `TexturedSequence(n_frames=410,
seed=5)` at 376x1241 (atlas 2048, 64 quads, 5 mips), `VOConfig()`
unmodified; per rep a fresh frontend takes WARM=8 frames through
`process` and `precompile()`, then the timed
`fe.run((seq.frame(f) for f in range(8, 410)), pipelined=True)` renders
inside the window and ends in a synchronize. The headline is the median of
the reps' frames/s, min and max beside it. Also: the render's ms a frame
over 12 frames, the fused step's issue rate after rep 0
(`device_throughput_probe`; its graph replays and kernel launches a step
are logged), `global_refine` for `ate_refined_m`, and the
kernel selfcheck (`python -m ya_vo_tpu_torch.selfcheck`) in a subprocess
with a timeout and one retry; its lines go to stderr.

Guard: `value` is 0 unless `ate_raw_m < 0.5` and the selfcheck says
"pass". `vs_baseline` divides by the C++ reference's frames/s measured on a
CPU (`native/refbench/BASELINE_MEASURED.json`, not a TPU figure).

The stamps secondary, as `bench.py:181-222`: the 40-frame stamps world
(`synthetic.STAMPS`: 1,200 landmarks, corridor, seed 11) at 376x1241 with
2048 keypoints, softened gates (`min_ba_inliers=20`, `min_flow_inliers=5`)
and asynchronous window BA; 6 frames through `process`, `precompile()`,
then the timed `fe.run` of the other 34, which ends by draining the
backend. It reports `stamps_fps` and `stamps_ate_m`.

Numbers are rounded as `bench.py` rounds them: frames/s to 2 places,
ATE to 4, render ms to 1, `value` and `vs_baseline` to 3.
`run_bench` takes the sizes as arguments, so a CPU test can call it small.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ya_vo_tpu_torch import create_frontend
from ya_vo_tpu_torch.ba.global_refine import global_refine
from ya_vo_tpu_torch.config import (FeatureConfig, TrackConfig, VOConfig,
                                     with_option)
from ya_vo_tpu_torch.selfcheck import card_line
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.utils.scene import TexturedSequence
from ya_vo_tpu_torch.viz import evaluation

REPO = Path(__file__).resolve().parent.parent
N_FRAMES, WARM, REPS = 410, 8, 3
STAMPS_WARM = 6
# the throughput probe's keys in the JSON line (`bench.py`'s); its graph replays
# and kernel launches a step go to the log
PROBE_KEYS = ("device_step_ms", "fps_device", "n_steps")
_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def ref_fps() -> float:
    """The C++ reference's measured frames/s (BASELINE.md's method)."""
    path = REPO / "native" / "refbench" / "BASELINE_MEASURED.json"
    return float(json.loads(path.read_text())["ref_style_fps"])


def run_selfcheck(timeout_s: float = 300.0) -> str:
    """`python -m ya_vo_tpu_torch.selfcheck` in a subprocess with a hard
    timeout and one retry at 1.5x. Returns "pass", "fail", "timeout" or
    "error:<type>"; only "pass" scores. The check's lines go to stderr."""
    cmd = [sys.executable, "-m", "ya_vo_tpu_torch.selfcheck"]

    def one(timeout):
        proc = None
        try:
            proc = subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr,
                                    cwd=REPO)
            return "pass" if proc.wait(timeout=timeout) == 0 else "fail"
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            return "timeout"
        except OSError as e:
            if proc is not None:
                proc.kill()
                proc.wait()
            return f"error:{type(e).__name__}"

    status = one(timeout_s)
    if status not in ("pass", "fail"):
        _log(f"selfcheck {status}: retrying once with a longer timeout")
        status = one(timeout_s * 1.5)
    return status


def score(fps: float, ate_raw: float, selfcheck: str) -> tuple:
    """(value, vs_baseline): the median frames/s where the raw ATE_sim3
    is below 0.5 and the selfcheck passed, else 0."""
    value = fps if ate_raw < 0.5 and selfcheck == "pass" else 0.0
    return value, value / ref_fps()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stamps_secondary(device: torch.device, n_frames: int, height: int,
                     width: int) -> dict:
    """The stamps secondary (module docstring): frames/s of the timed
    frames and ATE_sim3 over all of them."""
    imgs, poses_gt, _, cam = synthetic.render_sequence(
        **dict(synthetic.STAMPS, n_frames=n_frames, height=height,
               width=width))
    cfg = VOConfig(image_height=height, image_width=width,
                   features=FeatureConfig(max_keypoints=2048),
                   tracking=TrackConfig(min_ba_inliers=20,
                                        min_flow_inliers=5))
    cfg = with_option(cfg, "ba", asynchronous=True)
    fe = create_frontend(cfg, cam, device=device)
    for img in imgs[:STAMPS_WARM]:
        fe.process(img)
    fe.precompile()
    _sync(device)
    t0 = time.perf_counter()
    fe.run(imgs[STAMPS_WARM:])
    _sync(device)
    dt = time.perf_counter() - t0
    ate = evaluation.ate_rmse(np.stack(fe.trajectory),
                              np.linalg.inv(poses_gt), with_scale=True)
    _log(f"stamps secondary: {(n_frames - STAMPS_WARM) / dt} frames/s, "
         f"ate_sim3={ate}, ba_runs={fe.n_ba_runs}, ba_discarded="
         f"{fe.n_ba_discarded}, ba_deferred={fe.n_ba_deferred}")
    return {"stamps_fps": round((n_frames - STAMPS_WARM) / dt, 2),
            "stamps_ate_m": round(float(ate), 4)}


def primary_rep(seq, device, n_frames: int = N_FRAMES,
                step_graphs: bool = True):
    """One rep of the primary on `seq`: a fresh frontend at `VOConfig()`
    through WARM frames and `precompile()`, then the timed pipelined run
    of frames WARM..n_frames - 1, rendered inside the window. Returns (the
    frontend, frames/s). `step_graphs=False`: the eager step."""
    cfg = VOConfig()   # UNMODIFIED production defaults: reference gates
    fe = create_frontend(cfg, seq.cam, device=device,
                         step_graphs=step_graphs)
    for f in range(WARM):
        fe.process(seq.frame(f))
    fe.precompile()
    _sync(device)
    t0 = time.perf_counter()
    fe.run((seq.frame(f) for f in range(WARM, n_frames)), pipelined=True)
    _sync(device)
    return fe, (n_frames - WARM) / (time.perf_counter() - t0)


def run_bench(n_frames: int = N_FRAMES, reps: int = REPS, height: int = 376,
              width: int = 1241, cam=None, device="cuda",
              tex_size: int = 2048, probe_steps: int = 200,
              stamps_frames: int = 40, selfcheck=run_selfcheck,
              step_graphs: bool = True) -> dict:
    """The primary run and its extras; returns the JSON line's dict.
    `cam` defaults to the KITTI camera; the stamps secondary renders
    `stamps_frames` frames at the same size; `selfcheck` is called with no
    arguments after the runs and returns the selfcheck's status;
    `step_graphs=False` runs the primary's reps with the eager step."""
    device = torch.device(device)
    seq = TexturedSequence(n_frames=n_frames, height=height, width=width,
                           seed=5, cam=cam, tex_size=tex_size, device=device)
    gt_cw = np.linalg.inv(seq.poses[:n_frames])

    # steady-state render time: 12 frames, one synchronize
    seq.frame(0)
    _sync(device)
    t0 = time.perf_counter()
    rend = [seq.frame(f) for f in range(1, 13)]
    _sync(device)
    render_ms = (time.perf_counter() - t0) / 12 * 1e3

    fps, ate, resets, discards, redone, ba_runs = ([] for _ in range(6))
    probe = {}
    for rep in range(reps):
        _log(f"rep {rep}: warm-up and precompile")
        fe, rate = primary_rep(seq, device, n_frames, step_graphs)
        fps.append(rate)
        ate.append(float(evaluation.ate_rmse(np.stack(fe.trajectory), gt_cw,
                                             with_scale=True)))
        resets.append(fe.n_resets)
        discards.append(fe.n_ba_discarded)
        redone.append(fe.n_redone)
        ba_runs.append(fe.n_ba_runs)
        _log(f"rep {rep}: {fps[-1]} frames/s incl render "
             f"({n_frames - WARM} frames), ate_sim3={ate[-1]}, resets="
             f"{resets[-1]}, ba_runs={ba_runs[-1]}, ba_discarded="
             f"{discards[-1]}, redone={redone[-1]}")
        if rep == 0:
            probe = fe.device_throughput_probe(rend[:4], n_steps=probe_steps)
            _log(f"throughput probe: {probe}")

    fps_med = float(np.median(fps))
    ate_raw = float(np.median(ate))
    out = {
        "metric": "vo_pipeline_fps_kitti_res_production",
        "value": 0.0,              # filled after the guards
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "reps": reps,
        "fps_reps": [round(x, 2) for x in fps],
        "fps_min": round(min(fps), 2),
        "fps_max": round(max(fps), 2),
        "timed_frames": n_frames - WARM,
        "render_ms_per_frame": round(render_ms, 1),
        "ate_raw_m": round(ate_raw, 4),
        "ate_reps": [round(x, 4) for x in ate],
        "resets": int(max(resets)),
        "resets_reps": resets,
        "ba_discarded_reps": discards,
        "redone_reps": redone,
        "ba_runs_reps": ba_runs,
        "production_gates": True,
        **{k: round(v, 2) if isinstance(v, float) else v
           for k, v in probe.items() if k in PROBE_KEYS},
    }
    _log("offline refine")
    traj = global_refine(fe)
    out["ate_refined_m"] = round(float(evaluation.ate_rmse(
        traj, gt_cw, with_scale=True)), 4)
    del fe, seq, rend
    _log("stamps secondary")
    out.update(stamps_secondary(device, stamps_frames, height, width))
    if device.type == "cuda":   # free the card for the selfcheck's process
        torch.cuda.empty_cache()
    _log("selfcheck")
    out["selfcheck"] = selfcheck()
    out["value"], out["vs_baseline"] = (
        round(x, 3) for x in score(fps_med, ate_raw, out["selfcheck"]))
    out["card"] = (card_line() if device.type == "cuda"
                   else f"none ({device.type})")
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    reps = max(1, int(os.environ.get("BENCH_REPS", REPS)))
    print(json.dumps(run_bench(reps=reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
