"""Per-frame wall time of the pipelined driver on one CUDA card, and the
split of its host time between dispatch, finish, window solve and problem
build.

    python -m ya_vo_tpu_torch.profile_bench [--frames N] [--warm N]
                                            [--device cpu]

Port of `tools/profile_bench.py`. The tool's stamps world (40 frames at
376x1241, seed 11, a corridor) at the tool's config (`max_keypoints=2048`,
`min_ba_inliers=20`, `min_flow_inliers=5`, asynchronous BA;
`profile_step.config`): 6 warm frames through `process`, then
`_dispatch_track`, `_finish_track`, `_run_window_ba` and
`_build_window_problem` are wrapped with host timers on the instance,
where the frontend's own callers (`_pipe_step`, `_resolve_record`,
`_redo_queue`, `_poll_ba`) reach them, and so are `_pipe_step` and
`_pipe_flush`. The rest of the frames go through `Frontend.run(pipelined=
True)` itself, which uploads the next frame before each `_pipe_step`; the
flush time is its last `_pipe_flush`, the one after the loop (a bootstrap
frame's flush inside `_pipe_step` is in that frame's time). A dispatch
that reuses an extraction (`pre=`: an in-flight frame redone after a state
push) is counted as "redo", apart from the fresh ones ("dispatch").

Prints the tool's lines: the frames, total and flush ms; mean, median, p90
and max of the per-frame ms; the per-frame ms; keyframes and landmarks;
and n / mean / sum / max ms of each phase. The host clock reads what the
host waits for: a frame's time holds its issue, and the device's only
where the host reads a result back. With `--device cpu` (small shapes
only) the same runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ya_vo_tpu_torch.profile_step import config
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import synthetic

WARM = 6
# wrapped method -> its phase
PHASES = {"_dispatch_track": "dispatch", "_finish_track": "finish",
          "_run_window_ba": "ba", "_build_window_problem": "buildprob"}


def wrap_phases(fe) -> dict:
    """Wrap `PHASES`' methods of `fe` (a frontend of either package) on the
    instance with host timers; returns {phase: [ms, ...]}, "redo" holding
    the dispatches given `pre=`."""
    phase = {"dispatch": [], "redo": [], "finish": [], "ba": [],
             "buildprob": []}

    def make(orig, key):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            dt = (time.perf_counter() - t0) * 1e3
            redo = key == "dispatch" and k.get("pre") is not None
            phase["redo" if redo else key].append(dt)
            return out
        return wrap

    for name, key in PHASES.items():
        setattr(fe, name, make(getattr(fe, name), key))
    return phase


def drive(fe: Frontend, frames) -> dict:
    """`wrap_phases`, `_pipe_step` and `_pipe_flush` wrapped on the
    instance with host timers, then `fe.run(frames, pipelined=True)`:
    {"times": per-frame ms, "flush_ms", "phase"}."""
    phase = wrap_phases(fe)
    times, flushes = [], []

    def timed(orig, into):
        def wrap(*a):
            t0 = time.perf_counter()
            orig(*a)
            into.append((time.perf_counter() - t0) * 1e3)
        return wrap

    fe._pipe_step = timed(fe._pipe_step, times)
    fe._pipe_flush = timed(fe._pipe_flush, flushes)
    fe.run(frames, pipelined=True)
    return dict(times=times, flush_ms=flushes[-1], phase=phase)


def profile(fe: Frontend, imgs, warm: int = WARM) -> dict:
    """`warm` frames through `process`, then `drive` over the rest."""
    for img in imgs[:warm]:
        fe.process(img)
    return drive(fe, imgs[warm:])


def summary(fe: Frontend, result: dict) -> list:
    """The tool's printed lines."""
    t = np.array(result["times"])
    flush = result["flush_ms"]
    lines = [f"frames={len(t)} total={t.sum() + flush:.1f} ms "
             f"flush={flush:.1f} ms",
             f"mean={t.mean():.1f} median={np.median(t):.1f} "
             f"p90={np.percentile(t, 90):.1f} max={t.max():.1f}",
             f"per-frame ms: {np.round(t, 1).tolist()}",
             f"keyframes: {fe.map.n_keyframes} landmarks: "
             f"{fe.map.n_landmarks}"]
    for k, v in result["phase"].items():
        if v:
            v = np.array(v)
            lines.append(f"{k}: n={len(v)} mean={v.mean():.1f} "
                         f"sum={v.sum():.0f} max={v.max():.1f}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int,
                    default=synthetic.STAMPS["n_frames"])
    ap.add_argument("--warm", type=int, default=WARM)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small shapes only)")
    a = ap.parse_args(argv)
    fe = Frontend(config(synthetic.STAMPS["height"],
                         synthetic.STAMPS["width"]),
                  synthetic.kitti_camera(), device=a.device)
    imgs, *_ = synthetic.render_sequence(     # the same camera
        **dict(synthetic.STAMPS, n_frames=a.frames))
    if fe.device.type == "cuda":
        from ya_vo_tpu_torch.selfcheck import card_line
        print(card_line())
    for line in summary(fe, profile(fe, imgs, a.warm)):
        print(line)


if __name__ == "__main__":
    main()
