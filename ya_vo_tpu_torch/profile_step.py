"""Time the fused tracking step and each of its components on one CUDA card.

    python -m ya_vo_tpu_torch.profile_step [--reps N] [--device cpu]

Port of `tools/profile_step.py`. The tool's stamps world (12 frames at
376x1241, seed 11, a corridor) at the tool's config (`max_keypoints=2048`,
`min_ba_inliers=20`, `min_flow_inliers=5`, asynchronous BA): after 8
processed frames, frame 8 is timed through the fused step
(`Frontend._extract` + `Frontend._step_body`, the counterpart of JAX's
jitted `_track_step`) on a snapshot of the frontend's device state, then
through its components, each called with the arguments the fused step gives
it (`frontend.detect_kwargs`, `frontend.lk_inputs`) on the step's own
intermediate values, in the tool's order: `fast.detect` (K2 and
`fast_select`), the gaussian blur, `brief.describe`, LK masked and seeded by
projection (K1), pose GN, match including describe (K3), triangulation
(`triangulate_fast`, the step's), the reprojection errors of the fresh
points in both views, the two stable argsorts of the keyframe merge and the
2048x2048 proximity test. The components run on clones of the snapshot, so
each of the repeats reads the same state. After the eager fused step comes
its replay (`graph_step`): the frontend's fresh step graph (the JAX tool's
jitted step, as the frontend runs it on the card) on the same snapshot, its
18 arguments copied into the graph's buffers each call, the keypoints and
descriptors copied out.

Each row: call ms (the host clock over `--reps` calls ended by
`torch.cuda.synchronize()`, after one warm call), device ms (the union of
the profiler's device events over `--reps` calls, as `profile_slice.busy_us`
computes it, a call; a session without device events is repeated, 3 in
all, then "not measured"), `cudaLaunchKernel` and `cudaGraphLaunch` a call,
the device's kernels a call (the profiler's kernel events, each once,
those a graph launched included), and the hand-written kernels' launches a
call (`_build.LAUNCHES`, which a replay counts). JAX's `block_until_ready`
time holds both the host and the device; in eager PyTorch the call's time
and the device's differ by the host's issue of the launches.

The JAX tool repeats its rows under `default_matmul_precision('float32')`,
since a TPU's matmuls default to bf16 passes. The port runs true float32
everywhere with TF32 off (`Frontend.__init__`), so it prints one section.
With `--device cpu` (small shapes only: the tests' use) only call ms is
measured.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.config import (BAConfig, FeatureConfig, TrackConfig,
                                    VOConfig)
from ya_vo_tpu_torch.features import brief, fast, matching
from ya_vo_tpu_torch.geometry.triangulation import (reprojection_errors,
                                                    triangulate_fast)
from ya_vo_tpu_torch.parallel.scaling_bench import sync_devices
from ya_vo_tpu_torch.profile_slice import busy_us, device_kernels
from ya_vo_tpu_torch.selfcheck import PROFILE_TRIES, bits_equal
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver
from ya_vo_tpu_torch.tracking.frontend import (
    RECORD_KEYS, Frontend, camera_center, depth_gate, detect_kwargs,
    gn_kwargs, lk_inputs, lk_kwargs, merge_order, near_tracks)
from ya_vo_tpu_torch.utils import synthetic

WORLD = dict(n_frames=12, n_landmarks=1200, height=376, width=1241,
             step=0.5, yaw_rate=0.002, seed=11, corridor=True)
WARM = 8
REPS = 20
GRAPH_ROW = "fused step (graph replay)"


def config(height: int, width: int, max_keypoints: int = 2048) -> VOConfig:
    """The tool's config at this frame size."""
    return VOConfig(image_height=height, image_width=width,
                    features=FeatureConfig(max_keypoints=max_keypoints),
                    tracking=TrackConfig(min_ba_inliers=20,
                                         min_flow_inliers=5),
                    ba=BAConfig(asynchronous=True))


class StepState(NamedTuple):
    """The frame and the fused step's state arguments (`_step_body`'s
    after kp and desc), cloned from the frontend."""

    img: torch.Tensor
    args: tuple


def setup(device="cuda", world=None, max_keypoints: int = 2048,
          warm: int = WARM):
    """`prepare` on the tool's world at its config."""
    world = dict(WORLD, **(world or {}))
    fe = Frontend(config(world["height"], world["width"], max_keypoints),
                  synthetic.kitti_camera(), device=device)
    imgs, *_ = synthetic.render_sequence(**world)   # the same camera
    return prepare(fe, imgs.__getitem__, warm)


def prepare(fe: Frontend, frame, warm: int = WARM):
    """(`fe` after frames `frame(0)` .. `frame(warm - 1)` through
    `process`, frame `warm` on the device); the frontend numbers it as
    `_pipe_step` does before its dispatch (`frame_id` is its number)."""
    for f in range(warm):
        fe.process(frame(f))
    # no solve left running on the backend, its apply pushed to the device
    fe.finish()
    if fe._state_dirty:
        fe._push_state_to_device()
    fe.frame_id += 1
    return fe, fe._ingest(frame(warm))


def snapshot(fe: Frontend, img: torch.Tensor) -> StepState:
    """The arguments the frontend's next dispatch of `img` gives the step
    (`Frontend._step_args`), the tensors cloned."""
    args = fe._step_args(img)
    return StepState(img.clone(), tuple(
        a.clone() if isinstance(a, torch.Tensor) else a for a in args))


def fused_step(fe: Frontend, st: StepState):
    """(kp, desc, state_out, record) of the fused step on `st`."""
    kp, desc = fe._extract(st.img)
    return (kp, desc) + fe._step_body(kp, desc, *st.args)


def graph_step(fe: Frontend, st: StepState):
    """(kp, desc, state_out, record) of a replay of the frontend's fresh
    step graph on `st` (a dispatch of its runner: `st`'s arguments copied
    into the graph's buffers, the keypoints and descriptors copied out).
    The replay writes the next state into those buffers, which hold the
    frontend's device chain: call it inside `fe._throwaway_chain()`."""
    g = fe._graphs
    if g is None or not g.ready:
        raise RuntimeError("the frontend's step graphs are not captured")
    return g.dispatch(st.args)


def chain(fe: Frontend, st: StepState) -> dict:
    """The fused step's intermediate values, computed as its components in
    the tool's order with the step's arguments."""
    fc, tc, mc = fe.cfg.features, fe.cfg.tracking, fe.cfg.matching
    (kf_img, img, prev_img, track_uv, anchor_uv, track_mask, lm_pos, pose,
     rel, kf_desc, kf_uv, kf_mask, kf_pose, *_) = st.args
    x = {}
    x["kp"] = kp = fast.detect(img, **detect_kwargs(fc))
    x["blurred"] = brief.gaussian_blur(img.to(torch.float32), fc.blur_ksize,
                                       fc.blur_sigma)
    x["desc"] = brief.describe(x["blurred"], kp.uv, kp.mask, fe._offsets)[0]
    x["lk_in"] = lk_inputs(tc.lk_template, fe.cam, pose, rel, lm_pos,
                           track_uv, anchor_uv, track_mask, prev_img, kf_img)
    x["flow"] = flow = lk_cuda.track(
        x["lk_in"][0], img, *x["lk_in"][1:], **lk_kwargs(tc))
    x["T_prior"] = rel @ pose
    x["solve"] = solve = pose_solver.solve_pose(
        x["T_prior"], lm_pos, flow.uv, flow.status, fe.cam, **gn_kwargs(tc))
    x["keep"] = keep = flow.status & solve.inlier_mask
    x["new_track_uv"] = torch.where(keep[:, None], flow.uv, anchor_uv)
    x["match"] = m = matching.match(kf_desc, x["desc"], kf_mask, kp.mask,
                                    abs_threshold=mc.abs_threshold,
                                    cross_check=mc.cross_check)
    x["r_uv2"] = r_uv2 = kp.uv[m.idx2]
    x["near"] = near_tracks(r_uv2, x["new_track_uv"], keep)
    x["P1"] = fe.K @ kf_pose[:3, :4]
    x["P2"] = fe.K @ solve.pose[:3, :4]
    x["r_pts"], x["r_valid"] = triangulate_fast(x["P1"], x["P2"], kf_uv,
                                                r_uv2, m.mask & ~x["near"])
    # the step's depth gate on the fresh points (a few elementwise ops,
    # not a row of the tool's)
    x["r_valid"] = depth_gate(
        tc.max_depth_baseline_ratio, x["r_valid"], x["r_pts"], solve.pose,
        camera_center(solve.pose), camera_center(kf_pose))
    x["reproj"] = (reprojection_errors(x["P1"], x["r_pts"], kf_uv),
                   reprojection_errors(x["P2"], x["r_pts"], r_uv2))
    x["dest"], x["src"] = merge_order(keep, x["r_valid"])
    return x


def compare(x: dict, kp, desc, record) -> list:
    """The fused step's outputs (`fused_step`'s kp, desc and record) that
    `chain`'s values do not reproduce exactly: keypoints, descriptors, the
    flow's status and (off a keyframe) positions, the pose, its inliers,
    the kept tracks, the fresh points, the merge order and the counts
    (bit for bit: the same ops on the same inputs)."""
    r = dict(zip(RECORD_KEYS, record))
    pairs = {
        "kp.uv": (x["kp"].uv, kp.uv), "kp.mask": (x["kp"].mask, kp.mask),
        "desc": (x["desc"], desc),
        "flow status": (x["flow"].status, r["flow_ok"]),
        "n_flow": (x["flow"].status.sum(), r["n_flow"]),
        "pose": (x["solve"].pose, r["pose"]),
        "inliers": (x["solve"].inlier_mask, r["inlier"]),
        "keep": (x["keep"], r["keep"]),
        "n_matches": (x["match"].mask.sum(), r["n_matches"]),
        "r_pts": (x["r_pts"], r["r_pts"]),
        "dest": (x["dest"], r["dest"]), "src": (x["src"], r["src"])}
    if not bool(r["is_kf"]):
        pairs["flow uv (tracks)"] = (x["new_track_uv"], r["track_uv"])
    return [k for k, (a, b) in pairs.items() if not bits_equal(a, b)]


def components(fe: Frontend, st: StepState, x: dict) -> list:
    """(name, call) of the fused step and of each component, in the tool's
    order; each component reads `x` (`chain`'s values) and clones of `st`."""
    fc, tc, mc = fe.cfg.features, fe.cfg.tracking, fe.cfg.matching
    (kf_img, img, prev_img, track_uv, anchor_uv, track_mask, lm_pos, pose,
     rel, kf_desc, kf_uv, kf_mask, kf_pose, *_) = st.args
    kp, flow = x["kp"], x["flow"]

    def describe():
        return brief.describe(x["blurred"], kp.uv, kp.mask, fe._offsets)

    return [
        ("fused step", lambda: fused_step(fe, st)),
        ("fast.detect", lambda: fast.detect(img, **detect_kwargs(fc))),
        ("gaussian_blur", lambda: brief.gaussian_blur(
            img.to(torch.float32), fc.blur_ksize, fc.blur_sigma)),
        ("brief.describe", describe),
        ("LK (masked, projection-seeded)", lambda: lk_cuda.track(
            x["lk_in"][0], img, *x["lk_in"][1:], **lk_kwargs(tc))),
        ("pose GN", lambda: pose_solver.solve_pose(
            x["T_prior"], lm_pos, flow.uv, flow.status, fe.cam,
            **gn_kwargs(tc))),
        ("match (incl describe)", lambda: matching.match(
            kf_desc, describe()[0], kf_mask, kp.mask,
            abs_threshold=mc.abs_threshold, cross_check=mc.cross_check)),
        ("triangulate", lambda: triangulate_fast(
            x["P1"], x["P2"], kf_uv, x["r_uv2"],
            x["match"].mask & ~x["near"])),
        ("reproj errors", lambda: (
            reprojection_errors(x["P1"], x["r_pts"], kf_uv),
            reprojection_errors(x["P2"], x["r_pts"], x["r_uv2"]))),
        ("2x argsort", lambda: merge_order(x["keep"], x["r_valid"])),
        ("proximity d2", lambda: near_tracks(x["r_uv2"], x["new_track_uv"],
                                             x["keep"])),
    ]


def measure(fn, device, reps: int = REPS) -> dict:
    """A row: call ms, and on the card device ms (union of the device
    events), `cudaLaunchKernel` and hand-written kernel launches a call
    (None on the CPU)."""
    device = torch.device(device)
    fn()
    sync_devices([device])
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_devices([device])
    row = dict(call_ms=(time.perf_counter() - t0) / reps * 1e3,
               device_ms=None, cuda_launch_kernel=None,
               cuda_graph_launch=None, device_kernels=None,
               kernel_launches=None)
    if device.type != "cuda":
        return row
    # a session that lost its device events (seen on an H100: a short
    # session's events of a few launches) is repeated, as
    # `selfcheck.device_ms` does; none in PROFILE_TRIES: not measured
    for _ in range(PROFILE_TRIES):
        before = sum(_build.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync_devices([device])
        evs = prof.events()
        row["cuda_launch_kernel"] = sum(e.name == "cudaLaunchKernel"
                                        for e in evs) / reps
        row["cuda_graph_launch"] = sum(e.name == "cudaGraphLaunch"
                                       for e in evs) / reps
        row["device_kernels"] = device_kernels(evs) / reps
        row["kernel_launches"] = (sum(_build.LAUNCHES.values())
                                  - before) / reps
        union = busy_us(evs)[1]
        if union > 0:
            row["device_ms"] = union / reps / 1e3
            break
        print("profile_step: a profiler session saw no device events",
              file=sys.stderr, flush=True)
    return row


def format_row(name: str, row: dict) -> str:
    if row["cuda_launch_kernel"] is None:
        return (f"{name:32s} call {row['call_ms']:9.3f} ms  device, "
                f"launches: not measured")
    device = ("not measured" if row["device_ms"] is None
              else f"{row['device_ms']:9.3f} ms")
    return (f"{name:32s} call {row['call_ms']:9.3f} ms  device {device}  "
            f"cudaLaunchKernel {row['cuda_launch_kernel']:7.1f}  "
            f"cudaGraphLaunch {row['cuda_graph_launch']:4.1f}  device "
            f"kernels {row['device_kernels']:6.1f}  hand-written "
            f"{row['kernel_launches']:4.1f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small shapes only)")
    a = ap.parse_args(argv)
    fe, img = setup(a.device)
    if fe.device.type == "cuda":
        from ya_vo_tpu_torch.selfcheck import card_line
        print(card_line())
    print(f"valid tracks: {int(fe.track_valid.sum())} of "
          f"{len(fe.track_valid)}")
    st = snapshot(fe, img)
    x = chain(fe, st)
    for name, fn in components(fe, st, x):
        print(format_row(name, measure(fn, fe.device, a.reps)), flush=True)
        if name == "fused step" and fe._graphs is not None:
            with fe._throwaway_chain():
                row = measure(lambda: graph_step(fe, st), fe.device, a.reps)
            print(format_row(GRAPH_ROW, row), flush=True)
    print("one section: the port runs true float32 with TF32 off, so JAX's "
          "rows under default_matmul_precision('float32') have no "
          "counterpart")


if __name__ == "__main__":
    main()
