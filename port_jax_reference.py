#!/usr/bin/env python3
"""The JAX package's frontend on `chip_smoke.py`'s workload, on the CPU: the
like-for-like reference for the port's main-path numbers.

    JAX_PLATFORMS=cpu python3 port_jax_reference.py [--runs RUN,...]

Runs `ya_vo_tpu.tracking.frontend.Frontend.run(pipelined=True)`, RUN being
one of (the first four by default):
  ba_off   - the 40-frame 376x1241 stamps world (`chip_smoke.SEQ`) at
             VOConfig() with only window BA off (chip_smoke.py phase 4);
  ba_on    - the same frames at VOConfig() unmodified (phase 5);
  blackout - VOConfig() unmodified, two black frames after frame 20
             (phase 6);
  textured - VOConfig() unmodified over the first `chip_smoke.TEXTURED_N`
             frames of bench.py's textured world
             (`TexturedSequence(n_frames=410, seed=5)`), rendered by the
             JAX package with its own sensor noise (phase 8; the card
             renders its own noise, so the two compare in size only);
  refine   - the offline refine on a whole session of that world:
             VOConfig() over its first `--refine-frames` frames (410, the
             bench's) at tests/test_torch_textured.py's size (188x620, the
             camera halved, 1024 keypoints, synchronous BA; atlas
             `--refine-tex`), then the JAX package's `global_refine` and
             the port's (on the CPU, from the same map carried over by
             `utils/convert`); ATE_sim3 raw and refined by each, and the
             two refined trajectories' largest difference. Each window
             solve of the JAX refine is also solved by the port's
             `solve_window` in float32 and in float64 on the same problem:
             the three windows whose port and JAX poses differ most, each
             with both solves' distance to the float64 one.
  textured_device - `textured` with `ba.apply_mode="device"`
             (chip_smoke.py phase 11 (a));
  options  - the same 40 frames at VOConfig() unmodified but for one
             option each (chip_smoke.py phase 11 (b)): `anchor`,
             `tracking.lk_template="anchor"`, and `photometric_norm`,
             `features.photometric_norm=True`; one line each;
  dist     - the stamps world at VOConfig() with the landmark-sharded
             backend (chip_smoke.py phase 12 (d) and (e)): a process of its
             own that sees `chip_smoke.DIST_SHARDS` virtual CPU devices
             (XLA_FLAGS), where `ba.distributed="auto"` shards every window
             solve; one line synchronous (`dist_sync`), one with
             `ba.asynchronous=True` (`dist_async`), which tracks with the
             JAX package's own CPU LK: the host callback of the TPU
             kernel's semantics holds an XLA CPU thread while the backend
             thread's solve waits at its all-reduce for every virtual
             device, and XLA aborts the process after 40 s of that wait;
  pose_caps - JAX's `_solve_pose` (jitted as `solve_pose` jits it, its
             while-loop's final count read through a host callback; the
             JAX package untouched) and the port's `solve_pose_plain` on
             the CPU, on every solve of `--solves FILE`
             (`port_pose_gn.py collect --all-out FILE` on the card, with
             K4's iterations): how many solves each runs to the cap, how
             often each pair of the three counts agrees, and the solves
             where one caps and another exits;
  cli      - the JAX CLI, `run_vo.main`, on chip_smoke.py phase 9's
             arguments: `--synthetic` at its defaults (30 frames,
             376x1241), then a KITTI tree (`chip_smoke.write_kitti_tree`)
             of the first `chip_smoke.CLI_N` frames of the textured world
             rendered by the JAX package, under configs/KITTI.json with
             only `base_path` and `sequence` replaced
             (`chip_smoke.kitti_config`: asynchronous window BA), with
             `--checkpoint-every chip_smoke.CLI_CKPT_EVERY`. Prints each
             run's summary line with the frontend's discards and
             relocalizations.
On the CPU the JAX frontend would track with `lk.track`; the TPU and the
port run `lk_pallas` semantics, which differ from it near the image edge
(ROADMAP.md Queue 3). So, as in tests/test_torch_frontend.py, LK is swapped
for the TPU kernel's semantics through a host callback into the port's
plain LK; every other stage of the JAX frontend runs unchanged. The JAX
process sees one CPU device, so `ba.distributed="auto"` is the
single-device solver, as on one card.

Prints one JSON line a run (refine: its own keys): ATE_sim3 (over the
non-black frames for blackout), resets, relocalizations, keyframes, BA
solves and discards, the statuses (and whether the backend was sharded,
with how many devices, for dist), and the blackout's scale ratio (median
step-length ratio after over before, the property of
tests/test_relocalization.py).
Imports JAX: it runs where the JAX package runs, never on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from chip_smoke import (blackout_scale_ratio, kitti_config, non_black,
                        with_blackout, write_kitti_tree)
from ya_vo_tpu.config import VOConfig
from ya_vo_tpu.core import camera as jcam
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking import pose_solver as jps
from ya_vo_tpu.tracking.frontend import Frontend
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu.utils.scene import TexturedSequence
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch import selfcheck
from ya_vo_tpu_torch.config import with_option
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver


def tpu_semantics_lk(img0, img1, uv0, uv_init, mask, **kw):
    """`lk.auto_track` with the TPU kernel's semantics: a host callback
    into the port's plain LK."""
    def host(*arrays):
        out = lk_cuda.track(*(torch.as_tensor(np.array(a)) for a in arrays),
                            **kw)
        return tuple(x.numpy() for x in out)

    n = uv0.shape[0]
    shapes = (jax.ShapeDtypeStruct((n, 2), jnp.float32),
              jax.ShapeDtypeStruct((n,), jnp.bool_),
              jax.ShapeDtypeStruct((n,), jnp.float32))
    return jlk.FlowResult(*jax.pure_callback(host, shapes, img0, img1, uv0,
                                             uv_init, mask))


def jax_pose_counter(cam, iters=40, huber_delta=2.4477, chi2_threshold=5.991,
                     damping=1e-6):
    """JAX's `pose_solver._solve_pose` jitted as `solve_pose` jits it, with
    its while-loop's final counter (its state's `it`) sent to the host by a
    callback around `jax.lax.while_loop` while it is traced. Returns
    solve(T_init, pts, uv, mask) -> (PoseSolveResult, iterations), on
    torch or numpy inputs."""
    counts = []
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        jax.debug.callback(lambda n: counts.append(int(n)), out[1])
        return out

    fn = jax.jit(functools.partial(
        jps._solve_pose, cam=jcam.Camera.create(*cam), iters=iters,
        huber_delta=huber_delta, chi2_threshold=chi2_threshold,
        damping=damping))

    def solve(*arrays):
        jax.lax.while_loop = while_loop
        try:
            with jax.default_matmul_precision("float32"):
                res = jax.block_until_ready(fn(*(jnp.asarray(np.asarray(a))
                                                 for a in arrays)))
        finally:
            jax.lax.while_loop = orig
        jax.effects_barrier()
        return res, counts[-1]

    return solve


def pose_caps(path: str) -> dict:
    """The `pose_caps` run: JAX's while-loop and the port's plain version
    on the CPU against K4's recorded iterations, solve by solve."""
    counters, rows = {}, []
    with np.load(path) as z:
        for i in range(int(z["n"])):
            *inputs, cam, gn = selfcheck.load_pose_inputs(
                z, device="cpu", prefix=f"{i}:")
            key = (cam, json.dumps(gn, sort_keys=True))
            if key not in counters:
                counters[key] = jax_pose_counter(cam, **gn)
            n_jax = counters[key](*inputs)[1]
            n_plain = int(pose_solver.solve_pose_plain(
                *inputs, cam, with_iters=True, **gn)[1])
            rows.append(dict(kernel=int(z[f"{i}:iterations"]), jax=n_jax,
                             plain_cpu=n_plain, cap=gn["iters"]))
    names = ("kernel", "jax", "plain_cpu")
    capped = {n: [i for i, r in enumerate(rows) if r[n] == r["cap"]]
              for n in names}
    out = dict(solves=len(rows), capped={n: len(v) for n, v in
                                         capped.items()})
    for a, b in (("kernel", "jax"), ("plain_cpu", "jax"),
                 ("kernel", "plain_cpu")):
        out[f"equal_{a}_{b}"] = sum(r[a] == r[b] for r in rows)
        out[f"{a}_caps_{b}_exits"] = sorted(set(capped[a]) - set(capped[b]))
        out[f"{b}_caps_{a}_exits"] = sorted(set(capped[b]) - set(capped[a]))
    out["median"] = {n: float(np.median([r[n] for r in rows]))
                     for n in names}
    return out


# VOConfig() with one option set: the `options` runs and textured_device
OPTIONS = dict(chip_smoke.OPTIONS,
               textured_device=("ba", {"apply_mode": "device"}))


def run(name: str, frames, poses_gt, cam) -> dict:
    cfg = VOConfig()
    if name == "ba_off":
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba,
                                                              enabled=False))
    if name in OPTIONS:
        section, fields = OPTIONS[name]
        cfg = with_option(cfg, section, **fields)
    if name == "dist_async":
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, asynchronous=True))
    seq = with_blackout(frames) if name == "blackout" else list(frames)
    fe = Frontend(cfg, cam)
    t0 = time.perf_counter()
    traj = fe.run(seq, pipelined=True)
    out = dict(run=name, seconds=time.perf_counter() - t0,
               resets=fe.n_resets, relocalizations=fe.n_relocalizations,
               keyframes=sum(r.is_keyframe for r in fe.results),
               ba_solves=fe.n_ba_runs, ba_discarded=fe.n_ba_discarded,
               statuses=[r.status for r in fe.results])
    if name.startswith("dist"):
        out["sharded_backend"] = fe._dist_ba is not None
        out["devices"] = len(jax.devices())
    gt_cw = np.linalg.inv(poses_gt)
    if name == "blackout":
        keep = non_black(len(frames))
        out["ate_sim3"] = evaluation.ate_rmse(traj[keep], gt_cw,
                                              with_scale=True)
        out["scale_ratio"] = blackout_scale_ratio(traj, poses_gt)
    else:
        out["ate_sim3"] = evaluation.ate_rmse(traj, gt_cw, with_scale=True)
    return out


def textured():
    """Phase 8's frames, rendered by the JAX package: (frames, poses, cam)."""
    seq = TexturedSequence(**chip_smoke.TEXTURED)
    n = chip_smoke.TEXTURED_N
    return ([np.array(seq.frame(f)) for f in range(n)], seq.poses[:n],
            seq.cam)


def refine(n_frames: int, tex_size: int) -> dict:
    """The `refine` run (module docstring)."""
    from tests.test_torch_textured import H, SCALE, W, make_config
    from ya_vo_tpu.ba import window as jwindow
    from ya_vo_tpu.ba.global_refine import global_refine as jglobal_refine
    from ya_vo_tpu.core.camera import Camera
    from ya_vo_tpu_torch.ba import window as pwindow
    from ya_vo_tpu_torch.ba.global_refine import global_refine
    from ya_vo_tpu_torch.tracking.frontend import Frontend as PortFrontend
    from ya_vo_tpu_torch.utils import convert

    cam = Camera.create(718.856 * SCALE, 718.856 * SCALE, 607.1928 * SCALE,
                        185.2157 * SCALE)
    pcam = convert.camera_from_numpy(cam)
    seq = TexturedSequence(**dict(chip_smoke.TEXTURED, height=H, width=W,
                                  cam=cam, tex_size=tex_size))
    fe = Frontend(make_config(), cam)
    t0 = time.perf_counter()
    traj = fe.run([np.array(seq.frame(f)) for f in range(n_frames)],
                  pipelined=True)
    seconds = time.perf_counter() - t0
    before = convert.map_arrays(fe.map)
    jax_solve, windows = jwindow.solve_window, []

    def lockstep(prob, cam_, **kw):
        res = jax_solve(prob, cam_, **kw)
        p32 = pwindow.BAProblem(*(torch.as_tensor(np.array(x)) for x in prob))
        p32 = p32._replace(obs_lm=p32.obs_lm.long())
        p64 = pwindow.BAProblem(*(x.double() if x.is_floating_point() else x
                                  for x in p32))
        n = int(p32.pose_valid.sum())
        j = np.asarray(res.poses)[:n]
        t32 = pwindow.solve_window(p32, pcam, **kw).poses[:n].numpy()
        t64 = pwindow.solve_window(p64, pcam, **kw).poses[:n].numpy()
        windows.append(dict(window=len(windows),
                            port_vs_jax=float(np.abs(t32 - j).max()),
                            jax_vs_f64=float(np.abs(j - t64).max()),
                            port_vs_f64=float(np.abs(t32 - t64).max())))
        return res

    jwindow.solve_window = lockstep
    try:
        refined = jglobal_refine(fe)
    finally:
        jwindow.solve_window = jax_solve
    port = PortFrontend(make_config(), pcam, device="cpu")
    port.map = convert.mapstore_from_numpy(before)
    port.trajectory = list(traj)
    port_refined = global_refine(port)
    gt_cw = np.linalg.inv(seq.poses[:n_frames])

    def ate(t):
        return evaluation.ate_rmse(t, gt_cw, with_scale=True)

    worst = sorted(windows, key=lambda w: -w["port_vs_jax"])[:3]
    return dict(run="refine", frames=n_frames, size=[H, W], tex=tex_size,
                seconds=seconds, resets=fe.n_resets,
                relocalizations=fe.n_relocalizations,
                ba_solves=fe.n_ba_runs, ba_discarded=fe.n_ba_discarded,
                keyframes=int(before["n_keyframes"]),
                window_barrier=int(before["window_barrier"]),
                archive=len(before["archive_stamps"]),
                ate_sim3=ate(traj), ate_refined_jax=ate(refined),
                ate_refined_port=ate(port_refined),
                refined_max_diff=float(np.abs(port_refined - refined).max()),
                windows=len(windows), worst_windows=worst)


def cli():
    """The `cli` runs (module docstring): one dict a run."""
    import run_vo
    from ya_vo_tpu.tracking import frontend as jfrontend

    made = []

    class Recorded(jfrontend.Frontend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def main(name, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_vo.main(argv)
        fe = made[-1]
        fe.finish()
        return dict(run=name, rc=rc, seconds=time.perf_counter() - t0,
                    summary=json.loads(buf.getvalue().splitlines()[-1]),
                    ba_discarded=fe.n_ba_discarded,
                    relocalizations=fe.n_relocalizations,
                    asynchronous=fe.cfg.ba.asynchronous)

    orig = jfrontend.Frontend
    jfrontend.Frontend = Recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            yield main("cli_synthetic", ["--synthetic", "--traj",
                                         os.path.join(tmp, "a.txt")])
            seq = TexturedSequence(**chip_smoke.TEXTURED)
            n = chip_smoke.CLI_N
            base = os.path.join(tmp, "kitti")
            write_kitti_tree(base, (np.array(seq.frame(f)) for f in range(n)),
                             seq.cam, seq.poses[:n])
            cfg = kitti_config(base, os.path.join(tmp, "kitti.json"))
            yield main("cli_kitti", [
                "--config", cfg, "--traj", os.path.join(tmp, "b.txt"),
                "--checkpoint", os.path.join(tmp, "b.npz"),
                "--checkpoint-every", str(chip_smoke.CLI_CKPT_EVERY)])
    finally:
        jfrontend.Frontend = orig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="ba_off,ba_on,blackout,textured")
    ap.add_argument("--refine-frames", type=int,
                    default=chip_smoke.TEXTURED["n_frames"])
    ap.add_argument("--refine-tex", type=int, default=1024)
    ap.add_argument("--solves", default=None,
                    help="pose_caps: the bundle of `port_pose_gn.py "
                    "collect --all-out`")
    args = ap.parse_args()
    stamps = None
    jax_lk = jlk.auto_track
    jlk.auto_track = tpu_semantics_lk
    names = args.runs.split(",")
    if "options" in names:
        i = names.index("options")
        names[i:i + 1] = list(chip_smoke.OPTIONS)
    for name in names:
        if name == "dist":
            # its own process: this one keeps one device
            env = dict(os.environ, XLA_FLAGS=(
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_"
                f"platform_device_count={chip_smoke.DIST_SHARDS}").strip())
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--runs", "dist_sync,dist_async"], env=env,
                           check=True)
            continue
        if name == "dist_async":
            jlk.auto_track = jax_lk
        if name == "cli":
            for out in cli():
                print(json.dumps(out), flush=True)
            continue
        if name == "refine":
            print(json.dumps(refine(args.refine_frames, args.refine_tex)),
                  flush=True)
            continue
        if name == "pose_caps":
            print(json.dumps(pose_caps(args.solves)), flush=True)
            continue
        if stamps is None and not name.startswith("textured"):
            stamps = synthetic.render_sequence(**chip_smoke.SEQ)
        frames, poses_gt, *_, cam = textured() if name.startswith(
            "textured") else stamps
        print(json.dumps(run(name, frames, poses_gt, cam)), flush=True)


if __name__ == "__main__":
    main()
