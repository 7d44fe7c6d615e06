"""Distributed-BA scaling harness.

Port of `ya_vo_tpu/parallel/scaling_bench.py`: wall-clock per GN iteration
of the distributed window BA (parallel/dist_ba.py) across mesh shapes,
with the speedup and efficiency against the first row and each row's
per-device collective payload (dist_ba.collective_bytes_per_iter).

Rows have the JAX harness's keys but `projected_ici_ms`, which divides the
payload by a TPU link rate; no NVLink rate has been measured for the port,
so it projects none. Instead each row says whether its shards ride
distinct devices (`distinct_devices`): the shards of a mesh may share a
device, and a row whose shards share one card measures the cost of
sharding, not scaling.

Usage (on the card):
    python -m ya_vo_tpu_torch.parallel.scaling_bench [L] [W]
With one card visible, each mesh's shards share it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ya_vo_tpu_torch.ba.window import BAProblem
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.parallel import dist_ba, mesh as mesh_lib
from ya_vo_tpu_torch.utils import synthetic


def build_problem(L: int, W: int, seed: int = 0, device="cpu"):
    """(camera, DistBAProblem): L random landmarks, perturbed, seen from W
    forward poses at 376x1241, on `device`."""
    cam = synthetic.kitti_camera()
    lms = synthetic.random_landmarks(L, seed=seed)
    poses = synthetic.forward_trajectory(W, step=0.5)
    uv, vis = synthetic.project_tracks(lms, poses, cam, 376, 1241, margin=5)
    rng = np.random.default_rng(seed + 1)
    lms_pert = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return cam, dist_ba.DistBAProblem(
        poses=t(poses), landmarks=t(lms_pert),
        lm_valid=torch.ones(L, dtype=torch.bool, device=device),
        obs_uv=t(np.transpose(uv, (1, 0, 2)).astype(np.float32)),
        obs_valid=t(np.transpose(vis, (1, 0))))


def window_problem(L: int, W: int, seed: int = 0, device="cpu",
                   pose_pert: float = 0.02, n_fixed: int = 2) -> BAProblem:
    """`build_problem`'s window in ba/window.py's keyframe-major layout
    (L observation slots a keyframe, slot l holding landmark l where it is
    seen), each pose after the first `n_fixed` (the solve's gauge pins,
    two in the live backend) perturbed by se(3) noise of sigma
    `pose_pert`, and 0.5 px of Gaussian noise on the observations, as a
    tracker leaves them: one window for `solve_window` and the solvers
    here."""
    _, p = build_problem(L, W, seed, device)
    rng = np.random.default_rng(seed + 2)
    xi = rng.normal(0, pose_pert, (W, 6)).astype(np.float32)
    xi[:n_fixed] = 0.0
    noise = rng.normal(0, 0.5, tuple(p.obs_uv.shape)).astype(np.float32)
    poses = lie.se3_exp(torch.as_tensor(xi).to(device)) @ p.poses
    ids = torch.arange(L, device=device).expand(W, L)
    return BAProblem(poses=poses,
                     pose_valid=torch.ones(W, dtype=torch.bool,
                                           device=device),
                     landmarks=p.landmarks, lm_valid=p.lm_valid,
                     obs_uv=(p.obs_uv + torch.as_tensor(noise).to(device)
                             ).transpose(0, 1).contiguous(),
                     obs_lm=torch.where(p.obs_valid.T, ids, -1),
                     obs_valid=p.obs_valid.T.contiguous())


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure(L: int = 16384, W: int = 8, iters: int = 4,
            device_counts: Optional[Sequence[int]] = None,
            mesh_shapes: Optional[Sequence[Tuple[int, int]]] = None,
            repeats: int = 3, devices=None) -> List[Dict]:
    """Rows for 1-D landmark meshes (`device_counts`, n_kf=1) and/or 2-D
    kf x lm meshes (`mesh_shapes` as (n_kf, n_lm) pairs), each over the
    first of `devices` (default: the visible CUDA devices; a device may
    repeat)."""
    devices = [torch.device(d) for d in (
        devices if devices is not None
        else mesh_lib.landmark_mesh().devices)]
    if not devices:
        raise RuntimeError("no CUDA device: the harness times the card; "
                           "pass `devices` to run elsewhere")
    n_dev = len(devices)
    if device_counts is None and mesh_shapes is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    shapes: List[Tuple[int, int]] = [(1, d) for d in (device_counts or [])]
    shapes += list(mesh_shapes or [])

    cam, prob = build_problem(L, W, device=devices[0])
    rows = []
    base = None
    for n_kf, n_lm in shapes:
        if n_kf * n_lm > n_dev or W % n_kf or L % n_lm:
            continue
        n = n_kf * n_lm
        devs = devices[:n]
        if n_kf == 1:
            solve = dist_ba.make_dist_solver(
                mesh_lib.Mesh(devs, ("lm",)), cam, iters=iters)
        else:
            grid = np.asarray(devs, dtype=object).reshape(n_kf, n_lm)
            solve = dist_ba.make_dist_solver_2d(
                mesh_lib.Mesh(grid, ("kf", "lm")), cam, iters=iters)
        solve(prob)
        _sync(devs)                                  # warm
        t0 = time.perf_counter()
        for _ in range(repeats):
            solve(prob)
        _sync(devs)
        dt = (time.perf_counter() - t0) / repeats / iters
        if base is None:
            base = dt
        coll = dist_ba.collective_bytes_per_iter(W, L, n_kf, n_lm)
        rows.append({
            "mesh": f"{n_kf}x{n_lm}",
            "devices": n,
            "distinct_devices": len(set(devs)) == n,
            "ms_per_gn_iter": round(dt * 1e3, 3),
            "speedup": round(base / dt, 3),
            "efficiency": round(base / dt / n, 3),
            "collective_mb_per_iter": round(coll["ring_bytes"] / 2**20, 3),
        })
    return rows


if __name__ == "__main__":
    import json
    import sys

    from ya_vo_tpu_torch.selfcheck import card_line

    L = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    devs = list(mesh_lib.landmark_mesh().devices)
    if not devs:
        sys.exit("scaling_bench: no CUDA device")
    if len(devs) == 1:
        devs = devs * 8              # one card: the shards share it
    print(card_line(), flush=True)
    two_d = [(2, 4), (4, 2), (2, 2), (8, 1)]
    for row in measure(L, W, mesh_shapes=two_d, devices=devs):
        print(json.dumps(row))
