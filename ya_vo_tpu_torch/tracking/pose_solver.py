"""Pose-only bundle adjustment: robust Gauss-Newton on SE(3).

Port of `ya_vo_tpu/tracking/pose_solver.py`: analytic 2x6 Jacobians, Huber
weights times a soft chi2 gate, Levenberg damping, left-multiplicative
updates, and an early exit once a step's norm is <= 1e-5. The JAX package
runs the loop as a `lax.while_loop` on the device; here that loop is the
CUDA kernel `csrc/pose_gn.cu` (K4): one launch a solve, which ends on the
device at the early exit. A CPU tensor takes `solve_pose_plain`, which
keeps the early exit as an `active` flag that freezes the pose (the same
iterates as the while-loop, all `iters` iterations issued); a CUDA tensor
launches the kernel or raises. The kernel runs on one thread-block cluster
of 8 blocks that share their partial sums through distributed shared
memory; each block solves the 6x6 system itself, so all of them take the
same step and leave the loop together. Its sums follow the fixed order of
a one-block schedule (the kernel's header), which fixes its bits. It takes
any number of points, in rounds of 2048 (VOConfig()'s track table): the
first round's points stay in registers, later rounds' are read from device
memory each iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera


class PoseSolveResult(NamedTuple):
    pose: torch.Tensor          # [4, 4] optimized world->camera pose
    inlier_mask: torch.Tensor   # [N] bool chi2 inliers at the solution
    n_inliers: torch.Tensor     # [] int64
    final_cost: torch.Tensor    # [] f32 robust mean cost over valid obs


def _residuals_and_jacobian(T, pts_w, uv, cam: Camera):
    """r [N, 2], J [N, 2, 6] (left-multiplicative tangent), depth Z [N]."""
    pc = lie.transform_points(T, pts_w)
    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.where(Z < 1e-3, 1e-3, Z)
    inv_z2 = inv_z * inv_z
    u = cam.fx * X * inv_z + cam.cx
    v = cam.fy * Y * inv_z + cam.cy
    r = torch.stack([u, v], dim=-1) - uv
    zeros = torch.zeros_like(X)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zeros, -cam.fx * X * inv_z2], dim=-1),
        torch.stack([zeros, cam.fy * inv_z, -cam.fy * Y * inv_z2], dim=-1),
    ], dim=-2)                                                  # [N, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    J_point = torch.cat([eye, -lie.hat(pc)], dim=-1)           # [N, 3, 6]
    return r, J_proj @ J_point, Z


def gn_step(T, pts_w, uv, mask, cam: Camera, *, huber_delta: float = 2.4477,
            chi2_threshold: float = 5.991, damping: float = 1e-6):
    """The plain version's step at T: dx [6] of the robust normal
    equations, zeroed unless finite with norm < 1."""
    r, J, Z = _residuals_and_jacobian(T, pts_w, uv, cam)
    chi2 = (r * r).sum(-1)
    valid = mask & (Z > 1e-3)
    w_huber = torch.clamp(
        huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
    w_gate = torch.where(chi2 > chi2_threshold, 1e-3, 1.0)
    w = w_huber * w_gate * valid.to(r.dtype)
    JW = J * w[:, None, None]
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    H = torch.einsum("nik,nil->kl", J, JW) + damping * eye6
    b = -torch.einsum("nik,ni->k", JW, r)
    dx = torch.linalg.solve_ex(H, b)[0]
    ok = torch.isfinite(dx).all() & (torch.linalg.norm(dx) < 1.0)
    return torch.where(ok, dx, torch.zeros_like(dx))


def solve_pose_plain(T_init, pts_w, uv, mask, cam: Camera, *,
                     iters: int = 40, huber_delta: float = 2.4477,
                     chi2_threshold: float = 5.991, damping: float = 1e-6,
                     with_iters: bool = False):
    """Robust pose-only GN from T_init [4, 4] over landmarks pts_w [N, 3]
    observed at uv [N, 2], valid where mask [N]: the plain version of K4.
    With `with_iters`, also returns the iterations the while-loop would run
    ([] int64: those begun while the pose was not yet frozen)."""
    T = T_init
    active = torch.ones((), dtype=torch.bool, device=T_init.device)
    n_iters = torch.zeros((), dtype=torch.int64, device=T_init.device)
    for _ in range(iters):
        if with_iters:
            n_iters = n_iters + active
        dx = gn_step(T, pts_w, uv, mask, cam, huber_delta=huber_delta,
                     chi2_threshold=chi2_threshold, damping=damping)
        T = torch.where(active, lie.se3_exp(dx) @ T, T)
        active = active & (torch.linalg.norm(dx) > 1e-5)

    r, _, Z = _residuals_and_jacobian(T, pts_w, uv, cam)
    chi2 = (r * r).sum(-1)
    valid = mask & (Z > 1e-3)
    inliers = valid & (chi2 <= chi2_threshold)
    nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
    huber_cost = torch.where(nrm <= huber_delta, 0.5 * chi2,
                             huber_delta * (nrm - 0.5 * huber_delta))
    final_cost = torch.where(valid, huber_cost, 0.0).sum() \
        / torch.clamp(valid.sum(), min=1)
    out = PoseSolveResult(pose=T, inlier_mask=inliers,
                          n_inliers=inliers.sum(), final_cost=final_cost)
    return (out, n_iters) if with_iters else out


def cluster_size() -> int:
    """The blocks of K4's thread-block cluster (builds the kernels)."""
    return _build.library().yavo_pose_gn_cluster_size()


def _strides(name: str, t: torch.Tensor, dtype: torch.dtype, shape):
    """`t`'s element strides, after `_build.check_cuda`'s tests but for
    contiguity: the kernel reads views through their strides."""
    _build.check_cuda(name, t, dtype, shape, contiguous=False)
    return t.stride()


def solve_pose(T_init, pts_w, uv, mask, cam: Camera, *, iters: int = 40,
               huber_delta: float = 2.4477, chi2_threshold: float = 5.991,
               damping: float = 1e-6, with_iters: bool = False):
    """Robust pose-only GN from T_init [4, 4] over landmarks pts_w [N, 3]
    observed at uv [N, 2], valid where mask [N]. On CUDA tensors, one
    launch of K4 on the current stream, with no host read; with
    `with_iters`, also returns the iterations it ran ([] int32 on the
    device; the plain version's count on the CPU)."""
    kw = dict(iters=iters, huber_delta=huber_delta,
              chi2_threshold=chi2_threshold, damping=damping)
    if T_init.device.type == "cpu":
        return solve_pose_plain(T_init, pts_w, uv, mask, cam,
                                with_iters=with_iters, **kw)
    N = pts_w.shape[0]
    if iters < 0:
        raise ValueError(f"solve_pose: iters {iters} < 0")
    ts = _strides("pose_gn T_init", T_init, torch.float32, (4, 4))
    ps = _strides("pose_gn pts_w", pts_w, torch.float32, (N, 3))
    us = _strides("pose_gn uv", uv, torch.float32, (N, 2))
    ms = _strides("pose_gn mask", mask, torch.bool, (N,))
    dev = T_init.device
    for t in (pts_w, uv, mask):
        if t.device != dev:
            raise ValueError(f"solve_pose: inputs on {t.device} and {dev}")
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(N, dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    n_iters = torch.empty((), dtype=torch.int32, device=dev)
    _build.launch("pose_gn", T_init.data_ptr(), *ts, pts_w.data_ptr(), *ps,
                  uv.data_ptr(), *us, mask.data_ptr(), *ms, N, iters,
                  cam.fx, cam.fy, cam.cx, cam.cy, huber_delta,
                  chi2_threshold, damping, pose.data_ptr(),
                  inliers.data_ptr(), n_inliers.data_ptr(), cost.data_ptr(),
                  n_iters.data_ptr())
    out = PoseSolveResult(pose=pose, inlier_mask=inliers,
                          n_inliers=n_inliers, final_cost=cost)
    return (out, n_iters) if with_iters else out
