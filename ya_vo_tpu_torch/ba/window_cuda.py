"""The window BA's Gauss-Newton loop on the card: K5, `csrc/window_gn.cu`.

The JAX package runs `_solve_window`'s iterations as a `lax.while_loop`
inside one jitted program, which leaves the loop on the device. K5 is that
loop as one cooperative launch: every GN iteration (the observations'
terms landmark by landmark, the Schur-reduced camera system, its dense
LU solve, back-substitution, the per-landmark and global acceptance) and
the early exit, with the start's and the end's costs, in one kernel that
ends on the device. `ba/window.py`'s `solve_window` calls `solve` for a
CUDA problem; a CPU problem takes `solve_window_plain` there, and `solve`
raises on a CPU tensor.

Every sum is taken in a fixed order (no float atomics), so two calls on
the same problem give the same bits. The scratch (the partial sums, each
landmark's blocks) is one workspace allocated here a call.
"""

from __future__ import annotations

import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.core.camera import Camera

# the widest window K5 takes (its shared memory holds the 6W x 6W system)
MAX_WINDOW = 16


def workspace_bytes(W: int, L: int) -> int:
    """The bytes of K5's scratch for W keyframes and L landmarks (builds
    the kernels)."""
    return int(_build.library().yavo_window_gn_workspace(W, L))


def solve(prob, cam: Camera, layout, *, iters: int, huber_delta: float,
          damping: float, n_fixed_poses: int, rel_tol: float,
          pose_prior_weight: float):
    """One K5 launch on the current stream for the window problem `prob`
    (a `window.BAProblem` of CUDA tensors) with its CSR `layout`
    (`window.csr`): (poses [W, 4, 4], landmarks [L, 3], cost_initial [],
    cost_final [], n_obs [] int64, n_iters [] int32), all on the device.
    No host read."""
    W, O = prob.obs_lm.shape
    L = prob.landmarks.shape[0]
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"window_gn: W = {W} keyframes, K5 takes 1 to "
                         f"{MAX_WINDOW}")
    if iters < 0:
        raise ValueError(f"window_gn: iters {iters} < 0")
    shapes = (("poses", torch.float32, (W, 4, 4)),
              ("pose_valid", torch.bool, (W,)),
              ("landmarks", torch.float32, (L, 3)),
              ("lm_valid", torch.bool, (L,)),
              ("obs_uv", torch.float32, (W, O, 2)),
              ("obs_lm", torch.int64, (W, O)),
              ("obs_valid", torch.bool, (W, O)))
    # K5 reads the problem in its row-major layout
    prob = type(prob)(*(t.contiguous() for t in prob))
    for name, dtype, shape in shapes:
        _build.check_cuda(f"window_gn {name}", getattr(prob, name), dtype,
                          shape)
    _build.check_cuda("window_gn order", layout.order, torch.int64,
                      (W * O,))
    _build.check_cuda("window_gn offsets", layout.offsets, torch.int64,
                      (L + 1,))
    dev = prob.poses.device
    for t in (*prob, *layout):
        if t.device != dev:
            raise ValueError(f"window_gn: inputs on {t.device} and {dev}")
    poses = torch.empty((W, 4, 4), dtype=torch.float32, device=dev)
    landmarks = torch.empty((L, 3), dtype=torch.float32, device=dev)
    cost0 = torch.empty((), dtype=torch.float32, device=dev)
    cost1 = torch.empty((), dtype=torch.float32, device=dev)
    n_obs = torch.empty((), dtype=torch.int64, device=dev)
    n_iters = torch.empty((), dtype=torch.int32, device=dev)
    work = torch.empty(workspace_bytes(W, L), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.launch("window_gn", *(t.data_ptr() for t in prob[:4]),
                      prob.obs_uv.data_ptr(), prob.obs_valid.data_ptr(),
                      layout.order.data_ptr(), layout.offsets.data_ptr(),
                      W, O, L, iters, n_fixed_poses, cam.fx, cam.fy,
                      cam.cx, cam.cy, huber_delta, damping, rel_tol,
                      pose_prior_weight, poses.data_ptr(),
                      landmarks.data_ptr(), cost0.data_ptr(),
                      cost1.data_ptr(), n_obs.data_ptr(),
                      n_iters.data_ptr(), work.data_ptr())
    return poses, landmarks, cost0, cost1, n_obs, n_iters
