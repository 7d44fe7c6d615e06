"""Distributed sliding-window BA: landmark shards x a summed reduced camera
system.

Port of `ya_vo_tpu/parallel/dist_ba.py`. Bundle adjustment's structure is
embarrassingly parallel in the LANDMARK dimension once the camera system
is Schur-reduced:

  * observations are stored landmark-major [L, W]: landmark l observed in
    window keyframe w at obs_uv[l, w] (at most one observation per
    (landmark, keyframe), so the layout is dense and static);
  * the landmark axis L is split over the mesh's shards; each shard, on
    its own device, builds its Hll (3x3), Wpl (6x3 per pose), landmark
    gradients and its PARTIAL reduced camera system S_partial [W,6,W,6],
    b_partial [W,6];
  * one sum over the shards gives the exact global reduced system: per GN
    iteration only the reduced camera system and the scalar costs cross
    devices, O((6W)^2) floats;
  * the dense [6W, 6W] solve is replicated; landmark back-substitution is
    local to each shard.

JAX's collectives map onto a `parallel.mesh.Mesh`, whose shards may share
a device, so:
  * a `psum` over a mesh axis sums the shards' partials in shard order on
    the axis group's first device; with a process group initialised (the
    1-D solver), a `torch.distributed.all_reduce` (SUM) over its processes
    follows (NCCL for CUDA tensors, gloo for the CPU);
  * an `all_gather(tiled=True)` concatenates along the gathered axis in
    shard order;
  * a replicated value (poses, S, b, the step and its acceptance) is
    computed once, on the mesh's first device, and copied to each device
    that reads it, so every shard reads the same bits.
Landmarks, `lm_valid` and the observation tiles stay on their shard's
device for the whole solve; the returned landmarks keep their shards
(`Sharded`; its `gather` concatenates them on one device).

The GN loop runs a fixed number of iterations and reads nothing back to
the host: acceptance is a 0-d device boolean, and the 3x3 and dense solves
(`inv_ex` / `solve_ex`) return NaN or inf where JAX's do, which the
finiteness gate on the pose step catches. The three-operand contractions
are grouped as (Wpl Hll^-1) first, then one product over the landmark
axis, as in `ba/window.py`. `solve` turns TF32 off for its duration, as
the JAX solvers force float32 matmul precision.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.parallel import mesh as mesh_lib


class DistBAProblem(NamedTuple):
    """Landmark-major BA problem (see module docstring for layout)."""

    poses: torch.Tensor      # [W, 4, 4] world->camera (replicated)
    landmarks: torch.Tensor  # [L, 3] (sharded on L)
    lm_valid: torch.Tensor   # [L] bool
    obs_uv: torch.Tensor     # [L, W, 2]
    obs_valid: torch.Tensor  # [L, W] bool


class Sharded(NamedTuple):
    """A tensor split along its first axis: `shards[i]`, on its own device,
    holds the rows from `starts[i]` on. With `n_processes` > 1 it holds
    this process's shards only; `gather` then gathers every process's."""

    shards: tuple
    starts: tuple
    n_processes: int = 1

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first shard's)."""
        device = self.shards[0].device if device is None else device
        out = torch.cat([s.to(device) for s in self.shards])
        if self.n_processes > 1:
            parts = [torch.empty_like(out) for _ in range(self.n_processes)]
            dist.all_gather(parts, out)
            out = torch.cat(parts)
        return out


def from_window_problem(prob) -> DistBAProblem:
    """Convert a keyframe-major `ba.window.BAProblem` (obs [W, O]) to the
    landmark-major layout, on the problem's device. The scatter runs on the
    host, as in the JAX package: of duplicate (landmark, keyframe) pairs,
    the last one stands."""
    W = int(prob.poses.shape[0])
    L = int(prob.landmarks.shape[0])
    obs_uv = np.zeros((L, W, 2), np.float32)
    obs_valid = np.zeros((L, W), bool)
    kf_lm = prob.obs_lm.cpu().numpy()
    kf_uv = prob.obs_uv.cpu().numpy()
    kf_ok = prob.obs_valid.cpu().numpy()
    for w in range(W):
        ok = kf_ok[w] & (kf_lm[w] >= 0)
        lm = kf_lm[w][ok]
        obs_uv[lm, w] = kf_uv[w][ok]
        obs_valid[lm, w] = True
    dev = prob.poses.device
    return DistBAProblem(poses=prob.poses, landmarks=prob.landmarks,
                         lm_valid=prob.lm_valid,
                         obs_uv=torch.as_tensor(obs_uv).to(dev),
                         obs_valid=torch.as_tensor(obs_valid).to(dev))


def _camera_points(poses, landmarks):
    """Each landmark in each window camera's frame: [L, W, 3]."""
    return (torch.einsum("wij,lj->lwi", poses[:, :3, :3], landmarks)
            + poses[:, :3, 3])


def _residuals(poses, landmarks, lm_valid, obs_uv, obs_valid, cam: Camera,
               n_obs=None):
    """Camera-frame points pc [L, W, 3], 1 / depth [L, W], residuals
    r [L, W, 2] and the usable observations [L, W] of a shard.

    A landmark needs >= 2 usable observations to be part of the problem:
    with one, its position is unconstrained along the ray and its
    (damped-singular) Hll^-1 corrupts the reduced camera system. n_obs:
    each landmark's count [L, 1] over the whole window, for callers whose
    local W axis is only a block of it (the 2-D solver sums
    `_obs_counts` over its keyframe blocks); None counts the local W
    axis."""
    pc = _camera_points(poses, landmarks)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid = obs_valid & lm_valid[:, None] & (z > 1e-2)
    if n_obs is None:
        n_obs = valid.sum(1, keepdim=True)
    valid = valid & (n_obs >= 2)
    inv_z = 1.0 / torch.where(z < 1e-2, 1e-2, z)
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    return pc, inv_z, torch.stack([u, v], dim=-1) - obs_uv, valid


def _obs_counts(poses, landmarks, lm_valid, obs_valid) -> torch.Tensor:
    """Each landmark's usable observations [L, 1] before the two-observation
    rule."""
    z = _camera_points(poses, landmarks)[..., 2]
    return (obs_valid & lm_valid[:, None] & (z > 1e-2)).sum(1, keepdim=True)


def _huber(r, valid, huber_delta: float):
    """Robust weights w [L, W] and each observation's cost (0 where not
    valid)."""
    chi2 = (r * r).sum(-1)
    nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w = torch.clamp(huber_delta / nrm, max=1.0) * valid.to(r.dtype)
    cost = torch.where(nrm <= huber_delta, 0.5 * chi2,
                       huber_delta * (nrm - 0.5 * huber_delta))
    return w, torch.where(valid, cost, 0.0)


def _shard_terms(poses, landmarks, lm_valid, obs_uv, obs_valid, cam: Camera,
                 huber_delta: float, n_obs=None):
    """Per-observation terms in the landmark-major layout.
    Shapes: r [L, W, 2], Jp [L, W, 2, 6], Jl [L, W, 2, 3], w [L, W]; and the
    shard's robust cost. n_obs as `_residuals`'s."""
    pc, inv_z, r, valid = _residuals(poses, landmarks, lm_valid, obs_uv,
                                     obs_valid, cam, n_obs)
    x, y = pc[..., 0], pc[..., 1]
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1),
        torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1),
    ], dim=-2)                                             # [L, W, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape + (3,))
    Jp = J_proj @ torch.cat([eye, -lie.hat(pc)], dim=-1)   # [L, W, 2, 6]
    Jl = J_proj @ poses[:, :3, :3]                         # [L, W, 2, 3]
    w, cost = _huber(r, valid, huber_delta)
    return r, Jp, Jl, w, cost.sum()


def _lm_cost_rows(poses, landmarks, lm_valid, obs_uv, obs_valid, cam: Camera,
                  huber_delta: float, n_obs=None):
    """Per-landmark robust costs [L] over the shard's W axis (they
    partition the total)."""
    _, _, r, valid = _residuals(poses, landmarks, lm_valid, obs_uv, obs_valid,
                             cam, n_obs)
    w, cost = _huber(r, valid, huber_delta)
    return torch.where(w > 0, cost, 0.0).sum(1)


def _landmark_blocks(r, Jp, Jl, w):
    """A shard's pose-side partials and landmark blocks: JpW, Hpp [W,6,6],
    bp [W,6], Hll_inv [L,3,3], bl [L,3], Wpl [L,W,6,3]."""
    JpW = Jp * w[..., None, None]
    JlW = Jl * w[..., None, None]
    Hpp = torch.einsum("lwia,lwib->wab", Jp, JpW)
    bp = -torch.einsum("lwik,lwi->wk", JpW, r)
    Hll = torch.einsum("lwik,lwim->lkm", Jl, JlW)
    bl = -torch.einsum("lwik,lwi->lk", JlW, r)
    Wpl = torch.einsum("lwik,lwim->lwkm", JpW, Jl)
    return Hpp, bp, Hll, bl, Wpl


def _inv3(Hll, damping: float):
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    return torch.linalg.inv_ex(Hll + damping * eye3)[0]


def _schur_rows(Wpl_rows, Hll_inv, Wpl_cols):
    """The reduced system's landmark term for the rows of `Wpl_rows`
    [L, Wr, 6, 3] against the columns of `Wpl_cols` [L, Wc, 6, 3]:
    (A2 [Wr*6, L*3] = (Wpl Hll^-1) flattened, S_off [Wr, 6, Wc, 6])."""
    L, Wr = Wpl_rows.shape[:2]
    Wc = Wpl_cols.shape[1]
    A = Wpl_rows @ Hll_inv[:, None]                        # [L, Wr, 6, 3]
    A2 = A.reshape(L, Wr * 6, 3).permute(1, 0, 2).reshape(Wr * 6, L * 3)
    B2 = Wpl_cols.reshape(L, Wc * 6, 3).permute(0, 2, 1).reshape(
        L * 3, Wc * 6)
    return A2, (A2 @ B2).reshape(Wr, 6, Wc, 6)


def _block_diag(blocks, n_cols: int, col0: int = 0):
    """[Wr, 6, 6] blocks placed at block (i, col0 + i) of a zero
    [Wr, 6, n_cols, 6]."""
    Wr = blocks.shape[0]
    out = blocks.new_zeros((Wr, 6, n_cols, 6))
    i = torch.arange(Wr, device=blocks.device)
    out[i, :, col0 + i, :] = blocks
    return out


def _pin_and_damp(S, n_fixed: int, damping: float):
    """The gauge pin (1e8 on the first `n_fixed` pose blocks' diagonals)
    and Levenberg damping on S [W, 6, W, 6]."""
    W = S.shape[0]
    pin = torch.zeros(W, dtype=S.dtype, device=S.device)
    pin[:n_fixed] = 1e8
    eye = torch.eye(W * 6, dtype=S.dtype, device=S.device)
    S = S + torch.diag(pin.repeat_interleave(6)).reshape(W, 6, W, 6)
    return S + damping * eye.reshape(W, 6, W, 6)


def _pose_step(S, b, n_fixed: int):
    """The dense solve for the pose step dxp [W, 6], zeroed unless finite,
    the first `n_fixed` poses held (hard gauge); and the 0-d gate `ok`."""
    W = S.shape[0]
    dxp = torch.linalg.solve_ex(S.reshape(W * 6, W * 6),
                                b.reshape(-1))[0].reshape(W, 6)
    ok = torch.isfinite(dxp).all()
    dxp = torch.where(ok, dxp, 0.0)
    dxp[:n_fixed] = 0.0
    return dxp, ok


def _back_substitute(Hll_inv, bl, Wpl, dxp, ok, lm_valid):
    """The landmark step [L, 3] for the pose step dxp, gated and clipped."""
    L, W = Wpl.shape[:2]
    rhs = bl - (Wpl.reshape(L, W * 6, 3).transpose(1, 2)
                @ dxp.reshape(W * 6))
    dxl = (Hll_inv @ rhs[..., None])[..., 0]
    dxl = torch.where(ok & lm_valid[:, None], dxl, 0.0)
    return torch.clamp(dxl, -5.0, 5.0)


def _psum(parts, dst, across_processes: bool = False):
    """JAX's psum: the partials summed in shard order on `dst`, then, with
    `across_processes`, over the default process group's processes."""
    acc = parts[0].to(dst)
    for p in parts[1:]:
        acc = acc + p.to(dst)
    if across_processes:
        acc = acc.clone()              # all_reduce writes in place
        dist.all_reduce(acc)
    return acc


def _replicate(t, devices):
    """`t` on each of `devices`, one copy a distinct device."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = t.to(d)
    return [out[d] for d in devices]


@contextlib.contextmanager
def _fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _prior(pose_prior_weight: float, poses0):
    """(deviation [W, 6], cost) of the trust-region pose prior about
    `poses0`; the cost is 0 when the weight is 0."""
    init_inv = torch.linalg.inv_ex(poses0)[0]

    def dev(poses):
        return lie.se3_log(poses @ init_inv)

    def cost(poses):
        if pose_prior_weight <= 0:
            return 0.0
        d = dev(poses)
        return 0.5 * pose_prior_weight * (d * d).sum()

    return dev, cost


def make_dist_solver(
    mesh: mesh_lib.Mesh,
    cam: Camera,
    *,
    axis: str = "lm",
    iters: int = 8,
    huber_delta: float = 2.4477,
    damping: float = 1e-4,
    n_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
):
    """Build the landmark-sharded window-BA solver over the 1-D `mesh`.

    Returns solve(problem) -> (poses [W,4,4], landmarks `Sharded` [L,3],
    cost0, cost1), poses and costs on the mesh's first device. The
    landmark axis of the problem must be divisible by the number of shards
    (the mesh's, times the processes of an initialised process group; each
    process passes the whole problem and solves its own shards).
    `n_fixed_poses` pins the gauge like ba/window.solve_window: one pose
    fixes SE(3), a second also pins the monocular scale gauge (the live
    backend uses 2). `pose_prior_weight` is the same trust-region pose
    prior as solve_window's."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"a 1-D mesh over {axis!r}, not {mesh.axis_names}")
    devices = list(mesh.devices)
    root = devices[0]
    n = len(devices)

    def solve(prob: DistBAProblem):
        grouped = mesh_lib.is_distributed_initialized()
        n_proc = mesh_lib.process_count()
        L, W = prob.landmarks.shape[0], prob.poses.shape[0]
        if L % (n * n_proc):
            raise ValueError(f"{L} landmarks over {n * n_proc} shards")
        Ls = L // (n * n_proc)
        starts = [(mesh_lib.process_index() * n + i) * Ls for i in range(n)]
        data = [tuple(x[s:s + Ls].to(d) for x in prob[2:])
                for s, d in zip(starts, devices)]    # lm_valid, uv, ok
        lms = [prob.landmarks[s:s + Ls].to(d)
               for s, d in zip(starts, devices)]

        def psum(parts):
            return _psum(parts, root, grouped)

        def cost(poses):
            pd = _replicate(poses, devices)
            return psum([_shard_terms(pd[i], lms[i], *data[i], cam,
                                      huber_delta)[4] for i in range(n)])

        with _fp32_matmul():
            poses = prob.poses.to(root)
            prior_dev, prior_cost = _prior(pose_prior_weight, poses)
            eye = torch.eye(W * 6, dtype=poses.dtype,
                            device=root).reshape(W, 6, W, 6)
            cost0 = cost(poses)
            for _ in range(iters):
                pd = _replicate(poses, devices)
                parts, blocks = [], []
                for i in range(n):
                    r, Jp, Jl, w, c = _shard_terms(pd[i], lms[i], *data[i],
                                                   cam, huber_delta)
                    Hpp, bp, Hll, bl, Wpl = _landmark_blocks(r, Jp, Jl, w)
                    Hll_inv = _inv3(Hll, damping)
                    A2, S_off = _schur_rows(Wpl, Hll_inv, Wpl)
                    S_part = _block_diag(Hpp, W) - S_off
                    b_part = bp - (A2 @ bl.reshape(-1)).reshape(W, 6)
                    # THE collective: S, b and the cost at the
                    # linearization point in one sum
                    parts.append(torch.cat([S_part.reshape(-1),
                                            b_part.reshape(-1),
                                            c.reshape(1)]))
                    blocks.append((Hll_inv, bl, Wpl))
                tot = psum(parts)
                S = tot[:36 * W * W].reshape(W, 6, W, 6)
                b = tot[36 * W * W:-1].reshape(W, 6)
                cost_prev = tot[-1]

                # gauge + damping (+ prior), replicated dense solve
                S = _pin_and_damp(S, n_fixed_poses, damping)
                if pose_prior_weight > 0:
                    S = S + pose_prior_weight * eye
                    b = b - pose_prior_weight * prior_dev(poses)
                dxp, ok = _pose_step(S, b, n_fixed_poses)
                new_poses = lie.se3_exp(dxp) @ poses

                # local landmark back-substitution and per-landmark
                # acceptance (the two evaluations also give the exact
                # mixed-configuration cost)
                npd = _replicate(new_poses, devices)
                dxd = _replicate(dxp, devices)
                okd = _replicate(ok, devices)
                cands, mixed = [], []
                for i in range(n):
                    Hll_inv, bl, Wpl = blocks[i]
                    cand = lms[i] + _back_substitute(Hll_inv, bl, Wpl, dxd[i],
                                                     okd[i], data[i][0])
                    lmA = _lm_cost_rows(npd[i], cand, *data[i], cam,
                                        huber_delta)
                    lmB = _lm_cost_rows(npd[i], lms[i], *data[i], cam,
                                        huber_delta)
                    cands.append(torch.where((lmA <= lmB)[:, None], cand,
                                             lms[i]))
                    mixed.append(torch.minimum(lmA, lmB).sum())
                mixed_cost = psum(mixed) + prior_cost(new_poses)
                # accept-if-better on the GLOBAL cost for the pose step
                accept = mixed_cost < cost_prev + prior_cost(poses)
                poses = torch.where(accept, new_poses, poses)
                acc = _replicate(accept, devices)
                lms = [torch.where(acc[i], cands[i], lms[i])
                       for i in range(n)]
            cost1 = cost(poses)
        return poses, Sharded(tuple(lms), tuple(starts), n_proc), cost0, cost1

    return solve


def make_dist_solver_2d(
    mesh: mesh_lib.Mesh,
    cam: Camera,
    *,
    kf_axis: str = "kf",
    lm_axis: str = "lm",
    iters: int = 8,
    huber_delta: float = 2.4477,
    damping: float = 1e-4,
    n_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
):
    """2-D distributed window BA: keyframe BLOCKS x landmark SHARDS.

    The window's keyframe axis W is partitioned into Pk blocks and the
    landmark axis L into Pl shards over a 2-D mesh (parallel/mesh.map_mesh).
    Tile (k, l) owns the observation TILE [L/Pl, W/Pk] on its device;
    landmark shard l lives on its kf column's first device. Per GN
    iteration:
      * sum over kf: per-landmark obs counts, Hll [Ls,3,3], bl [Ls,3]
      * gather over kf: Wpl rows [Ls, W, 6, 3] (the dominant transfer: it
        stays within a kf column)
      * each tile's reduced camera rows, summed over lm and gathered over
        kf: S [W6, W6]
      * the dense solve, landmark back-substitution on each column.
    `collective_bytes_per_iter` prices these exactly.

    Returns solve(problem) -> (poses `Sharded` over kf blocks, landmarks
    `Sharded` over lm shards, cost0, cost1). Requires W % Pk == 0 and
    L % Pl == 0. Runs within one process: across processes it would need
    sub-group collectives, and raises NotImplementedError when the process
    group holds more than one process (ROADMAP Queue 1 item 14).
    """
    grid = (mesh.devices if mesh.axis_names == (kf_axis, lm_axis)
            else mesh.devices.T)
    Pk, Pl = grid.shape
    col = [grid[0, l] for l in range(Pl)]      # landmark shard l's home
    root = grid[0, 0]
    tiles = [(k, l) for k in range(Pk) for l in range(Pl)]

    def solve(prob: DistBAProblem):
        if mesh_lib.process_count() > 1:
            raise NotImplementedError(
                "the 2-D solver across processes needs sub-group "
                "collectives: not ported yet, ROADMAP Queue 1 item 14")
        W, L = prob.poses.shape[0], prob.landmarks.shape[0]
        if W % Pk or L % Pl:
            raise ValueError(f"W={W}, L={L} over a {Pk}x{Pl} mesh")
        Wk, Ls = W // Pk, L // Pl
        kb = [slice(k * Wk, (k + 1) * Wk) for k in range(Pk)]
        lb = [slice(l * Ls, (l + 1) * Ls) for l in range(Pl)]
        obs = {(k, l): (prob.obs_uv[lb[l], kb[k]].to(grid[k, l]),
                        prob.obs_valid[lb[l], kb[k]].to(grid[k, l]))
               for k, l in tiles}
        lmv = [prob.lm_valid[lb[l]].to(col[l]) for l in range(Pl)]
        lmv_t = {(k, l): lmv[l].to(grid[k, l]) for k, l in tiles}
        lms = [prob.landmarks[lb[l]].to(col[l]) for l in range(Pl)]

        def on_tiles(poses, lms_cols):
            """Each tile's pose block and landmark shard on its device, and
            its column's observation counts over the whole window."""
            pb = {(k, l): poses[kb[k]].to(grid[k, l]) for k, l in tiles}
            lt = {(k, l): lms_cols[l].to(grid[k, l]) for k, l in tiles}
            n_obs = [_psum([_obs_counts(pb[k, l], lt[k, l], lmv_t[k, l],
                                        obs[k, l][1]) for k in range(Pk)],
                           col[l]) for l in range(Pl)]
            return {(k, l): (pb[k, l], lt[k, l], lmv_t[k, l], *obs[k, l],
                             n_obs[l].to(grid[k, l])) for k, l in tiles}

        def terms(tile_args):
            p, x, v, uv, ok, n_obs = tile_args
            return _shard_terms(p, x, v, uv, ok, cam, huber_delta, n_obs)

        def cost_rows(tile_args):
            p, x, v, uv, ok, n_obs = tile_args
            return _lm_cost_rows(p, x, v, uv, ok, cam, huber_delta, n_obs)

        def cost(poses):
            ta = on_tiles(poses, lms)
            return _psum([terms(ta[t])[4] for t in tiles], root)

        with _fp32_matmul():
            poses = prob.poses.to(root)
            prior_dev, _ = _prior(pose_prior_weight, poses)

            def prior_cost(poses_q):
                """Summed over the kf blocks in order."""
                if pose_prior_weight <= 0:
                    return 0.0
                d = prior_dev(poses_q)
                return 0.5 * pose_prior_weight * _psum(
                    [(d[kb[k]] * d[kb[k]]).sum() for k in range(Pk)], root)

            eye = torch.eye(W * 6, dtype=poses.dtype,
                            device=root).reshape(W, 6, W, 6)
            cost0 = cost(poses)
            for _ in range(iters):
                ta = on_tiles(poses, lms)
                own = {}
                for t in tiles:
                    r, Jp, Jl, w, c = terms(ta[t])
                    own[t] = (r, c) + _landmark_blocks(r, Jp, Jl, w)
                # the landmark system, exact over the window (sum over kf)
                Hll_inv = [_inv3(_psum([own[k, l][4] for k in range(Pk)],
                                       col[l]), damping) for l in range(Pl)]
                bl = [_psum([own[k, l][5] for k in range(Pk)], col[l])
                      for l in range(Pl)]
                # the dominant gather: each landmark's coupling rows for
                # the WHOLE window
                Wpl_full = [torch.cat([own[k, l][6].to(col[l])
                                       for k in range(Pk)], dim=1)
                            for l in range(Pl)]
                rows_S, rows_b = {}, {}
                for k, l in tiles:
                    _, _, Hpp, bp, _, _, Wpl_own = own[k, l]
                    d = grid[k, l]
                    A2, S_off = _schur_rows(Wpl_own, Hll_inv[l].to(d),
                                            Wpl_full[l].to(d))
                    rows_S[k, l] = _block_diag(Hpp, W, k * Wk) - S_off
                    rows_b[k, l] = bp - (A2 @ bl[l].to(d).reshape(-1)
                                         ).reshape(Wk, 6)
                # reduced camera rows: sum over lm, gathered over kf
                S = torch.cat([_psum([rows_S[k, l] for l in range(Pl)],
                                     grid[k, 0]).to(root)
                               for k in range(Pk)])
                b = torch.cat([_psum([rows_b[k, l] for l in range(Pl)],
                                     grid[k, 0]).to(root)
                               for k in range(Pk)])
                if pose_prior_weight > 0:
                    S = S + pose_prior_weight * eye
                    b = b - pose_prior_weight * prior_dev(poses)
                S = _pin_and_damp(S, n_fixed_poses, damping)
                dxp, ok = _pose_step(S, b, n_fixed_poses)
                new_poses = lie.se3_exp(dxp) @ poses

                # landmark back-substitution on each column
                cands = [lms[l] + _back_substitute(
                    Hll_inv[l], bl[l], Wpl_full[l], dxp.to(col[l]),
                    ok.to(col[l]), lmv[l]) for l in range(Pl)]
                ta_a = on_tiles(new_poses, cands)
                ta_b = on_tiles(new_poses, lms)
                new_lms, mixed = [], []
                for l in range(Pl):
                    lmA = _psum([cost_rows(ta_a[k, l]) for k in range(Pk)],
                                col[l])
                    lmB = _psum([cost_rows(ta_b[k, l]) for k in range(Pk)],
                                col[l])
                    new_lms.append(torch.where((lmA <= lmB)[:, None],
                                               cands[l], lms[l]))
                    mixed.append(torch.minimum(lmA, lmB).sum())
                mixed_cost = _psum(mixed, root) + prior_cost(new_poses)
                cost_prev = (_psum([own[t][1] for t in tiles], root)
                             + prior_cost(poses))
                accept = mixed_cost < cost_prev
                poses = torch.where(accept, new_poses, poses)
                lms = [torch.where(accept.to(col[l]), new_lms[l], lms[l])
                       for l in range(Pl)]
            cost1 = cost(poses)
        out_poses = Sharded(tuple(poses[kb[k]].to(grid[k, 0])
                                  for k in range(Pk)),
                            tuple(k * Wk for k in range(Pk)))
        return (out_poses, Sharded(tuple(lms), tuple(l * Ls
                                                     for l in range(Pl))),
                cost0, cost1)

    return solve


def collective_bytes_per_iter(
    W: int, L: int, n_kf: int = 1, n_lm: int = 1
) -> dict:
    """Logical collective payload per device per GN iteration, in bytes,
    for the 1-D (n_kf=1) and 2-D solvers. Ring-algorithm wire traffic per
    device is ~2(N-1)/N x payload for all-reduce and (N-1)/N x result for
    all-gather; both factors are applied in `ring_bytes`."""
    f32 = 4
    Ls = L // n_lm
    Wk = W // n_kf

    def ring_ar(payload, n):   # all-reduce, ring
        return 2 * (n - 1) / max(n, 1) * payload

    def ring_ag(result, n):    # all-gather, ring: receive the rest
        return (n - 1) / max(n, 1) * result

    if n_kf == 1:
        psum_payload = (36 * W * W + 6 * W + 4) * f32    # S + b + scalars
        return {
            "psum_bytes": psum_payload,
            "gather_bytes": 0,
            "ring_bytes": ring_ar(psum_payload, n_lm),
        }
    # 2-D: per _shard_terms call there is an n_obs psum [Ls] (3 calls/iter)
    psum_kf = (3 * Ls * f32                               # n_obs counts
               + (9 + 3) * Ls * f32                       # Hll + bl
               + 2 * Ls * f32)                            # lmA/lmB rows
    psum_lm = (36 * Wk * W + 6 * W + 4) * f32             # S rows + b + costs
    gather_kf = (Ls * W * 18 * f32                        # Wpl_full
                 + (36 * W * W + 6 * W) * f32)            # S + b rows
    return {
        "psum_bytes": psum_kf + psum_lm,
        "gather_bytes": gather_kf,
        "ring_bytes": (ring_ar(psum_kf, n_kf) + ring_ar(psum_lm, n_lm)
                       + ring_ag(gather_kf, n_kf)),
    }
