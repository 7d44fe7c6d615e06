"""The plain reference of a window solve: a frozen copy of the port's
`ba/window.py` plain version (`solve_window_plain` and its pieces:
Gauss-Newton with the Schur complement, the first poses pinned, Levenberg
damping, the trust-region prior, per-landmark and global acceptance, the
early exit at `rel_tol`), in plain PyTorch, importing nothing of the
program. A problem is any object with the fields of the port's
`BAProblem` (poses, pose_valid, landmarks, lm_valid, obs_uv, obs_lm,
obs_valid); `cam` = (fx, fy, cx, cy). Matrix products follow the global
TF32 flags: off for the reference, on for the control.

`cost64` is the comparison's yardstick: a window's robust cost (with the
prior) in float64 at given poses and landmarks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference import lie


class Problem(NamedTuple):
    """A window problem, field for field the port's `BAProblem`."""

    poses: torch.Tensor      # [W, 4, 4] world->camera
    pose_valid: torch.Tensor  # [W] bool
    landmarks: torch.Tensor  # [L, 3]
    lm_valid: torch.Tensor   # [L] bool
    obs_uv: torch.Tensor     # [W, O, 2]
    obs_lm: torch.Tensor     # [W, O] int64 (-1 = none)
    obs_valid: torch.Tensor  # [W, O] bool


class Segments(NamedTuple):
    """Each landmark's observations, for deterministic per-landmark sums:
    idx [L, M] flat observation indices (W*O pads to a zero row), kf [L, M]
    the keyframe of each (W for a pad)."""
    idx: torch.Tensor
    kf: torch.Tensor


def segments(obs_lm: torch.Tensor, n_landmarks: int) -> Segments:
    """The [L, M] layout of `obs_lm` [W, O] (M = the most observations of
    one landmark), in ascending flat order within a landmark. One host read
    (M)."""
    W, O = obs_lm.shape
    L, N = n_landmarks, W * O
    dev = obs_lm.device
    key = obs_lm.reshape(-1)
    key = torch.where(key >= 0, key, L)              # dump the empty slots
    order = torch.argsort(key, stable=True)
    sk = key[order]
    counts = torch.bincount(key, minlength=L + 1)
    M = max(1, int(counts[:L].max()))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=dev) - starts[sk]
    rank = torch.where(sk < L, rank, 0)              # row L is discarded
    idx = torch.full((L + 1, M), N, dtype=torch.int64, device=dev)
    idx = idx.index_put((sk, rank), order)[:L]
    kf = torch.where(idx < N, idx // O, W)
    return Segments(idx, kf)


def _segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Per-landmark sums of per-observation `vals` [W, O, ...] -> [L, ...]."""
    W, O = vals.shape[:2]
    flat = vals.reshape((W * O,) + vals.shape[2:])
    flat = torch.cat([flat, torch.zeros_like(flat[:1])])
    return flat[seg.idx].sum(1)


def _obs_terms(poses, landmarks, prob, cam,
               huber_delta: float, seg: Segments):
    """Per-observation residuals, Jacobians and robust weights.

    Returns r [W,O,2], Jp [W,O,2,6], Jl [W,O,2,3], w [W,O], cost [],
    valid [W,O]."""
    lm_idx = torch.clamp(prob.obs_lm, min=0)
    X = landmarks[lm_idx]                        # [W, O, 3]
    R = poses[:, :3, :3]
    t = poses[:, None, :3, 3]
    pc = torch.einsum("wij,woj->woi", R, X) + t  # [W, O, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid = (prob.obs_valid & (prob.obs_lm >= 0) & prob.pose_valid[:, None]
             & prob.lm_valid[lm_idx] & (z > 1e-2))
    # exclude landmarks with < 2 usable observations (unconstrained along
    # their single ray)
    n_obs_per_lm = _segment_sum(valid.to(torch.int32), seg)
    valid = valid & (n_obs_per_lm[lm_idx] >= 2)
    z_safe = torch.where(z < 1e-2, 1e-2, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam[0] * x * inv_z + cam[2]
    v = cam[1] * y * inv_z + cam[3]
    r = torch.stack([u, v], dim=-1) - prob.obs_uv  # [W, O, 2]

    zeros = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([cam[0] * inv_z, zeros, -cam[0] * x * inv_z2], dim=-1),
        torch.stack([zeros, cam[1] * inv_z, -cam[1] * y * inv_z2], dim=-1),
    ], dim=-2)                                     # [W, O, 2, 3]
    # pose Jacobian (left-multiplicative tangent [v, w]): d pc = [I | -hat(pc)]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape + (3,))
    Jp_point = torch.cat([eye, -lie.hat(pc)], dim=-1)       # [W, O, 3, 6]
    Jp = J_proj @ Jp_point                                  # [W, O, 2, 6]
    # landmark Jacobian: d pc / d X = R
    Jl = torch.einsum("woij,wjk->woik", J_proj, R)          # [W, O, 2, 3]

    chi2 = (r * r).sum(-1)
    nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w_huber = torch.clamp(huber_delta / nrm, max=1.0)
    w = w_huber * valid.to(r.dtype)

    huber_cost = torch.where(nrm <= huber_delta, 0.5 * chi2,
                             huber_delta * (nrm - 0.5 * huber_delta))
    cost = torch.where(valid, huber_cost, 0.0).sum()
    return r, Jp, Jl, w, cost, valid


def _reduced_system(r, Jp, Jl, w, seg: Segments, damping):
    """Build the Schur-reduced camera system.

    Returns S [W,6,W,6], b_red [W,6], and the landmark-side pieces
    (Hll_inv [L,3,3], bl [L,3], Wpl [L,W,6,3]) for back-substitution."""
    W = r.shape[0]
    L = seg.idx.shape[0]

    JpW = Jp * w[..., None, None]
    Hpp = torch.einsum("woik,woil->wkl", Jp, JpW)            # [W, 6, 6]
    bp = -torch.einsum("woik,woi->wk", JpW, r)               # [W, 6]

    JlW = Jl * w[..., None, None]
    Hll_obs = torch.einsum("woik,woil->wokl", Jl, JlW)       # [W, O, 3, 3]
    bl_obs = -torch.einsum("woik,woi->wok", JlW, r)          # [W, O, 3]
    G_obs = torch.einsum("woik,woil->wokl", JpW, Jl)         # [W, O, 6, 3]

    Hll = _segment_sum(Hll_obs, seg)                         # [L, 3, 3]
    bl = _segment_sum(bl_obs, seg)                           # [L, 3]
    # cross blocks per (landmark, keyframe): each landmark's observations
    # summed into their keyframe's column by a one-hot product
    G = G_obs.reshape(-1, 18)
    G = torch.cat([G, torch.zeros_like(G[:1])])[seg.idx]     # [L, M, 18]
    onehot = (seg.kf[:, :, None] == torch.arange(
        W, device=G.device)).to(G.dtype)                     # [L, M, W]
    Wpl = (onehot.transpose(1, 2) @ G).reshape(L, W, 6, 3)

    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]

    # S = blockdiag(Hpp) - sum_l Wpl[l] Hll_inv[l] Wpl[l]^T, grouped as
    # (Wpl Hll_inv) [L, W, 6, 3] and one product over (l, m)
    A = Wpl @ Hll_inv[:, None]                               # [L, W, 6, 3]
    A2 = A.reshape(L, W * 6, 3).permute(1, 0, 2).reshape(W * 6, L * 3)
    B2 = Wpl.reshape(L, W * 6, 3).permute(0, 2, 1).reshape(L * 3, W * 6)
    S_off = (A2 @ B2).reshape(W, 6, W, 6)
    eyeW = torch.eye(W, dtype=r.dtype, device=r.device)
    S = torch.einsum("wv,wkl->wkvl", eyeW, Hpp) - S_off
    b_red = bp - (A2 @ bl.reshape(L * 3)).reshape(W, 6)
    return S, b_red, Hll_inv, bl, Wpl


def _gauge_fix(S, b_red, n_fixed: int = 1, pose_weight: float = 1e8):
    """Pin the first `n_fixed` poses by adding a huge diagonal to their
    blocks (one fixes the SE(3) gauge, a second the monocular scale)."""
    W = S.shape[0]
    pin = torch.zeros(W, dtype=S.dtype, device=S.device)
    pin[:n_fixed] = pose_weight
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    eyeW = torch.eye(W, dtype=S.dtype, device=S.device)
    return S + torch.einsum("w,kl,wv->wkvl", pin, eye6, eyeW), b_red


def _solve_start(prob, cam, huber_delta: float,
                 seg: Segments):
    """A solve's first values: (initial cost, observations used, the
    initial poses' inverses for the prior)."""
    *_, cost0, valid0 = _obs_terms(prob.poses, prob.landmarks, prob, cam,
                                   huber_delta, seg)
    return cost0, valid0.sum(), torch.linalg.inv_ex(prob.poses)[0]


def _gn_iteration(poses, landmarks, prob, cam,
                  seg: Segments, init_inv, *, huber_delta: float,
                  damping: float, n_fixed_poses: int,
                  pose_prior_weight: float):
    """One damped GN step with its per-landmark and global acceptance:
    (poses, landmarks, relative cost improvement; 0 when rejected)."""
    L = prob.landmarks.shape[0]
    W = prob.poses.shape[0]

    def lm_cost_eval(poses, landmarks):
        """Per-landmark robust cost [L] (they partition the total)."""
        r_q, _, _, _, _, valid_q = _obs_terms(poses, landmarks, prob, cam,
                                              huber_delta, seg)
        chi2q = (r_q * r_q).sum(-1)
        nq = torch.sqrt(torch.clamp(chi2q, min=1e-12))
        hc = torch.where(nq <= huber_delta, 0.5 * chi2q,
                         huber_delta * (nq - 0.5 * huber_delta))
        return _segment_sum(torch.where(valid_q, hc, 0.0), seg)

    def prior_dev(poses):
        return lie.se3_log(poses @ init_inv)                 # [W, 6]

    def prior_cost(poses):
        if pose_prior_weight <= 0:
            return 0.0
        d = prior_dev(poses)
        return 0.5 * pose_prior_weight * (d * d).sum()

    eye_blk = torch.eye(W * 6, dtype=prob.poses.dtype,
                        device=prob.poses.device).reshape(W, 6, W, 6)
    r, Jp, Jl, w, cost_prev, _ = _obs_terms(poses, landmarks, prob, cam,
                                            huber_delta, seg)
    S, b_red, Hll_inv, bl, Wpl = _reduced_system(r, Jp, Jl, w, seg, damping)
    S, b_red = _gauge_fix(S, b_red, n_fixed=n_fixed_poses)
    S = S + damping * eye_blk
    if pose_prior_weight > 0:
        S = S + pose_prior_weight * eye_blk
        b_red = b_red - pose_prior_weight * prior_dev(poses)
        cost_prev = cost_prev + prior_cost(poses)

    dxp = torch.linalg.solve_ex(S.reshape(W * 6, W * 6),
                                b_red.reshape(-1))[0].reshape(W, 6)
    ok = torch.isfinite(dxp).all()
    dxp = torch.where(ok, dxp, 0.0)
    dxp[:n_fixed_poses] = 0.0                                # hard gauge

    # landmark back-substitution
    rhs = bl - (Wpl.reshape(L, W * 6, 3).transpose(1, 2)
                @ dxp.reshape(W * 6))
    dxl = (Hll_inv @ rhs[..., None])[..., 0]
    dxl = torch.where(ok & prob.lm_valid[:, None], dxl, 0.0)
    dxl = torch.clamp(dxl, -5.0, 5.0)

    new_poses = lie.se3_exp(dxp) @ poses
    cand = landmarks + dxl
    # per-landmark acceptance, then the global one for the pose step
    lmA = lm_cost_eval(new_poses, cand)
    lmB = lm_cost_eval(new_poses, landmarks)
    new_landmarks = torch.where((lmA <= lmB)[:, None], cand, landmarks)
    mixed_cost = torch.minimum(lmA, lmB).sum() + prior_cost(new_poses)
    accept = mixed_cost < cost_prev
    poses = torch.where(accept, new_poses, poses)
    landmarks = torch.where(accept, new_landmarks, landmarks)
    improvement = torch.where(
        accept, (cost_prev - mixed_cost)
        / torch.clamp(cost_prev, min=1e-12), 0.0)
    return poses, landmarks, improvement


def solve_window_plain(prob, cam, *, iters: int = 8,
                       huber_delta: float = 2.4477, damping: float = 1e-4,
                       n_fixed_poses: int = 1, rel_tol: float = 1e-3,
                       pose_prior_weight: float = 0.0) :
    """`solve_window`'s plain version, on either device: the loop above
    with the exit read on the host after each iteration. On the card, TF32
    must be off (the frontend turns it off)."""
    seg = segments(prob.obs_lm, prob.landmarks.shape[0])
    cost0, n_obs, init_inv = _solve_start(prob, cam, huber_delta, seg)
    kw = dict(huber_delta=huber_delta, damping=damping,
              n_fixed_poses=n_fixed_poses,
              pose_prior_weight=pose_prior_weight)
    poses, landmarks = prob.poses, prob.landmarks
    n_iters = 0
    while n_iters < iters:
        poses, landmarks, improvement = _gn_iteration(
            poses, landmarks, prob, cam, seg, init_inv, **kw)
        n_iters += 1
        if not bool(improvement > rel_tol):
            break

    *_, cost1, _ = _obs_terms(poses, landmarks, prob, cam, huber_delta, seg)
    return poses, landmarks, n_iters


def cost64(prob, poses, landmarks, cam, huber_delta: float,
           pose_prior_weight: float) -> float:
    """The robust reprojection cost of `prob` at (poses, landmarks) plus
    the prior's, in float64, over the observations the solve uses (valid,
    in front, landmark seen at least twice at the problem's start)."""
    d = torch.float64
    p0 = prob.poses.to(d)
    seg = segments(prob.obs_lm, prob.landmarks.shape[0])
    P = Problem(*(t.to(d) if t.is_floating_point() else t for t in prob))
    *_, valid0 = _obs_terms(p0, P.landmarks, P, cam, huber_delta, seg)
    r, *_ = _obs_terms(poses.to(d), landmarks.to(d), P, cam, huber_delta,
                       seg)
    chi2 = (r * r).sum(-1)
    nrm = torch.sqrt(torch.clamp(chi2, min=1e-24))
    hc = torch.where(nrm <= huber_delta, 0.5 * chi2,
                     huber_delta * (nrm - 0.5 * huber_delta))
    cost = torch.where(valid0, hc, 0.0).sum()
    if pose_prior_weight > 0:
        dev = lie.se3_log(poses.to(d) @ torch.linalg.inv(p0))
        dev = torch.where(P.pose_valid[:, None], dev, 0.0)
        cost = cost + 0.5 * pose_prior_weight * (dev * dev).sum()
    return float(cost)
