"""The plain reference of one tracking step, from the step's inputs.

A frozen copy, in plain PyTorch, of the semantics of the port's fused
step (`tracking/frontend.py` `_extract` and `_step_body`, with the plain
versions of the kernels it calls: `tracking/lk_cuda.track_pyramids_plain`,
`tracking/pose_solver.solve_pose_plain`, `features/matching.match` over
`hamming_cuda.hamming_matrix_plain`, `geometry/triangulation.
triangulate_fast`). It imports nothing of the program.

`track(inputs, cfg, cam)` runs extraction, LK and pose GN from the frame
and the step's state inputs; `replenish(inputs, cfg, cam, up)` runs the
rest of the step (matching, triangulation, the keyframe decision and the
merge) on the outputs `up` of those stages; `step` chains the two.
`low=True` is the control: the reference one precision below what the
configuration states, i.e. the score map, the blur and the LK pyramids in
bfloat16 (the caller turns TF32 on for the geometry's matrix products).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vo_bench.reference import extract, lie

HALF, TMPL, LO = 5, 13, 6.0
INVALID_DIST = 100000


# --------------------------------------------------------------------------
# camera
# --------------------------------------------------------------------------
def project(cam, pts):
    z = pts[..., 2]
    eps = 1e-6
    z_safe = torch.where(z.abs() < eps,
                         torch.where(z < 0, -eps, eps).to(z.dtype), z)
    u = cam[0] * pts[..., 0] / z_safe + cam[2]
    v = cam[1] * pts[..., 1] / z_safe + cam[3]
    return torch.stack([u, v], dim=-1), z


def K_matrix(cam, device):
    return torch.tensor([[cam[0], 0.0, cam[2]], [0.0, cam[1], cam[3]],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# LK (inverse compositional, coarse to fine)
# --------------------------------------------------------------------------
def pyramid(img, levels: int):
    pyr, cur = [img], img
    for _ in range(levels - 1):
        H2, W2 = cur.shape[0] // 2, cur.shape[1] // 2
        rows = 0.5 * cur[0:2 * H2:2] + 0.5 * cur[1:2 * H2:2]
        cur = 0.5 * rows[:, 0:2 * W2:2] + 0.5 * rows[:, 1:2 * W2:2]
        pyr.append(cur.contiguous())
    return pyr


def padded_size(H: int, W: int):
    return max(32, -(-H // 8) * 8), max(256, -(-W // 128) * 128)


def _windows(img_p, ru, rv, size: int):
    Hp, Wp = img_p.shape
    half = (size - 1) // 2
    fu, fv = torch.floor(ru), torch.floor(rv)
    au, av = (ru - fu)[:, None, None], (rv - fv)[:, None, None]
    c0 = (fu.to(torch.int64) - half).clamp(0, Wp - size - 1)
    r0 = (fv.to(torch.int64) - half).clamp(0, Hp - size - 1)
    ar = torch.arange(size, device=img_p.device)
    rows = (r0[:, None] + ar)[:, :, None]
    cols = (c0[:, None] + ar)[:, None, :]
    rs0 = (1.0 - av) * img_p[rows, cols] + av * img_p[rows + 1, cols]
    rs1 = (1.0 - av) * img_p[rows, cols + 1] + av * img_p[rows + 1, cols + 1]
    return (1.0 - au) * rs0 + au * rs1


def _mean(x):
    return x.sum((1, 2)) / float(x.shape[1] * x.shape[2])


def lk_level(img0, img1, uv0, seed, valid, iters: int, eps: float):
    H, W = img0.shape
    Hp, Wp = padded_size(H, W)
    img0 = F.pad(img0, (0, Wp - W, 0, Hp - H))
    img1 = F.pad(img1, (0, Wp - W, 0, Hp - H))
    B = _windows(img0, uv0[:, 0], uv0[:, 1], TMPL)
    T = B[:, 1:12, 1:12]
    gx = 0.5 * (B[:, 1:12, 2:13] - B[:, 1:12, 0:11])
    gy = 0.5 * (B[:, 2:13, 1:12] - B[:, 0:11, 1:12])
    t_mean = _mean(T)
    t_std = torch.sqrt(torch.clamp(_mean(T * T) - t_mean * t_mean, min=0.0))
    gxx, gxy, gyy = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), \
        (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4.0 * det,
                                              min=0.0))) * 0.5 / 121.0
    det_safe = torch.where(det.abs() < 1e-6, 1e-6, det)
    iG00, iG01, iG11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe
    ru = seed[:, 0].clamp(LO, Wp - 8.0)
    rv = seed[:, 1].clamp(LO, Hp - 8.0)
    active = valid.clone()
    for _ in range(iters):
        if not bool(active.any()):
            break
        err = _windows(img1, ru, rv, 2 * HALF + 1) - T
        err = err - _mean(err)[:, None, None]
        bx, by = (err * gx).sum((1, 2)), (err * gy).sum((1, 2))
        du = -(iG00 * bx + iG01 * by)
        dv = -(iG01 * bx + iG11 * by)
        step = torch.sqrt(du * du + dv * dv)
        ru = torch.where(active, (ru + du).clamp(LO, Wp - 8.0), ru)
        rv = torch.where(active, (rv + dv).clamp(LO, Hp - 8.0), rv)
        active = active & (step >= eps)
    res = _mean((_windows(img1, ru, rv, 2 * HALF + 1) - T).abs())
    uv = torch.where(valid[:, None], torch.stack([ru, rv], dim=-1), seed)
    zero = torch.zeros_like(res)
    return (uv, torch.where(valid, min_eig, zero),
            torch.where(valid, res, 1e9), torch.where(valid, t_std, zero))


def lk_track(img0, img1, uv0, uv_init, mask, tc: dict, low: bool):
    """(uv [N, 2], status [N]) of the tracker, coarse to fine; `low` stores
    the pyramids' levels in bfloat16."""
    levels = tc["lk_levels"]
    pyr0 = pyramid(img0.to(torch.float32), levels)
    pyr1 = pyramid(img1.to(torch.float32), levels)
    if low:
        pyr0 = [p.to(torch.bfloat16).float() for p in pyr0]
        pyr1 = [p.to(torch.bfloat16).float() for p in pyr1]
    H, W = pyr0[0].shape
    uv = uv_init / 2.0 ** (levels - 1)
    cond = torch.ones_like(mask)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        uv, eig, residual, t_std = lk_level(
            pyr0[lvl], pyr1[lvl], (uv0 / s).contiguous(), uv.contiguous(),
            mask, tc["lk_iters"], tc["lk_eps"])
        cond = cond & (eig > 1e-3)
        if lvl > 0:
            uv = uv * 2.0
    in_bounds = ((uv[:, 0] >= HALF) & (uv[:, 0] < W - HALF)
                 & (uv[:, 1] >= HALF) & (uv[:, 1] < H - HALF))
    gate = torch.clamp(tc["lk_rel_residual"] * t_std,
                       min=tc["lk_max_residual"])
    return uv, mask & cond & in_bounds & (residual < gate)


# --------------------------------------------------------------------------
# pose-only robust Gauss-Newton
# --------------------------------------------------------------------------
def _res_jac(T, pts_w, uv, cam):
    pc = lie.transform_points(T, pts_w)
    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.where(Z < 1e-3, 1e-3, Z)
    inv_z2 = inv_z * inv_z
    u = cam[0] * X * inv_z + cam[2]
    v = cam[1] * Y * inv_z + cam[3]
    r = torch.stack([u, v], dim=-1) - uv
    zeros = torch.zeros_like(X)
    J_proj = torch.stack([
        torch.stack([cam[0] * inv_z, zeros, -cam[0] * X * inv_z2], dim=-1),
        torch.stack([zeros, cam[1] * inv_z, -cam[1] * Y * inv_z2], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    J_point = torch.cat([eye, -lie.hat(pc)], dim=-1)
    return r, J_proj @ J_point, Z


def solve_pose(T_init, pts_w, uv, mask, cam, *, iters: int, huber_delta: float,
               chi2_threshold: float, damping: float = 1e-6):
    """(pose, inlier mask): the robust GN loop with its early exit once a
    step's norm is <= 1e-5."""
    T = T_init
    active = torch.ones((), dtype=torch.bool, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        r, J, Z = _res_jac(T, pts_w, uv, cam)
        chi2 = (r * r).sum(-1)
        valid = mask & (Z > 1e-3)
        w_h = torch.clamp(
            huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
        w_g = torch.where(chi2 > chi2_threshold, 1e-3, 1.0)
        JW = J * (w_h * w_g * valid.to(r.dtype))[:, None, None]
        H = torch.einsum("nik,nil->kl", J, JW) + damping * eye6
        b = -torch.einsum("nik,ni->k", JW, r)
        dx = torch.linalg.solve_ex(H, b)[0]
        ok = torch.isfinite(dx).all() & (torch.linalg.norm(dx) < 1.0)
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        T = torch.where(active, lie.se3_exp(dx) @ T, T)
        active = active & (torch.linalg.norm(dx) > 1e-5)
        if not bool(active):
            break
    r, _, Z = _res_jac(T, pts_w, uv, cam)
    inliers = mask & (Z > 1e-3) & ((r * r).sum(-1) <= chi2_threshold)
    return T, inliers


# --------------------------------------------------------------------------
# matching and triangulation
# --------------------------------------------------------------------------
def hamming(d1, d2):
    """[K1, K2] int32 Hamming distances of packed int32 words."""
    shifts = torch.arange(32, dtype=torch.int32, device=d1.device)

    def pm1(d):
        bits = (d[:, :, None] >> shifts) & 1
        return (bits.reshape(d.shape[0], -1) * 2 - 1).to(torch.float32)

    n_bits = d1.shape[1] * 32
    return ((n_bits - pm1(d1) @ pm1(d2).T) * 0.5).round().to(torch.int32)


def match(d1, d2, m1, m2, abs_threshold: int, cross_check: bool):
    """(idx2 [K1], mask [K1]): nearest neighbour a query, first index on
    ties; kept iff mutual (with `cross_check`) and dist < max(2 * min_dist,
    abs_threshold)."""
    D = torch.where(m1[:, None] & m2[None, :], hamming(d1, d2), INVALID_DIST)
    dist, idx2 = torch.min(D, dim=1)
    ok = dist < INVALID_DIST
    if cross_check:
        back = torch.argmin(D, dim=0)
        ok = ok & (back[idx2] == torch.arange(idx2.shape[0],
                                              device=idx2.device))
    min_dist = torch.where(ok, dist, INVALID_DIST).min()
    gate = torch.clamp(2 * min_dist, min=abs_threshold)
    return idx2, ok & (dist < gate)


def _depth_ok(P1, P2, pts):
    Xh = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    z1 = torch.einsum("j,nj->n", P1[2, :], Xh)
    z2 = torch.einsum("j,nj->n", P2[2, :], Xh)
    return (z1 > 0.1) & (z1 < 500.0) & (z2 > 0.1) & (z2 < 500.0)


def triangulate(P1, P2, uv1, uv2, mask):
    """Inhomogeneous two-view DLT (w = 1) through its 3x3 normal equations
    by the adjugate: (points [N, 3], valid [N])."""
    def row(P, coord, idx):
        return coord[..., None] * P[None, 2, :] - P[None, idx, :]

    A = torch.stack([row(P1, uv1[:, 0], 0), row(P1, uv1[:, 1], 1),
                     row(P2, uv2[:, 0], 0), row(P2, uv2[:, 1], 1)], dim=-2)
    M, b = A[..., :3], -A[..., 3]
    G = torch.einsum("nki,nkj->nij", M, M)
    h = torch.einsum("nki,nk->ni", M, b)
    g00, g01, g02 = G[:, 0, 0], G[:, 0, 1], G[:, 0, 2]
    g11, g12, g22 = G[:, 1, 1], G[:, 1, 2], G[:, 2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    finite = det.abs() > 1e-12
    ds = torch.where(finite, det, 1.0)
    h0, h1, h2 = h[:, 0], h[:, 1], h[:, 2]
    pts = torch.stack([(c00 * h0 + c01 * h1 + c02 * h2) / ds,
                       (c01 * h0 + c11 * h1 + c12 * h2) / ds,
                       (c02 * h0 + c12 * h1 + c22 * h2) / ds], dim=-1)
    return pts, mask & finite & _depth_ok(P1, P2, pts)


def center(T):
    return -T[:3, :3].T @ T[:3, 3]


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
INPUT_KEYS = ("kf_img", "img", "prev_img", "track_uv", "anchor_uv",
              "track_mask", "lm_pos", "pose", "rel", "kf_desc", "kf_uv",
              "kf_mask", "kf_pose", "kf_ref", "fsk", "slot_stamp",
              "frame_no", "cap_left")


def track(x: dict, cfg: dict, cam, low: bool = False) -> dict:
    """Extraction, LK and pose GN on the inputs `x` (keys INPUT_KEYS)
    under the configuration `cfg` (its `features` and `tracking`
    sections); `cam` = (fx, fy, cx, cy)."""
    fc, tc = cfg["features"], cfg["tracking"]
    kp_uv, kp_mask, desc = extract.extract(
        x["img"], fc, torch.bfloat16 if low else torch.float32)
    pose, rel, lm_pos = x["pose"], x["rel"], x["lm_pos"]
    track_uv, anchor_uv, track_mask = (x["track_uv"], x["anchor_uv"],
                                       x["track_mask"])

    # LK's inputs at the constant-velocity prior rel @ pose
    seed, z = project(cam, lie.transform_points(rel @ pose, lm_pos))
    if tc["lk_template"] == "prev":
        seed_prev, z_prev = project(cam, lie.transform_points(pose, lm_pos))
        use = track_mask & (z > 0.25) & (z_prev > 0.25)
        seed = torch.where(use[:, None], track_uv + (seed - seed_prev),
                           track_uv)
        tmpl_img, tmpl_uv = x["prev_img"], track_uv
    else:
        use = track_mask & (z > 0.25)
        seed = torch.where(use[:, None], seed, anchor_uv)
        tmpl_img, tmpl_uv = x["kf_img"], anchor_uv
    flow_uv, flow_ok = lk_track(tmpl_img, x["img"], tmpl_uv, seed, use, tc,
                                low)
    T, inlier = solve_pose(
        rel @ pose, lm_pos, flow_uv, flow_ok, cam,
        iters=tc["gn_rounds"] * tc["gn_iters_per_round"],
        huber_delta=tc["huber_delta"], chi2_threshold=tc["chi2_threshold"])
    return dict(kp_uv=kp_uv, kp_mask=kp_mask, desc=desc, use=use,
                flow_uv=flow_uv, flow_ok=flow_ok, n_flow=flow_ok.sum(),
                pose=T, inlier=inlier, n_ba=inlier.sum(),
                keep=flow_ok & inlier)


def replenish(x: dict, cfg: dict, cam, up: dict) -> dict:
    """Matching against the anchor keyframe, triangulation, the depth
    gate, the keyframe decision and the merged track table, on the
    upstream stages' outputs `up` (`track`'s keys kp_uv, kp_mask, desc,
    flow_uv, n_flow, pose, n_ba, keep; `flow_uv` read on kept slots
    only)."""
    fc, mc, tc = cfg["features"], cfg["matching"], cfg["tracking"]
    K_cap = fc["max_keypoints"]
    T, keep, n_ba, n_flow = up["pose"], up["keep"], up["n_ba"], up["n_flow"]
    kp_uv = up["kp_uv"]
    anchor_uv = x["anchor_uv"]
    new_track_uv = torch.where(keep[:, None], up["flow_uv"], anchor_uv)
    idx2, m_mask = match(x["kf_desc"], up["desc"], x["kf_mask"],
                         up["kp_mask"], mc["abs_threshold"],
                         mc["cross_check"])
    r_uv2 = kp_uv[idx2]
    d2 = ((r_uv2[:, None, :] - new_track_uv[None, :, :]) ** 2).sum(-1)
    near = ((d2 < 144.0) & keep[None, :]).any(1)
    Kt = K_matrix(cam, T.device)
    kf_pose = x["kf_pose"]
    r_pts, r_valid = triangulate(Kt @ kf_pose[:3, :4], Kt @ T[:3, :4],
                                 x["kf_uv"], r_uv2, m_mask & ~near)
    c_kf, c_now = center(kf_pose), center(T)
    ratio = tc["max_depth_baseline_ratio"]
    if ratio > 0:
        z_cur = lie.transform_points(T, r_pts)[:, 2]
        r_valid = r_valid & (z_cur < ratio * torch.linalg.norm(c_now - c_kf))
    n_matches = m_mask.sum()

    # keyframe decision
    n_valid_new = r_valid.sum()
    n_new = torch.minimum(n_valid_new, K_cap - keep.sum()).clamp(
        max=x["cap_left"])
    floor = tc["min_ba_inliers"] + max(20, tc["min_ba_inliers"] // 5)
    want = n_ba < torch.clamp(
        (tc["keyframe_min_inlier_ratio"] * x["kf_ref"]).to(torch.int64),
        min=floor)
    if tc["keyframe_max_translation"] > 0:
        want = want | (torch.linalg.norm(c_now - c_kf)
                       > tc["keyframe_max_translation"])
    if tc["keyframe_max_rotation_deg"] > 0:
        R_rel = T[:3, :3] @ kf_pose[:3, :3].T
        cos_r = torch.clamp((torch.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0)
        want = want | (torch.rad2deg(torch.arccos(cos_r))
                       > tc["keyframe_max_rotation_deg"])
    want = want & ((n_ba < floor) | (x["fsk"] + 1 >= tc["min_keyframe_gap"]))
    gates = (n_flow >= tc["min_flow_inliers"]) & (n_ba >= tc["min_ba_inliers"])
    is_kf = want & gates & (n_matches >= 8) & (n_valid_new >= 4) & (n_new > 0)

    # the merged table: kept slots stay, new points fill free slots in order
    dest = torch.argsort(keep.to(torch.int32), stable=True)
    src = torch.argsort((~r_valid).to(torch.int32), stable=True)
    write = torch.arange(K_cap, device=keep.device) < n_new
    anchor_kf = new_track_uv.index_put((dest,), torch.where(
        write[:, None], r_uv2[src], new_track_uv[dest]))
    valid_kf = keep.index_put((dest,), keep[dest] | write)
    return dict(n_matches=n_matches, n_new=n_new, is_kf=is_kf, dest=dest,
                src=src, r_pts=r_pts, r_valid=r_valid,
                anchor=torch.where(is_kf, anchor_kf, anchor_uv),
                valid=torch.where(is_kf, valid_kf, keep))


def step(x: dict, cfg: dict, cam, low: bool = False) -> dict:
    """The whole step: `track`, then `replenish` on its outputs."""
    up = track(x, cfg, cam, low)
    return dict(up, **replenish(x, cfg, cam, up))
