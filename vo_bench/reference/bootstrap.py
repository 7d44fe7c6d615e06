"""The plain reference of the two-view bootstrap (the start of a session):
RANSAC over normalized 8-point fundamental matrices, the refit on the best
hypothesis's inliers, E and its four decompositions chosen by cheirality.

A frozen copy, in plain PyTorch, of the port's `geometry/ransac.py`
`estimate_two_view` with `geometry/epipolar.py` and the homogeneous DLT of
`geometry/triangulation.py`; it imports nothing of the program. The
hypotheses come from the same Gumbel top-k draw, replayed from the state
the program's `torch.Generator` had before its call. The 8-point null
vector is solved in float64, as the configuration states; `low=True` (the
control) solves it in float32.
"""

from __future__ import annotations

import math

import torch


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _normalize(pts, mask):
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    mean_dist = torch.linalg.norm(centered, dim=-1).sum(-1, keepdim=True) / n
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-8)
    s = scale[..., 0]
    mu, mv = mean[..., 0, 0], mean[..., 0, 1]
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, zeros, -s * mu], dim=-1),
                     torch.stack([zeros, s, -s * mv], dim=-1),
                     torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    return centered * scale[..., None], T


def eight_point(pts1, pts2, mask, low: bool = False):
    """Normalized 8-point F [..., 3, 3]: rank 2, denormalized, unit norm."""
    p1, T1 = _normalize(pts1, mask)
    p2, T2 = _normalize(pts2, mask)
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1) * mask[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    f = torch.linalg.eigh(AtA if low else AtA.double())[1][..., :, 0]
    Fm = f.to(AtA.dtype).reshape(f.shape[:-1] + (3, 3))
    U, S, Vh = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fm = T2.transpose(-1, -2) @ (U @ (S[..., :, None] * Vh)) @ T1
    norm = torch.linalg.norm(Fm.reshape(Fm.shape[:-2] + (9,)), dim=-1)
    return Fm / torch.clamp(norm, min=1e-12)[..., None, None]


def sampson(F, pts1, pts2):
    """First-order geometric error (squared pixels), [..., N]."""
    x1, x2 = _homogeneous(pts1), _homogeneous(pts2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2)
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _decompose(E):
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vh = Vh * torch.where(torch.linalg.det(Vh) < 0, -1.0, 1.0)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra, Rb = U @ W @ Vh, U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t],
                                                              dim=-2)


def _triangulate(P1, P2, uv1, uv2, mask):
    """Homogeneous DLT (null vector by eigh of A^T A, sigma-ratio gate, depth
    in both views): (points, valid)."""
    def row(P, c, i):
        return c[..., None] * P[..., None, 2, :] - P[..., None, i, :]

    A = torch.stack(torch.broadcast_tensors(
        row(P1, uv1[..., 0], 0), row(P1, uv1[..., 1], 1),
        row(P2, uv2[..., 0], 0), row(P2, uv2[..., 1], 1)), dim=-2)
    vals, vecs = torch.linalg.eigh(torch.einsum("...ki,...kj->...ij", A, A))
    X = vecs[..., :, 0]
    w = X[..., 3]
    pts = X[..., :3] / torch.where(w.abs() < 1e-12, 1e-12, w)[..., None]
    s0 = torch.sqrt(torch.clamp(vals[..., 0], min=0.0))
    s1 = torch.sqrt(torch.clamp(vals[..., 1], min=1e-20))
    Xh = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    z1 = torch.einsum("...j,...nj->...n", P1[..., 2, :], Xh)
    z2 = torch.einsum("...j,...nj->...n", P2[..., 2, :], Xh)
    ok = (z1 > 0.1) & (z1 < 500.0) & (z2 > 0.1) & (z2 < 500.0)
    return pts, mask & ((s0 / s1) < 1e-2) & ok


def two_view(uv1, uv2, mask, K, gen_state, rc: dict, low: bool = False):
    """(R, t, inlier mask) of the bootstrap from matched pixels (x2 = R x1
    + t, |t| = 1). `gen_state` is the CPU generator's state before the
    program's draw; `rc` the configuration's `ransac` section."""
    gen = torch.Generator().manual_seed(0)
    gen.set_state(gen_state)
    n_hyp, k = rc["n_hypotheses"], rc["sample_size"]
    u = torch.rand((n_hyp, mask.shape[0]), generator=gen)
    g = (-torch.log(-torch.log(u.clamp(min=1e-20)))).to(mask.device)
    idx = torch.topk(torch.where(mask[None, :], g, -torch.inf), k,
                     dim=1).indices
    F_h = eight_point(uv1[idx], uv2[idx], torch.ones(idx.shape,
                                                     dtype=torch.bool,
                                                     device=uv1.device), low)
    thr = rc["inlier_threshold_px"] ** 2
    inl = (sampson(F_h, uv1[None], uv2[None]) < thr) & mask[None, :]
    scores = inl.sum(1)
    best = torch.argmax(scores)
    F = eight_point(uv1, uv2, inl[best], low)
    inlier = (sampson(F, uv1, uv2) < thr) & mask
    refit = inlier.sum() >= scores[best]
    F = torch.where(refit, F, F_h[best])
    inlier = torch.where(refit, inlier, inl[best])
    Rs, ts = _decompose(K.transpose(-1, -2) @ F @ K)
    eye34 = torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                       torch.zeros((3, 1), dtype=K.dtype, device=K.device)], 1)
    _, val = _triangulate((K @ eye34)[None],
                          K[None] @ torch.cat([Rs, ts[..., None]], dim=-1),
                          uv1[None], uv2[None], inlier[None])
    win = torch.argmax(val.sum(1))
    return Rs[win], ts[win], inlier
