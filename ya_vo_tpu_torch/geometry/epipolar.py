"""Two-view epipolar geometry: normalized 8-point F, Sampson error, E and
its decomposition. Port of `ya_vo_tpu/geometry/epipolar.py`, batched over
leading axes, float32. Eigenvector and SVD signs may differ from the JAX
module's: F is defined up to sign, and the four (R, t) candidates are the
same set.

The null vector of the 8-point system's float32 AᵀA comes from LAPACK's
float32 eigh on the CPU, the solver the JAX package runs there (the CPU
tests hold the bootstrap to JAX's). On the card, float32 eigh is
cuSOLVER's, and RANSAC's choice of hypothesis and its refit follow every
rounding of it: on the textured world's first frame pair its bootstrap
translation sat 0.03 from a float64 solve (LAPACK float32: 0.0006), a bent
initial map that tracking never recovered from (13 resets in 410 frames).
So the card solves the null vector in float64.
"""

from __future__ import annotations

import math

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization of the masked points.
    Returns (pts_norm [..., N, 2], T [..., 3, 3])."""
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    dist = torch.linalg.norm(centered, dim=-1)
    mean_dist = dist.sum(-1, keepdim=True) / n
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-8)
    pts_norm = centered * scale[..., None]
    s = scale[..., 0]
    mu, mv = mean[..., 0, 0], mean[..., 0, 1]
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zeros, -s * mu], dim=-1),
        torch.stack([zeros, s, -s * mv], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return pts_norm, T


def _null_vector(M: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric M [..., n, n]:
    float32 LAPACK on the CPU, float64 on the card (module docstring)."""
    if M.is_cuda:
        return torch.linalg.eigh(M.double())[1][..., :, 0].to(M.dtype)
    return torch.linalg.eigh(M)[1][..., :, 0]


def eight_point(pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor):
    """Normalized 8-point F [..., 3, 3]: rank 2, denormalized, unit norm."""
    p1n, T1 = normalize_points(pts1, mask)
    p2n, T2 = normalize_points(pts2, mask)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    A = A * mask[..., None].to(A.dtype)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    f = _null_vector(AtA)
    Fm = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vh = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fm = U @ (S[..., :, None] * Vh)
    Fm = T2.transpose(-1, -2) @ Fm @ T1
    norm = torch.linalg.norm(Fm.reshape(Fm.shape[:-2] + (9,)), dim=-1)
    return Fm / torch.clamp(norm, min=1e-12)[..., None, None]


def epipolar_error(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor):
    """Algebraic error |x2^T F x1| per correspondence [..., N]."""
    Fx1 = torch.einsum("...ij,...nj->...ni", F, to_homogeneous(pts1))
    return (to_homogeneous(pts2) * Fx1).sum(-1).abs()


def sampson_error(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor):
    """First-order geometric error (squared pixels), [..., N]."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2)
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def essential_from_fundamental(F, K1, K2):
    """E = K2^T F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def decompose_essential(E: torch.Tensor):
    """E -> the 4 candidate (R [..., 4, 3, 3], t [..., 4, 3]) motions."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vh = Vh * torch.where(torch.linalg.det(Vh) < 0, -1.0, 1.0)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t],
                                                              dim=-2)
