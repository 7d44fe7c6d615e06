"""Batched two-view DLT triangulation.

Port of `ya_vo_tpu/geometry/triangulation.py`: `triangulate` (null vector by
eigh of A^T A, sigma-ratio quality gate; used by the bootstrap) and
`triangulate_fast` (w = 1 normal equations by Cramer's rule; the tracking
step's hot path). All in float32.
"""

from __future__ import annotations

import torch


def _dlt_rows(P1, P2, uv1, uv2) -> torch.Tensor:
    """A [..., N, 4, 4] with rows u*P[2]-P[0], v*P[2]-P[1] per view."""
    def row(P, coord, idx):
        return coord[..., None] * P[..., None, 2, :] - P[..., None, idx, :]

    rows = torch.broadcast_tensors(
        row(P1, uv1[..., 0], 0), row(P1, uv1[..., 1], 1),
        row(P2, uv2[..., 0], 0), row(P2, uv2[..., 1], 1))
    return torch.stack(rows, dim=-2)


def _depth_ok(P1, P2, pts, min_depth, max_depth) -> torch.Tensor:
    Xh = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    z1 = torch.einsum("...j,...nj->...n", P1[..., 2, :], Xh)
    z2 = torch.einsum("...j,...nj->...n", P2[..., 2, :], Xh)
    return ((z1 > min_depth) & (z1 < max_depth)
            & (z2 > min_depth) & (z2 < max_depth))


def triangulate(P1, P2, uv1, uv2, mask, quality_ratio: float = 1e-2,
                min_depth: float = 0.1, max_depth: float = 500.0):
    """Homogeneous DLT. Returns (points [..., N, 3], valid [..., N]): input
    mask AND sigma0/sigma1 < quality_ratio AND depth in range in both views."""
    A = _dlt_rows(P1, P2, uv1, uv2)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    eigvals, eigvecs = torch.linalg.eigh(AtA)   # ascending
    X = eigvecs[..., :, 0]
    w = X[..., 3]
    w_safe = torch.where(w.abs() < 1e-12, 1e-12, w)
    pts = X[..., :3] / w_safe[..., None]
    sigma0 = torch.sqrt(torch.clamp(eigvals[..., 0], min=0.0))
    sigma1 = torch.sqrt(torch.clamp(eigvals[..., 1], min=1e-20))
    valid = mask & ((sigma0 / sigma1) < quality_ratio) \
        & _depth_ok(P1, P2, pts, min_depth, max_depth)
    return pts, valid


def triangulate_fast(P1, P2, uv1, uv2, mask, min_depth: float = 0.1,
                     max_depth: float = 500.0):
    """Inhomogeneous DLT with w = 1: A[:, :3] X = -A[:, 3] through 3x3
    normal equations and the adjugate. Returns (points, valid)."""
    A = _dlt_rows(P1, P2, uv1, uv2)
    M = A[..., :3]
    b = -A[..., 3]
    G = torch.einsum("...ki,...kj->...ij", M, M)
    h = torch.einsum("...ki,...k->...i", M, b)
    g00, g01, g02 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    g11, g12, g22 = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    finite = det.abs() > 1e-12
    det_safe = torch.where(finite, det, 1.0)
    h0, h1, h2 = h[..., 0], h[..., 1], h[..., 2]
    pts = torch.stack([
        (c00 * h0 + c01 * h1 + c02 * h2) / det_safe,
        (c01 * h0 + c11 * h1 + c12 * h2) / det_safe,
        (c02 * h0 + c12 * h1 + c22 * h2) / det_safe,
    ], dim=-1)
    return pts, mask & finite & _depth_ok(P1, P2, pts, min_depth, max_depth)


def reprojection_errors(P, pts_w, uv) -> torch.Tensor:
    """Pixel reprojection error [..., N] of world points through P
    [..., 3, 4]."""
    Xh = torch.cat([pts_w, torch.ones_like(pts_w[..., :1])], dim=-1)
    proj = torch.einsum("...ij,...nj->...ni", P, Xh)
    z = torch.where(proj[..., 2].abs() < 1e-9, 1e-9, proj[..., 2])
    return torch.linalg.norm(proj[..., :2] / z[..., None] - uv, dim=-1)
