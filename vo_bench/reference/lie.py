"""SO(3) / SE(3) operations for the plain reference: a frozen copy of the
port's `core/lie.py` (poses are 4x4 world->camera, tangents `[v, w]`,
left-multiplicative updates). Imports nothing of the program.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a batch of 3-vectors: [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), with Taylor
    branches below theta^2 = 1e-8 (the same split as the JAX module)."""
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a_exact = torch.sin(theta) / theta
    b_exact = (1.0 - torch.cos(theta)) / safe_sq
    c_exact = (theta - torch.sin(theta)) / (safe_sq * theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, a_exact)
    B = torch.where(small, 0.5 - theta_sq / 24.0, b_exact)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, c_exact)
    return A, B, C


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] rotation vector -> [..., 3, 3] matrix."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, [..., 3, 3] -> [..., 3] (stable
    away from theta == pi, like the JAX module)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    theta = torch.arccos(cos_theta)
    A, _, _ = _sinc_coeffs(theta * theta)
    factor = 0.5 / torch.clamp(A, min=1e-6)
    return vee(factor[..., None, None] * (R - R.transpose(-1, -2)))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: [..., 6] tangent (v first, w last) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return rt_to_mat(R, torch.einsum("...ij,...j->...i", V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: [..., 4, 4] -> [..., 6] tangent (v first, w last)."""
    w = so3_log(T[..., :3, :3])
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    V = _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * W2
    # solve_ex: no error check, which would read the card back to the host
    v = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]
    return torch.cat([v, w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] transforms from R [..., 3, 3] and t [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: no copy from the host
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(
        batch + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 4, 4] rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for batched 4x4 transforms."""
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3] (or [..., 3]) -> same shape."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.dim() == T.dim():  # [..., N, 3] against T [..., 4, 4]
        return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
    return torch.einsum("...ij,...j->...i", R, pts) + t


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)
