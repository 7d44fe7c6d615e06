"""Pinhole camera model on torch tensors.

Port of `ya_vo_tpu/core/camera.py`. Pixel coordinates are `uv = (column,
row)` float32 and images are indexed `img[v, u]`. The intrinsics are held as
Python floats rounded to float32 (the JAX module's `Camera.create` stores
float32 numpy scalars), so host consumers and tensor code see the same
values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "Camera":
        return Camera(*(float(np.float32(x)) for x in (fx, fy, cx, cy)))

    def K(self, device=None) -> torch.Tensor:
        """3x3 float32 intrinsic matrix on `device`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
             [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)

    def project(self, pts_cam: torch.Tensor, eps: float = 1e-6):
        """Camera-frame points [..., 3] -> pixel uv [..., 2] and depth [...]."""
        z = pts_cam[..., 2]
        z_safe = torch.where(z.abs() < eps,
                             torch.where(z < 0, -eps, eps).to(z.dtype), z)
        u = self.fx * pts_cam[..., 0] / z_safe + self.cx
        v = self.fy * pts_cam[..., 1] / z_safe + self.cy
        return torch.stack([u, v], dim=-1), z

    def unproject(self, uv: torch.Tensor, depth=None) -> torch.Tensor:
        """Pixels [..., 2] (+ optional depth [...]) -> camera-frame points
        (normalized plane z = 1 when depth is None)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return rays if depth is None else rays * depth[..., None]

    def projection_matrix(self, T_wc: torch.Tensor) -> torch.Tensor:
        """P = K [R|t] for world->camera poses [..., 4, 4] -> [..., 3, 4]."""
        return self.K(T_wc.device) @ T_wc[..., :3, :4]


def in_bounds(uv: torch.Tensor, height: int, width: int, margin: int = 0):
    """Boolean mask [...,] of pixels at least `margin` inside the image."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= width - 1 - margin)
            & (v >= margin) & (v <= height - 1 - margin))
