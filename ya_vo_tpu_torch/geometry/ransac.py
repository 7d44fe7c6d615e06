"""Vectorized RANSAC for the fundamental matrix and two-view pose recovery.

Port of `ya_vo_tpu/geometry/ransac.py`. Hypotheses are drawn by Gumbel
top-k from a `torch.Generator` (the JAX module draws from `jax.random`, whose
bits torch cannot reproduce); tests hand both sides the same indices through
`sample_idx`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.geometry import epipolar
from ya_vo_tpu_torch.geometry.triangulation import triangulate


class TwoViewResult(NamedTuple):
    F: torch.Tensor            # [3, 3] fundamental
    E: torch.Tensor            # [3, 3] essential
    R: torch.Tensor            # [3, 3] rotation cam1->cam2 (x2 = R x1 + t)
    t: torch.Tensor            # [3] unit translation
    inlier_mask: torch.Tensor  # [N] bool epipolar inliers
    n_inliers: torch.Tensor    # [] int64
    points: torch.Tensor       # [N, 3] triangulated points (cam1 frame)
    points_valid: torch.Tensor # [N] bool
    n_cheirality: torch.Tensor # [] int64 votes for the winning candidate


def sample_indices(generator: torch.Generator, n_hyp: int, sample_size: int,
                   mask: torch.Tensor) -> torch.Tensor:
    """[n_hyp, sample_size] indices drawn without replacement from the valid
    entries of `mask` by Gumbel top-k. The noise is drawn on the
    generator's device (the CPU) and moved to `mask`'s."""
    u = torch.rand((n_hyp, mask.shape[0]), generator=generator)
    g = (-torch.log(-torch.log(u.clamp(min=1e-20)))).to(mask.device)
    g = torch.where(mask[None, :], g, -torch.inf)
    return torch.topk(g, sample_size, dim=1).indices


def estimate_two_view(uv1, uv2, mask, K, generator: Optional[torch.Generator]
                      = None, *, n_hypotheses: int = 512,
                      sample_size: int = 8, inlier_threshold_px: float = 1.0,
                      sample_idx: Optional[torch.Tensor] = None
                      ) -> TwoViewResult:
    """Robust two-view geometry from matched pixels uv1, uv2 [N, 2] with
    valid mask [N] and shared intrinsics K [3, 3]. `sample_idx`
    [n_hypotheses, sample_size] replaces the random draw."""
    if sample_idx is None:
        sample_idx = sample_indices(generator, n_hypotheses, sample_size, mask)
    F_h = epipolar.eight_point(uv1[sample_idx], uv2[sample_idx],
                               torch.ones(sample_idx.shape, dtype=torch.bool,
                                          device=uv1.device))
    thr = inlier_threshold_px ** 2   # sampson_error is in squared pixels
    inl = (epipolar.sampson_error(F_h, uv1[None], uv2[None]) < thr) \
        & mask[None, :]
    scores = inl.sum(1)
    best = torch.argmax(scores)

    best_inl = inl[best]
    F = epipolar.eight_point(uv1, uv2, best_inl)
    inlier_mask = (epipolar.sampson_error(F, uv1, uv2) < thr) & mask
    use_refit = inlier_mask.sum() >= scores[best]
    F = torch.where(use_refit, F, F_h[best])
    inlier_mask = torch.where(use_refit, inlier_mask, best_inl)

    E = epipolar.essential_from_fundamental(F, K, K)
    Rs, ts = epipolar.decompose_essential(E)
    eye34 = torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                       torch.zeros((3, 1), dtype=K.dtype, device=K.device)], 1)
    P1 = K @ eye34
    P2 = K[None] @ torch.cat([Rs, ts[..., None]], dim=-1)
    pts_c, val_c = triangulate(P1[None], P2, uv1[None], uv2[None],
                               inlier_mask[None])
    votes = val_c.sum(1)
    win = torch.argmax(votes)
    return TwoViewResult(F=F, E=E, R=Rs[win], t=ts[win],
                         inlier_mask=inlier_mask, n_inliers=inlier_mask.sum(),
                         points=pts_c[win], points_valid=val_c[win],
                         n_cheirality=votes[win])


def relative_pose_to_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) with x2 = R x1 + t  ->  SE(3) T_21 (cam1->cam2) 4x4."""
    return lie.rt_to_mat(R, t)
