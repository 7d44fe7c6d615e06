"""Brute-force Hamming matching with the reference's distance gate.

Port of `ya_vo_tpu/features/matching.py`. The distance matrix comes from
`hamming_cuda.hamming_matrix` (the CUDA kernel on the card). Argmin ties go
to the first index, as `jnp.argmin` does, which the cross-check and the
`dist < max(2 * min_dist, abs_threshold)` gate depend on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ya_vo_tpu_torch.features import hamming_cuda

INVALID_DIST = 100000


class MatchResult(NamedTuple):
    """For each query keypoint (frame 1), its best train keypoint (frame 2)."""

    idx2: torch.Tensor   # [K1] int64 best match in frame 2 (undefined if !mask)
    dist: torch.Tensor   # [K1] int32 Hamming distance
    mask: torch.Tensor   # [K1] bool match survives all filters

    def count(self) -> torch.Tensor:
        return self.mask.sum()


def hamming_matrix(desc1, desc2, mask1, mask2) -> torch.Tensor:
    """[K1, K2] int32 distances; invalid rows/cols = INVALID_DIST."""
    dist = hamming_cuda.hamming_matrix(desc1, desc2)
    valid = mask1[:, None] & mask2[None, :]
    return torch.where(valid, dist, INVALID_DIST)


def match(desc1, desc2, mask1, mask2, *, abs_threshold: int = 20,
          cross_check: bool = True) -> MatchResult:
    """Nearest neighbour per query; keep iff dist < max(2 * min_dist,
    abs_threshold), optionally requiring the match to be mutual."""
    D = hamming_matrix(desc1, desc2, mask1, mask2)
    dist, idx2 = torch.min(D, dim=1)      # first index on ties
    ok = dist < INVALID_DIST
    if cross_check:
        back = torch.argmin(D, dim=0)
        ok = ok & (back[idx2] == torch.arange(idx2.shape[0],
                                              device=idx2.device))
    min_dist = torch.where(ok, dist, INVALID_DIST).min()
    gate = torch.clamp(2 * min_dist, min=abs_threshold)
    return MatchResult(idx2=idx2, dist=dist, mask=ok & (dist < gate))


def gather_matched_uv(uv1, uv2, result: MatchResult):
    """Return (pts1 [K1,2], pts2 [K1,2], mask [K1]) of matched pixel pairs."""
    return uv1, uv2[result.idx2], result.mask
