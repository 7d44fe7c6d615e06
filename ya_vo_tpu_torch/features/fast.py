"""FAST-12 corner detection with Harris ranking, NMS and top-K.

Port of `ya_vo_tpu/features/fast.py`. `detect` is two steps of
`fast_cuda`, each a kernel on the card and its plain version on the CPU:
- on the card, `fast_candidates` reads the uint8 frame and writes the
  candidates (segment test + Harris + NMS, inside the border) with their
  count on the card, and `select_top_k` ranks them into the K keypoint
  slots: two launches and no host sync;
- on the CPU, the plain score map (composed from `fast_response`,
  `harris_response` and `_nms`) lists its candidates, and a stable sort of
  the map with -inf off the candidates gives the slots.
Both give the same `Keypoints` in every slot, masked ones included. Every
stage reads zeros outside the image (the JAX paths wrap with rolls instead);
the two differ only within 8 px of the edge, which the detection border
masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ya_vo_tpu_torch.features import fast_cuda


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (masked arrays)."""

    uv: torch.Tensor      # [K, 2] float32 (u=col, v=row)
    score: torch.Tensor   # [K] float32 Harris response
    mask: torch.Tensor    # [K] bool valid entries

    def count(self) -> torch.Tensor:
        return self.mask.sum()


def detect(
    img: torch.Tensor,
    *,
    max_keypoints: int = 2048,
    threshold: int = 40,
    arc_length: int = 12,
    nms_radius: int = 3,
    border: int = 16,
    harris_k: float = 0.04,
) -> Keypoints:
    """FAST + Harris detection on a uint8 [H, W] image: candidates (segment
    test, Harris, NMS, border mask) -> top-K by score, ties broken by the
    lower flat index (the order `lax.top_k` gives)."""
    H, W = img.shape
    cand = fast_cuda.fast_candidates(
        img.contiguous(), threshold=float(threshold), arc_length=arc_length,
        harris_k=harris_k, nms_radius=nms_radius, border=border)
    uv, score, mask = fast_cuda.select_top_k(*cand, H=H, W=W,
                                             k=max_keypoints)
    return Keypoints(uv=uv, score=score, mask=mask)
