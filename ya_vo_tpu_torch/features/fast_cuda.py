"""FAST-12 + Harris + NMS candidates and their top-K: CUDA kernels and plain
versions.

Two kernels, each with its plain PyTorch version here:
- `fast_candidates` (`csrc/fast_score.cu`) replaces the TPU kernel
  `ya_vo_tpu/features/pallas_fast.py:_fast_score_kernel`. It reads the uint8
  frame and writes the candidates, the pixels whose score survives the
  segment test and NMS and that lie `border` px inside the image, as
  (score, flat index) pairs in no particular order, with their count on the
  card. Its plain version, `fast_candidates_plain`, takes the score map of
  `fast_score_map_plain` (composed from the ports of
  `ya_vo_tpu/features/fast.py`'s `fast_response`, `harris_response` and
  `_nms` below) and lists its entries inside the border in index order.
  `fast_score_map` is the map itself: on the card, the kernel at border 0
  scattered into a NEG map.
- `select_top_k` (`csrc/fast_select.cu`) replaces `jax.lax.top_k` at
  `ya_vo_tpu/features/fast.py:193`: the top `k` candidates by score, ties by
  the lower index, as keypoint slots, reading the count on the card. Its
  plain version, `select_top_k_plain`, is a stable sort of the whole score
  map with -inf off the candidates.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ya_vo_tpu_torch import _build

NEG = -3.0e38  # "not a corner" sentinel, below any Harris score
MAX_NMS_RADIUS = 3  # the kernel is instantiated for radii 0 to 3
MAX_SELECT_K = 8192  # keys `fast_select` stages in shared memory (CHUNK)


# The radius-3 Bresenham circle, clockwise from 12 o'clock, as (dv, du).
BRESENHAM_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _shift(img: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """out[v, u] = img[v + dv, u + du], zero outside the image."""
    H, W = img.shape
    p = F.pad(img, (abs(du), abs(du), abs(dv), abs(dv)))
    return p[abs(dv) + dv: abs(dv) + dv + H, abs(du) + du: abs(du) + du + W]


def _rot16(b: torch.Tensor, s: int) -> torch.Tensor:
    """Cyclic rotate of a 16-bit ring bitfield: bit i <- bit (i + s) % 16."""
    s %= 16
    return b if s == 0 else ((b >> s) | (b << (16 - s))) & 0xFFFF


def _has_run(b: torch.Tensor, n: int) -> torch.Tensor:
    """True where the cyclic 16-bit field holds >= n contiguous set bits
    (log-doubling rotate-AND)."""
    r, covered = b, 1
    while covered < n:
        s = min(covered, n - covered)
        r = r & _rot16(r, s)
        covered += s
    return r != 0


def fast_response(img_f32: torch.Tensor, threshold: float,
                  arc_length: int) -> torch.Tensor:
    """Segment test: bool [H, W], >= `arc_length` contiguous ring pixels all
    brighter than center + t or all darker than center - t."""
    hi = img_f32 + threshold
    lo = img_f32 - threshold
    bright = torch.zeros(img_f32.shape, dtype=torch.int32,
                         device=img_f32.device)
    dark = torch.zeros_like(bright)
    for ridx, (dv, du) in enumerate(BRESENHAM_OFFSETS):
        ring = _shift(img_f32, int(dv), int(du))
        bright |= (ring > hi).to(torch.int32) << ridx
        dark |= (ring < lo).to(torch.int32) << ridx
    return _has_run(bright, arc_length) | _has_run(dark, arc_length)


def _box3(a: torch.Tensor) -> torch.Tensor:
    """3x3 box sum, vertical pass first."""
    s = _shift(a, -1, 0) + a + _shift(a, 1, 0)
    return _shift(s, 0, -1) + s + _shift(s, 0, 1)


def harris_response(img_f32: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """R = det(M) - k trace(M)^2 from 3x3 Sobel gradients and a 3x3 box."""
    def sh(dv, du):
        return _shift(img_f32, dv, du)

    gx = (sh(-1, 1) + 2.0 * sh(0, 1) + sh(1, 1)) \
        - (sh(-1, -1) + 2.0 * sh(0, -1) + sh(1, -1))
    gy = (sh(1, -1) + 2.0 * sh(1, 0) + sh(1, 1)) \
        - (sh(-1, -1) + 2.0 * sh(-1, 0) + sh(-1, 1))
    sxx = _box3(gx * gx)
    syy = _box3(gy * gy)
    sxy = _box3(gx * gy)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


def _nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep local maxima within a (2r+1)^2 window (outside counts as -inf)."""
    if radius <= 0:
        return torch.ones_like(score, dtype=torch.bool)
    local_max = F.max_pool2d(score[None, None], 2 * radius + 1, stride=1,
                             padding=radius)[0, 0]
    return score >= local_max


def fast_score_map_plain(img_f32: torch.Tensor, *, threshold: float,
                         arc_length: int, harris_k: float,
                         nms_radius: int) -> torch.Tensor:
    """[H, W] f32 -> [H, W] f32: the Harris score where a pixel passes the
    segment test and is the maximum of its NMS window, else NEG."""
    corner = fast_response(img_f32, threshold, arc_length)
    score = torch.where(corner, harris_response(img_f32, harris_k), NEG)
    return torch.where(_nms(score, nms_radius), score, NEG)


class Candidates(NamedTuple):
    """FAST candidates: (score, flat index) in `score[:n]`, `idx[:n]`, where
    n is `count[0]`. The kernel's arrays hold H*W entries (NMS plateaus can
    keep every pixel) and its count stays on the card."""

    score: torch.Tensor   # [cap] float32 Harris score
    idx: torch.Tensor     # [cap] int32 flat index v * W + u
    count: torch.Tensor   # [1] int32


def _inside(H: int, W: int, border: int, device) -> torch.Tensor:
    vv = torch.arange(H, device=device)[:, None]
    uu = torch.arange(W, device=device)[None, :]
    return (vv >= border) & (vv < H - border) & (uu >= border) \
        & (uu < W - border)


def fast_candidates_plain(img: torch.Tensor, *, threshold: float,
                          arc_length: int, harris_k: float, nms_radius: int,
                          border: int) -> Candidates:
    """The non-NEG entries of the plain score map that lie `border` px or
    more inside the image, in flat-index order."""
    H, W = img.shape
    smap = fast_score_map_plain(
        img.to(torch.float32), threshold=threshold, arc_length=arc_length,
        harris_k=harris_k, nms_radius=nms_radius)
    keep = (smap > NEG / 2) & _inside(H, W, border, img.device)
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    count = torch.tensor([idx.numel()], dtype=torch.int32, device=img.device)
    return Candidates(smap.reshape(-1)[idx], idx.to(torch.int32), count)


def fast_candidates(img: torch.Tensor, *, threshold: float, arc_length: int,
                    harris_k: float, nms_radius: int,
                    border: int) -> Candidates:
    """Candidates of `fast_candidates_plain`, by the CUDA kernel on the card
    from the uint8 frame (in no particular order, count on the card)."""
    if img.device.type == "cpu":
        return fast_candidates_plain(
            img, threshold=threshold, arc_length=arc_length,
            harris_k=harris_k, nms_radius=nms_radius, border=border)
    _build.check_cuda("fast_candidates", img, torch.uint8, (None, None))
    if not 0 <= nms_radius <= MAX_NMS_RADIUS:
        raise ValueError(f"nms_radius {nms_radius} outside "
                         f"[0, {MAX_NMS_RADIUS}]")
    if not 1 <= arc_length <= 16:
        raise ValueError(f"arc_length {arc_length} outside [1, 16]")
    if border < 0:
        raise ValueError(f"border {border} < 0")
    if img.data_ptr() % 4:
        raise ValueError("fast_candidates: the frame must start on a 4-byte "
                         "boundary (the kernel stages aligned words)")
    H, W = img.shape
    dev = img.device
    cand = Candidates(torch.empty(H * W, dtype=torch.float32, device=dev),
                      torch.empty(H * W, dtype=torch.int32, device=dev),
                      torch.empty(1, dtype=torch.int32, device=dev))
    _build.launch("fast_score", img.data_ptr(), cand.score.data_ptr(),
                  cand.idx.data_ptr(), cand.count.data_ptr(), H, W,
                  float(threshold), int(arc_length), float(harris_k),
                  int(nms_radius), int(border))
    return cand


def fast_score_map(img: torch.Tensor, *, threshold: float, arc_length: int,
                   harris_k: float, nms_radius: int) -> torch.Tensor:
    """Score map of `fast_score_map_plain`; on the card, the kernel's
    candidates at border 0 scattered into a NEG map (uint8 frame; waits for
    the count)."""
    if img.device.type == "cpu":
        return fast_score_map_plain(
            img.to(torch.float32), threshold=threshold,
            arc_length=arc_length, harris_k=harris_k, nms_radius=nms_radius)
    H, W = img.shape
    cand = fast_candidates(img, threshold=threshold, arc_length=arc_length,
                           harris_k=harris_k, nms_radius=nms_radius, border=0)
    n = int(cand.count)
    out = torch.full((H * W,), NEG, dtype=torch.float32, device=img.device)
    out[cand.idx[:n].long()] = cand.score[:n]
    return out.reshape(H, W)


def select_top_k_plain(score: torch.Tensor, idx: torch.Tensor,
                       count: torch.Tensor, *, H: int, W: int, k: int):
    """(uv [k, 2] f32, score [k] f32, mask [k] bool) of the top `k`
    candidates: a stable sort of the H*W map that holds the candidates'
    scores and -inf elsewhere, so ties go to the lower index and the slots
    past the count hold score 0, mask false and the lowest indices that are
    not candidates."""
    n = int(count.reshape(-1)[0])
    flat = torch.full((H * W,), -torch.inf, dtype=torch.float32,
                      device=score.device)
    flat[idx[:n].long()] = score[:n]
    top, order = torch.sort(flat, descending=True, stable=True)
    top, order = top[:k], order[:k]
    mask = torch.isfinite(top)
    uv = torch.stack([order % W, order // W], dim=-1).to(torch.float32)
    return uv, torch.where(mask, top, 0.0), mask


def select_top_k(score: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
                 *, H: int, W: int, k: int):
    """`select_top_k_plain`'s slots, by the CUDA kernel on the card, which
    reads the count there (no host sync)."""
    if score.device.type == "cpu":
        return select_top_k_plain(score, idx, count, H=H, W=W, k=k)
    _build.check_cuda("select_top_k", score, torch.float32, (None,))
    _build.check_cuda("select_top_k", idx, torch.int32, (score.shape[0],))
    _build.check_cuda("select_top_k", count, torch.int32, (1,))
    if not 1 <= k <= min(MAX_SELECT_K, H * W):
        raise ValueError(f"k {k} outside [1, {min(MAX_SELECT_K, H * W)}]")
    dev = score.device
    uv = torch.empty((k, 2), dtype=torch.float32, device=dev)
    top = torch.empty(k, dtype=torch.float32, device=dev)
    mask = torch.empty(k, dtype=torch.bool, device=dev)
    _build.launch("fast_select", score.data_ptr(), idx.data_ptr(),
                  count.data_ptr(), int(k), int(W), uv.data_ptr(),
                  top.data_ptr(), mask.data_ptr())
    return uv, top, mask
