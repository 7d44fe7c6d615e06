"""Plain extraction for the reference: FAST-12 segment test, Harris ranking,
NMS, top-K, the 9x9 Gaussian blur and BRIEF-256.

A frozen copy of the plain versions in the port (`features/fast_cuda.py`'s
`fast_response`, `harris_response`, `_nms`, `fast_candidates_plain`,
`select_top_k_plain`; `features/brief.py`), in plain PyTorch, importing
nothing of the program. `dtype` is the arithmetic of the score map and the
blur: float32 as the configuration states, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = -3.0e38

# the radius-3 Bresenham circle, clockwise from 12 o'clock, as (dv, du)
BRESENHAM_OFFSETS = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
     (-3, -1)], dtype=np.int32)


def shift(img: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """out[v, u] = img[v + dv, u + du], zero outside the image."""
    H, W = img.shape
    p = F.pad(img, (abs(du), abs(du), abs(dv), abs(dv)))
    return p[abs(dv) + dv: abs(dv) + dv + H, abs(du) + du: abs(du) + du + W]


def _rot16(b: torch.Tensor, s: int) -> torch.Tensor:
    s %= 16
    return b if s == 0 else ((b >> s) | (b << (16 - s))) & 0xFFFF


def _has_run(b: torch.Tensor, n: int) -> torch.Tensor:
    """True where the cyclic 16-bit field holds >= n contiguous set bits."""
    r, covered = b, 1
    while covered < n:
        s = min(covered, n - covered)
        r = r & _rot16(r, s)
        covered += s
    return r != 0


def fast_response(img: torch.Tensor, threshold: float,
                  arc_length: int) -> torch.Tensor:
    """Segment test: >= `arc_length` contiguous ring pixels all brighter
    than center + t or all darker than center - t."""
    hi, lo = img + threshold, img - threshold
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for ridx, (dv, du) in enumerate(BRESENHAM_OFFSETS):
        ring = shift(img, int(dv), int(du))
        bright |= (ring > hi).to(torch.int32) << ridx
        dark |= (ring < lo).to(torch.int32) << ridx
    return _has_run(bright, arc_length) | _has_run(dark, arc_length)


def _box3(a: torch.Tensor) -> torch.Tensor:
    s = shift(a, -1, 0) + a + shift(a, 1, 0)
    return shift(s, 0, -1) + s + shift(s, 0, 1)


def harris_response(img: torch.Tensor, k: float) -> torch.Tensor:
    """det(M) - k trace(M)^2 from 3x3 Sobel gradients and a 3x3 box."""
    def sh(dv, du):
        return shift(img, dv, du)

    gx = (sh(-1, 1) + 2.0 * sh(0, 1) + sh(1, 1)) \
        - (sh(-1, -1) + 2.0 * sh(0, -1) + sh(1, -1))
    gy = (sh(1, -1) + 2.0 * sh(1, 0) + sh(1, 1)) \
        - (sh(-1, -1) + 2.0 * sh(-1, 0) + sh(-1, 1))
    sxx, syy, sxy = _box3(gx * gx), _box3(gy * gy), _box3(gx * gy)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


def score_map(img_u8: torch.Tensor, *, threshold: float, arc_length: int,
              harris_k: float, nms_radius: int,
              dtype=torch.float32) -> torch.Tensor:
    """float32 [H, W]: the Harris score where a pixel passes the segment
    test and is the maximum of its NMS window, else NEG."""
    f = img_u8.to(dtype)
    corner = fast_response(f, threshold, arc_length)
    score = torch.where(corner, harris_response(f, harris_k).float(), NEG)
    if nms_radius > 0:
        local_max = F.max_pool2d(score[None, None], 2 * nms_radius + 1,
                                 stride=1, padding=nms_radius)[0, 0]
        score = torch.where(score >= local_max, score, NEG)
    return score


def inside(H: int, W: int, border: int, device) -> torch.Tensor:
    vv = torch.arange(H, device=device)[:, None]
    uu = torch.arange(W, device=device)[None, :]
    return (vv >= border) & (vv < H - border) & (uu >= border) \
        & (uu < W - border)


def detect(img_u8: torch.Tensor, *, max_keypoints: int, threshold: float,
           arc_length: int, nms_radius: int, border: int, harris_k: float,
           dtype=torch.float32):
    """(uv [K, 2] float32, mask [K] bool): the top K candidates by score,
    ties to the lower flat index; the slots past the candidates hold the
    lowest indices that are not candidates, masked."""
    H, W = img_u8.shape
    smap = score_map(img_u8, threshold=threshold, arc_length=arc_length,
                     harris_k=harris_k, nms_radius=nms_radius, dtype=dtype)
    keep = (smap > NEG / 2) & inside(H, W, border, img_u8.device)
    flat = torch.where(keep, smap, -torch.inf).reshape(-1)
    top, order = torch.sort(flat, descending=True, stable=True)
    top, order = top[:max_keypoints], order[:max_keypoints]
    uv = torch.stack([order % W, order // W], dim=-1).to(torch.float32)
    return uv, torch.isfinite(top)


def make_offsets(n_bits: int, patch_radius: int, seed: int) -> np.ndarray:
    """BRIEF's seeded test table [n_bits, 4] = (du1, dv1, du2, dv2)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-patch_radius, patch_radius + 1,
                        size=(n_bits, 4)).astype(np.int32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur (zero padding) as ksize shifted multiply-adds
    a pass, vertical first, in the dtype of `img`."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    half = ksize // 2
    H, W = img.shape
    p = F.pad(img, (0, 0, half, half))
    out = k[0] * p[0:H, :]
    for i in range(1, ksize):
        out = out + k[i] * p[i:i + H, :]
    p = F.pad(out, (half, half))
    out = k[0] * p[:, 0:W]
    for i in range(1, ksize):
        out = out + k[i] * p[:, i:i + W]
    return out


def describe(blurred: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """[K, n_bits / 32] int32 words holding the uint32 bit patterns; bit b
    of a keypoint is blurred[p1] < blurred[p2] of test b; masked rows 0."""
    H, W = blurred.shape
    K, B = uv.shape[0], offsets.shape[0]
    u = uv[:, 0].to(torch.int64).clamp(0, W - 1)[:, None]
    v = uv[:, 1].to(torch.int64).clamp(0, H - 1)[:, None]

    def sample(du, dv):
        return blurred[(v + dv[None]).clamp(0, H - 1),
                       (u + du[None]).clamp(0, W - 1)]

    bits = sample(offsets[:, 0], offsets[:, 1]) \
        < sample(offsets[:, 2], offsets[:, 3])
    words = (bits.to(torch.int64).reshape(K, B // 32, 32)
             << torch.arange(32, device=uv.device)).sum(-1)
    desc = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return torch.where(mask[:, None], desc.to(torch.int32), 0)


def extract(img_u8: torch.Tensor, fc: dict, dtype=torch.float32):
    """(uv, mask, desc) of a frame under the `features` section `fc` of a
    configuration (the program's border: BRIEF's patch plus the blur's
    half-width plus 4)."""
    uv, mask = detect(
        img_u8, max_keypoints=fc["max_keypoints"],
        threshold=float(fc["fast_threshold"]),
        arc_length=fc["fast_arc_length"], nms_radius=fc["nms_radius"],
        border=fc["brief_patch_radius"] + fc["blur_ksize"] // 2 + 4,
        harris_k=fc["harris_k"], dtype=dtype)
    blurred = gaussian_blur(img_u8.to(dtype), fc["blur_ksize"],
                            fc["blur_sigma"])
    offs = torch.as_tensor(make_offsets(fc["brief_n_bits"],
                                        fc["brief_patch_radius"],
                                        fc["brief_seed"]),
                           dtype=torch.int64, device=img_u8.device)
    return uv, mask, describe(blurred, uv, mask, offs)
