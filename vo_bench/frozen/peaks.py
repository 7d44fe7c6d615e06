"""Frozen copy of the port's roofline yardstick (`ya_vo_tpu_torch/
selfcheck.py`): the H100 SXM's published peaks, `bound`, and the work
counts of K2 (`fast_work` and the FAST operation constants) and K3 (bytes
and operations of one Hamming matrix), applied by the per-layer metrics to
the calls a cell made. Held equal to its source by
`vo_bench/tests/test_vo_bench_frozen.py`.
"""

from __future__ import annotations

import torch

from vo_bench.reference import extract

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12

# Operations of the FAST candidates, counted where the frame's data needs
# them: every pixel takes the cardinal pre-test; a pixel that passes it, the
# ring test; a corner, Harris and NMS.
FAST_PRE_OPS = 2 + 8 + 6 + 2 + 1
FAST_RING_OPS = 32 + 32 + 2 * 16
FAST_HARRIS_OPS = 9 * (12 + 3 + 3) + 7


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over the peak."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_work(img, threshold: float, arc_length: int) -> dict:
    """What K2's bound counts on a uint8 frame: pixels, those that pass the
    cardinal pre-test, and segment-test corners."""
    f = img.to(torch.float32)
    t, n = threshold, arc_length
    taps = [extract.shift(f, dv, du)
            for dv, du in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    n_bright = sum((v > f + t).to(torch.int32) for v in taps)
    n_dark = sum((v < f - t).to(torch.int32) for v in taps)
    pre = (n_bright >= n // 4) | (n_dark >= n // 4)
    corner = extract.fast_response(f, t, n)
    return dict(pixels=img.numel(), pretest=int(pre.sum()),
                corners=int(corner.sum()))


def fast_bound_ms(img, fc: dict) -> float:
    """K2's least time on one frame (ms) under the `features` section `fc`:
    the frame read and each candidate's (score, index) written, against
    the operations `fast_work` counts."""
    work = fast_work(img, float(fc["fast_threshold"]), fc["fast_arc_length"])
    H, W = img.shape
    smap = extract.score_map(img, threshold=float(fc["fast_threshold"]),
                             arc_length=fc["fast_arc_length"],
                             harris_k=fc["harris_k"],
                             nms_radius=fc["nms_radius"])
    border = fc["brief_patch_radius"] + fc["blur_ksize"] // 2 + 4
    n = int(((smap > extract.NEG / 2)
             & extract.inside(H, W, border, img.device)).sum())
    nms_ops = (2 * fc["nms_radius"] + 1) ** 2 + 1 + 4
    return bound(img.numel() + 8 * n + 4,
                 work["pixels"] * FAST_PRE_OPS
                 + work["pretest"] * FAST_RING_OPS
                 + work["corners"] * (FAST_HARRIS_OPS + nms_ops),
                 F32_OPS_S)[0]


def hamming_bound_ms(K1: int, K2: int, n_words: int) -> float:
    """K3's least time on one [K1, n_words] x [K2, n_words] matrix (ms):
    both descriptor sets read and the int32 distances written, against
    2 K1 K2 n_bits int8 tensor-core operations."""
    return bound(4 * (K1 + K2) * n_words + 4 * K1 * K2,
                 2 * K1 * K2 * 32 * n_words, INT8_OPS_S)[0]
