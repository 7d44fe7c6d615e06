"""Pyramidal inverse-compositional KLT: the level kernel and the tracker.

Replaces the TPU kernel `ya_vo_tpu/tracking/lk_pallas.py:_lk_level_kernel`
(launched by `_track_level_pallas`, once per level); `track` computes
exactly `lk_pallas.track`'s function. The kernel is `csrc/lk_level.cu`: one
launch per tracker call carries every keypoint through all levels (at most
MAX_LK_LEVELS) and applies the status gate; the same kernel with a one-level
table and raw outputs is `track_level`. A CPU tensor takes the plain
versions (`track_pyramids_plain`, composed from `track_level_plain` and
the torch gate); a CUDA tensor launches the kernel or raises.

Bound on an H100 at the main path's shapes (376x1241, 3 levels, 2048
slots): the levels of both pyramids read once are 4.9 MB (~1.5 us of HBM),
and the iterations the inputs take come to ~0.1 GFLOP (~1.5 us of f32
peak); the kernel is latency-bound on each keypoint's serial chain of
iterations, which the design shortens by sampling from a patch staged in
shared memory and by paying one launch and one tail per call instead of
one per level (PERF.md).

Semantics of one level, per live keypoint (both versions):
  * each level image is zero-padded to Hp = max(32, ceil8(H)) rows and
    Wp = max(256, ceil128(W)) columns;
  * a size x size bilinear window at (u, v) starts at column
    clip(floor(u) - half, 0, Wp - size - 1) (rows alike) with the
    fractional weights of (u, v), so a border window is shifted inwards;
  * the template is a 13x13 window of img0 at uv0, giving the inner 11x11
    T, central-difference gradients, the inverse 2x2 normal matrix,
    min_eig / 121 and std(T);
  * the solve starts at the seed clamped to [6, Wp-8] x [6, Hp-8] and
    iterates while it < iters and the last step >= eps on the zero-mean
    residual, clamping after each step (the last step is kept even when
    it falls below eps);
  * outputs are the position, min_eig, the raw mean |I - T| and std(T);
    dead slots output the seed, 0, 1e9 and 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.tracking.lk import FlowResult, build_pyramid

HALF = 5      # 11x11 window
TMPL = 13     # template window (window + 1 px for gradients)
LO = 6.0      # lower position clamp


def padded_size(H: int, W: int):
    """Level size after the zero padding both versions clamp against."""
    return max(32, -(-H // 8) * 8), max(256, -(-W // 128) * 128)


def _windows(img_p: torch.Tensor, ru: torch.Tensor, rv: torch.Tensor,
             size: int) -> torch.Tensor:
    """[N, size, size] bilinear windows of the padded image around (ru, rv):
    rows blended first, then columns."""
    Hp, Wp = img_p.shape
    half = (size - 1) // 2
    fu, fv = torch.floor(ru), torch.floor(rv)
    au, av = (ru - fu)[:, None, None], (rv - fv)[:, None, None]
    c0 = (fu.to(torch.int64) - half).clamp(0, Wp - size - 1)
    r0 = (fv.to(torch.int64) - half).clamp(0, Hp - size - 1)
    ar = torch.arange(size, device=img_p.device)
    rows = (r0[:, None] + ar)[:, :, None]
    cols = (c0[:, None] + ar)[:, None, :]
    rs0 = (1.0 - av) * img_p[rows, cols] + av * img_p[rows + 1, cols]
    rs1 = (1.0 - av) * img_p[rows, cols + 1] + av * img_p[rows + 1, cols + 1]
    return (1.0 - au) * rs0 + au * rs1


def _mean(x: torch.Tensor) -> torch.Tensor:
    return x.sum((1, 2)) / float(x.shape[1] * x.shape[2])


def track_level_plain(img0, img1, uv0, seed, valid, *, iters: int,
                      eps: float, with_iters: bool = False):
    """One pyramid level for all keypoints (module docstring semantics).
    img*: [H, W] f32; uv0/seed: [N, 2]; valid: [N] bool.
    Returns (uv [N, 2], min_eig [N], residual [N], t_std [N]), and with
    `with_iters` also the iterations each keypoint ran ([N] int64, for
    counting the work a run needs; the tracker never sets it)."""
    H, W = img0.shape
    Hp, Wp = padded_size(H, W)
    img0 = F.pad(img0, (0, Wp - W, 0, Hp - H))
    img1 = F.pad(img1, (0, Wp - W, 0, Hp - H))

    B = _windows(img0, uv0[:, 0], uv0[:, 1], TMPL)
    T = B[:, 1:12, 1:12]
    gx = 0.5 * (B[:, 1:12, 2:13] - B[:, 1:12, 0:11])
    gy = 0.5 * (B[:, 2:13, 1:12] - B[:, 0:11, 1:12])
    t_mean = _mean(T)
    t_std = torch.sqrt(torch.clamp(_mean(T * T) - t_mean * t_mean, min=0.0))
    gxx, gxy, gyy = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), \
        (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4.0 * det,
                                              min=0.0))) * 0.5 / 121.0
    det_safe = torch.where(det.abs() < 1e-6, 1e-6, det)
    iG00, iG01, iG11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe

    ru = seed[:, 0].clamp(LO, Wp - 8.0)
    rv = seed[:, 1].clamp(LO, Hp - 8.0)
    active = valid.clone()
    n_iters = torch.zeros(active.shape, dtype=torch.int64,
                          device=active.device)
    for _ in range(iters):
        if not bool(active.any()):
            break
        n_iters += active
        err = _windows(img1, ru, rv, 2 * HALF + 1) - T
        err = err - _mean(err)[:, None, None]
        bx, by = (err * gx).sum((1, 2)), (err * gy).sum((1, 2))
        du = -(iG00 * bx + iG01 * by)
        dv = -(iG01 * bx + iG11 * by)
        step = torch.sqrt(du * du + dv * dv)
        ru = torch.where(active, (ru + du).clamp(LO, Wp - 8.0), ru)
        rv = torch.where(active, (rv + dv).clamp(LO, Hp - 8.0), rv)
        active = active & (step >= eps)

    res = _mean((_windows(img1, ru, rv, 2 * HALF + 1) - T).abs())
    uv = torch.where(valid[:, None], torch.stack([ru, rv], dim=-1), seed)
    zero = torch.zeros_like(res)
    out = (uv, torch.where(valid, min_eig, zero),
           torch.where(valid, res, 1e9), torch.where(valid, t_std, zero))
    return out + (n_iters,) if with_iters else out


def level_descriptors(pyr0, pyr1) -> _build.LkLevels:
    """The kernel's by-value level table for two pyramids (level 0 first):
    each level's data pointers, size and padded size. At most
    MAX_LK_LEVELS levels; both pyramids' levels must have equal sizes."""
    n = len(pyr0)
    if not 1 <= n <= _build.MAX_LK_LEVELS or len(pyr1) != n:
        raise ValueError(f"the LK kernel takes 1 to {_build.MAX_LK_LEVELS} "
                         f"levels, got {len(pyr0)} and {len(pyr1)}")
    lv = _build.LkLevels(n=n)
    for i, (a, b) in enumerate(zip(pyr0, pyr1)):
        if a.shape != b.shape or a.dim() != 2:
            raise ValueError(f"level {i}: images of shapes {tuple(a.shape)} "
                             f"and {tuple(b.shape)}")
        H, W = a.shape
        lv.img0[i], lv.img1[i] = a.data_ptr(), b.data_ptr()
        lv.H[i], lv.W[i] = H, W
        lv.Hp[i], lv.Wp[i] = padded_size(H, W)
    return lv


def _launch(pyr0, pyr1, uv0, seed, valid, outs, mode: int, *, iters: int,
            eps: float, min_eig: float = 0.0, max_residual: float = 0.0,
            rel_residual: float = 0.0) -> None:
    """Check the inputs and launch csrc/lk_level.cu's kernel over the
    pyramids: mode 1 the tracker, mode 0 one level with raw outputs."""
    for i, (a, b) in enumerate(zip(pyr0, pyr1)):
        _build.check_cuda(f"lk img0 level {i}", a, torch.float32,
                          (None, None))
        _build.check_cuda(f"lk img1 level {i}", b, torch.float32, a.shape)
    N = uv0.shape[0]
    _build.check_cuda("lk uv0", uv0, torch.float32, (None, 2))
    _build.check_cuda("lk seed", seed, torch.float32, (N, 2))
    _build.check_cuda("lk valid", valid, torch.bool, (N,))
    uv, a, b, c, status = outs
    args = (level_descriptors(pyr0, pyr1), uv0.data_ptr(), seed.data_ptr(),
            valid.data_ptr(), uv.data_ptr(), a.data_ptr(),
            b.data_ptr() if b is not None else None,
            c.data_ptr() if c is not None else None,
            status.data_ptr() if status is not None else None, N,
            int(iters), float(eps), float(min_eig), float(max_residual),
            float(rel_residual), mode)
    _build.launch("lk_level", *args)


def track_level(img0, img1, uv0, seed, valid, *, iters: int, eps: float):
    """`track_level_plain`'s outputs, by the CUDA kernel on the card (one
    level: the tracker's kernel with a one-level table and raw outputs)."""
    if img0.device.type == "cpu":
        return track_level_plain(img0, img1, uv0, seed, valid, iters=iters,
                                 eps=eps)
    N = uv0.shape[0]
    uv = torch.empty((N, 2), dtype=torch.float32, device=img0.device)
    eig, res, std = (torch.empty(N, dtype=torch.float32, device=img0.device)
                     for _ in range(3))
    _launch((img0,), (img1,), uv0, seed, valid, (uv, eig, res, std, None),
            0, iters=iters, eps=eps)
    return uv, eig, res, std


def track_pyramids_plain(pyr0, pyr1, uv0, uv_init, mask, *, iters: int = 30,
                         eps: float = 0.01, min_eig: float = 1e-3,
                         max_residual: float = 12.0,
                         rel_residual: float = 0.5, with_iters: bool = False):
    """The tracker over two pyramids (level 0 first), composed from
    `track_level_plain` and the torch gate: coarse to fine, each level
    seeded by the previous one's uv * 2. With `with_iters`, also returns
    the iterations each keypoint ran at each level ([levels, N], coarsest
    first)."""
    levels = len(pyr0)
    H, W = pyr0[0].shape
    uv = uv_init / 2.0 ** (levels - 1)
    cond_all = torch.ones_like(mask)
    n_iters = []
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        uv, eig, residual, t_std, *it = track_level_plain(
            pyr0[lvl], pyr1[lvl], (uv0 / s).contiguous(), uv.contiguous(),
            mask, iters=iters, eps=eps, with_iters=with_iters)
        n_iters += it
        cond_all = cond_all & (eig > min_eig)
        if lvl > 0:
            uv = uv * 2.0
    in_bounds = ((uv[:, 0] >= HALF) & (uv[:, 0] < W - HALF)
                 & (uv[:, 1] >= HALF) & (uv[:, 1] < H - HALF))
    gate = torch.clamp(rel_residual * t_std, min=max_residual)
    status = mask & cond_all & in_bounds & (residual < gate)
    flow = FlowResult(uv=uv, status=status, residual=residual)
    return (flow, torch.stack(n_iters)) if with_iters else flow


def track_pyramids(pyr0, pyr1, uv0, uv_init, mask, *, iters: int = 30,
                   eps: float = 0.01, min_eig: float = 1e-3,
                   max_residual: float = 12.0,
                   rel_residual: float = 0.5) -> FlowResult:
    """`track_pyramids_plain`'s outputs; on the card in one launch of the
    CUDA kernel."""
    kw = dict(iters=iters, eps=eps, min_eig=min_eig,
              max_residual=max_residual, rel_residual=rel_residual)
    if pyr0[0].device.type == "cpu":
        return track_pyramids_plain(pyr0, pyr1, uv0, uv_init, mask, **kw)
    N = uv0.shape[0]
    dev = uv0.device
    uv = torch.empty((N, 2), dtype=torch.float32, device=dev)
    residual = torch.empty(N, dtype=torch.float32, device=dev)
    status = torch.empty(N, dtype=torch.bool, device=dev)
    _launch(pyr0, pyr1, uv0, uv_init, mask,
            (uv, residual, None, None, status), 1, **kw)
    return FlowResult(uv=uv, status=status, residual=residual)


def track(img0, img1, uv0, uv_init, mask, *, levels: int = 3, half: int = 5,
          iters: int = 30, eps: float = 0.01, min_eig: float = 1e-3,
          max_residual: float = 12.0, rel_residual: float = 0.5) -> FlowResult:
    """Track uv0 from img0 to img1, seeded at uv_init, coarse to fine.
    Status: live, well conditioned at every level, inside the image by
    HALF, and residual < max(max_residual, rel_residual * std(template)).
    The pyramids are built with PyTorch; on the card the whole solve is
    one launch of the kernel."""
    if half != HALF:
        raise ValueError(f"the LK kernel has an 11x11 window (half={HALF})")
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    return track_pyramids(
        build_pyramid(img0, levels), build_pyramid(img1, levels),
        uv0.contiguous(), uv_init.contiguous(), mask, iters=iters, eps=eps,
        min_eig=min_eig, max_residual=max_residual, rel_residual=rel_residual)
