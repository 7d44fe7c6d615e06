#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`ya_vo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device: a CUDA card is required; prints `nvidia-smi` name and power
     limit;
  2. build: compiles the kernels from ya_vo_tpu_torch/csrc with nvcc;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the main path's shapes (one 376x1241 frame pair of the stamps world,
     2048 keypoints, border clamps and dead slots among them; the FAST
     kernel bit for bit, as the score map on the whole frame and as the
     candidate set inside the detection border, with the main path's
     parameters; the selection kernel slot for slot; the LK kernel level by
     level through its one-level mode, then as the whole tracker in one
     launch). Times: the kernel's device time (`torch.profiler` device
     events of the kernel's own name, free of host issue), the wrapper
     call's time by CUDA events (host issue included), the plain version's,
     the least time the card could take for the same work (bound), and one
     PyTorch call that computes the same function where there is one (the
     yardstick; the port never calls it): `torch._int_mm` on +-1 int8 for
     Hamming, `torch.topk` over the candidates' unique keys for the
     selection. Then the whole `fast.detect` call: equal to the CPU's in
     every slot, its device time (all device events of a call) and its
     device events and kernel launches a call;
  4. main path: `create_frontend(cfg, cam, device="cuda").run(frames)` over
     the 40-frame stamps world at VOConfig() defaults with window BA off:
     0 resets, 2048 keypoints every tracked frame, the keyframes and
     ATE_sim3 of the port's earlier runs (MAIN_KEYFRAMES, MAIN_ATE at four
     digits), every kernel launched by that run, the LK kernel once a
     tracked frame and the two FAST kernels equally often, at least once a
     tracked frame;
  5. production path: `create_frontend(VOConfig(), cam)` unmodified (sync
     window BA every 3rd keyframe, push apply, redo of the in-flight frames
     at pipeline depth 8) over the same 40 frames: at least one BA solve, no
     discards, the resets of the JAX reference on these frames
     (`port_jax_reference.py`), ATE_sim3 below 0.05 and held at four digits
     (MAIN_BA_ATE); LK launched once a fresh or redone dispatch, the FAST
     kernels once a fresh extraction (a redo reuses its frame's), K3 once a
     dispatch and once a bootstrap or relocalization;
  6. reset path: the same frames with two black frames after frame 20, at
     VOConfig(): at least one reset and one PnP relocalization, tracking at
     the end, the step scale after the blackout within 5% of the scale
     before it, ATE_sim3 over the real frames below 0.25;
  7. determinism: `solve_window` on phase 5's last window problem twice,
     bit-identical poses and landmarks; its device and call time.
Each of phases 4-6 zeroes the launch counts just before its run, reads them
just after, and fails unless every kernel ran in it. Prints a JSON line
with the kernels' results, then, as the last line, {"ok": true, "device":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SEQ = dict(n_frames=40, n_landmarks=1200, height=376, width=1241, step=0.5,
           yaw_rate=0.002, seed=11, corridor=True)
REPS = 20

# K1 against its plain version, level by level on identical inputs:
# positions within LK_UV_TOL px, with at most LK_FLIPS keypoints past it
# (one version took one more step than the other where a step fell within
# float noise of eps), and none in a coordinate pinned at a clamp (clamp
# slots are put among the keypoints for that); eig, res and std within
# LK_ATOL + LK_RTOL * |plain|. Measured on an H100 over three frame pairs
# of the stamps world: |duv| <= 1.5e-5 px but for one eps flip (0.068 px),
# errors of at most 1.2e-7 (eig), 1.2e-5 (res) and 4.7e-5 (std, which
# loses absolute precision to E[T^2] - E[T]^2) of the plain value; the
# one-launch kernel, whose iterations regroup the sums, on one frame pair:
# |duv| <= 1.5e-5 px but the same flip, res within 1.5e-5.
# The whole tracker: status equal on all but LK_FLIPS keypoints, clamped
# coordinates within LK_UV_TOL, other positions past it on at most
# LK_TRACK_FRAC of the tracks, since a coarse level's eps flip moves the
# next level's seed and weakly conditioned tracks amplify it.
LK_ITERS, LK_EPS = 30, 0.01
LK_UV_TOL = 1e-3
LK_FLIPS = 2
LK_RTOL = 1e-4
LK_ATOL = (1e-5, 1e-4, 1e-3)   # eig, res, std
LK_TRACK_FRAC = 0.01

# The card's published peaks (H100 SXM data sheet, dense, at 700 W): HBM
# bytes/s, 32-bit operations/s outside the tensor cores, int8 tensor ops/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12
# Operations of the LK function, counted from the plain version's arithmetic
# (index math not counted; a bilinear sample is 3 lerps of 2 mul + 1 add):
# the 13x13 template (169 samples, central differences, T and T^2 sums,
# the 2x2 normal matrix), one iteration (121 samples, error, mean, the two
# gradient dot products) and the final residual (121 samples, |e| sum).
LK_TEMPLATE_OPS = 169 * 9 + 121 * (4 + 1 + 2 + 6) + 30
LK_ITER_OPS = 121 * (9 + 1 + 1 + 1 + 4) + 15
LK_FINAL_OPS = 121 * (9 + 3)
# Operations of the FAST candidates, counted where this run's data needs
# them: every pixel takes the cardinal pre-test (2 bounds, 8 compares, 6
# adds, 2 compares and an or); a pixel that passes it, the ring test (32
# compares, 32 shifts and ors, two run tests of ~16 bit ops); a corner,
# Harris (at each of 9 positions a Sobel pair of 12 adds, 3 products and 3
# sums; then det, trace and the response: 7) and NMS (the (2r+1)^2 max, the
# keep test and 4 border compares).
FAST_PRE_OPS = 2 + 8 + 6 + 2 + 1
FAST_RING_OPS = 32 + 32 + 2 * 16
FAST_HARRIS_OPS = 9 * (12 + 3 + 3) + 7
# The main path's result, as the port's earlier runs printed it (a change
# that moves it changes the trajectory).
MAIN_KEYFRAMES = 20
MAIN_ATE = 0.0384
# The production path's ATE_sim3 at four digits, as the port's first card
# run of it printed it.
MAIN_BA_ATE = 0.0117
# The JAX package's frontend on the CPU on the same frames, LK with the
# TPU kernel's semantics (`port_jax_reference.py`): window BA off, on, and
# on through the blackout. Its RANSAC draws are not the port's, so ATEs
# agree only in size; resets and relocalizations are held equal.
JAX_ATE = 0.02441459836270033
JAX_BA_ATE = 0.012404143123595465
JAX_BA_RESETS = 0
JAX_BLACKOUT = dict(ate_sim3=0.013599145102656892, resets=1,
                    relocalizations=1, scale_ratio=1.0011951975443207)
# phase 6: two black frames inserted after frame BLACK_AT - 1
BLACK_AT, BLACK_N = 21, 2


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = REPS) -> float:
    """Mean time of fn() over `reps` back-to-back calls, by CUDA events
    around them: the host's issue of each call is inside it whenever the
    host takes longer than the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_events(fn, reps: int = REPS):
    """The profiler's CPU and device events over `reps` calls of fn, after
    one call outside the profile."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.events()


def device_ms(fn, kernel=None, reps: int = REPS, launches_per_call=None):
    """Mean device time per fn() call over `reps` calls, free of the host's
    issue time: the summed durations of the profiler's device events whose
    name holds `kernel` (every device event if None), over `reps`; with
    `launches_per_call`, the mean duration of one such event times that
    count (the profiler may drop an event of a long run)."""
    evs = [e for e in profiled_events(fn, reps)
           if e.device_type == DeviceType.CUDA
           and (kernel is None or kernel in e.name)]
    check(evs, f"the profiler saw no device events of {kernel}")
    total_us = sum(e.time_range.end - e.time_range.start for e in evs)
    if launches_per_call is not None:
        check(len(evs) <= reps * launches_per_call,
              f"{kernel}: {len(evs)} device events in {reps} calls, "
              f"expected {launches_per_call} a call")
        return total_us / len(evs) * launches_per_call / 1e3
    return total_us / reps / 1e3


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over the peak."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    """Same shape and dtype and the same bits in every element (so -0 is
    not +0); bools and integers by value."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def fast_work(img, args, fast_cuda) -> dict:
    """What the FAST candidates' bound counts on this frame: pixels, those
    that pass the cardinal pre-test, and segment-test corners (from the
    plain version's pieces)."""
    f = img.to(torch.float32)
    t, n = args["threshold"], args["arc_length"]
    taps = [fast_cuda._shift(f, dv, du)
            for dv, du in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    n_bright = sum((v > f + t).to(torch.int32) for v in taps)
    n_dark = sum((v < f - t).to(torch.int32) for v in taps)
    pre = (n_bright >= n // 4) | (n_dark >= n // 4)
    corner = fast_cuda.fast_response(f, t, n)
    return dict(pixels=img.numel(), pretest=int(pre.sum()),
                corners=int(corner.sum()))


def check_fast(img, kw, fast_cuda):
    """K2 on the uint8 frame with the main path's parameters `kw`: the map
    (the kernel at border 0, scattered) equal to the plain map bit for bit
    on the whole frame, edges included; the candidates inside the border
    equal to the plain ones as a set, scores bit for bit. Returns the
    results and the kernel's candidates."""
    args = dict(threshold=float(kw["threshold"]), arc_length=kw["arc_length"],
                harris_k=kw["harris_k"], nms_radius=kw["nms_radius"])
    border = kw["border"]
    kern = fast_cuda.fast_score_map(img, **args)
    plain = fast_cuda.fast_score_map_plain(img.to(torch.float32), **args)
    n_map_diff = int((kern.view(torch.int32)
                      != plain.view(torch.int32)).sum())
    check(n_map_diff == 0,
          f"fast_score: the map differs from the plain one at {n_map_diff} px")
    cand = fast_cuda.fast_candidates(img, border=border, **args)
    ref = fast_cuda.fast_candidates_plain(img, border=border, **args)
    n = int(cand.count)
    idx, order = cand.idx[:n].sort()
    check(n == int(ref.count) and torch.equal(idx, ref.idx)
          and bits_equal(cand.score[:n][order], ref.score),
          f"fast_score: {n} candidates at border {border}, plain "
          f"{int(ref.count)}, or their indices or scores differ")

    def kernel():
        return fast_cuda.fast_candidates(img, border=border, **args)

    # uint8 in, (score, index) of each candidate and the count out; the
    # operations this frame needs (fast_work)
    work = fast_work(img, args, fast_cuda)
    nms_ops = (2 * kw["nms_radius"] + 1) ** 2 + 1 + 4
    bound_ms, bound_by = bound(
        img.numel() + 8 * n + 4,
        work["pixels"] * FAST_PRE_OPS + work["pretest"] * FAST_RING_OPS
        + work["corners"] * (FAST_HARRIS_OPS + nms_ops), F32_OPS_S)
    return dict(max_abs_err=0.0, map_px_differ=n_map_diff,
                n_map_kept=int((plain > fast_cuda.NEG / 2).sum()),
                n_candidates=n, **work,
                device_ms=device_ms(kernel, "fast_score_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: fast_cuda.fast_candidates_plain(
                    img, border=border, **args)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None), cand


def topk_keys(cand):
    """The candidates' unique int64 keys, in the order of the selection:
    score (-0 as +0; signed-int order of the float bits) above, the
    inverted flat index below."""
    n = int(cand.count)
    s = (cand.score[:n] + 0.0).view(torch.int32)
    s = s ^ ((s >> 31) & 0x7FFFFFFF)
    return (s.to(torch.int64) << 32) | (0xFFFFFFFF - cand.idx[:n].to(
        torch.int64))


def check_select(cand, kw, H, W, fast_cuda):
    """`fast_select` against the plain sort path, slot for slot, on K2's
    candidates; its yardstick is one `torch.topk` over the candidates'
    unique keys (checked to pick the same candidates in the same order)."""
    K = kw["max_keypoints"]
    kern = fast_cuda.select_top_k(*cand, H=H, W=W, k=K)
    plain = fast_cuda.select_top_k_plain(*cand, H=H, W=W, k=K)
    check(all(bits_equal(a, b) for a, b in zip(kern, plain)),
          "fast_select: slots differ from the plain sort path")
    n = int(cand.count)
    keys = topk_keys(cand)
    m = min(K, n)
    top = torch.topk(keys, m).indices
    idx = cand.idx[:n][top].to(torch.int64)
    check(torch.equal(torch.stack([idx % W, idx // W], -1).float(),
                      kern[0][:m]), "fast_select: torch.topk's order differs")

    def kernel():
        return fast_cuda.select_top_k(*cand, H=H, W=W, k=K)

    # the candidates and the count in, K slots (uv, score, mask) out; the
    # compares of a comparison sort of the candidates
    bound_ms, bound_by = bound(8 * n + 4 + K * (8 + 4 + 1),
                               n * max(1, int(np.ceil(np.log2(max(n, 2))))),
                               F32_OPS_S)
    return dict(max_abs_err=0.0, n_candidates=n, k=K,
                device_ms=device_ms(kernel, "fast_select_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: fast_cuda.select_top_k_plain(
                    *cand, H=H, W=W, k=K)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=device_ms(lambda: torch.topk(keys, m)))


def check_detect(img, kw, fast, _build):
    """The whole `fast.detect` on the card equals `detect` on the CPU in
    every slot (masked slots included); its device time (all device events
    of a call), call time, device events (kernels, copies, memsets) and
    CUDA runtime launch calls a call."""
    kern = fast.detect(img, **kw)
    plain = fast.detect(img.cpu(), **kw)
    check(all(bits_equal(a.cpu(), b) for a, b in zip(kern, plain)),
          "detect: the card's keypoints differ from the CPU's")
    _build.reset_launches()
    fast.detect(img, **kw)
    kernels = {k: v for k, v in _build.LAUNCHES.items() if v}

    def call():
        return fast.detect(img, **kw)

    evs = profiled_events(call)
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    n_launch = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith("cudaLaunch") for e in evs)
    return dict(n_valid=int(plain.mask.sum()), kernels_a_call=kernels,
                device_events=len(dev) / REPS,
                runtime_launches=n_launch / REPS,
                device_ms=sum(e.time_range.end - e.time_range.start
                              for e in dev) / REPS / 1e3,
                call_ms=time_ms(call))


def check_hamming(d1, d2, hamming_cuda):
    gen = torch.Generator().manual_seed(0)
    r1, r2 = (torch.randint(-2 ** 31, 2 ** 31, (2048, 8), generator=gen,
                            dtype=torch.int64).to(torch.int32).cuda()
              for _ in range(2))
    err = 0
    for a, b in ((d1, d2), (r1, r2)):
        k = hamming_cuda.hamming_matrix(a, b)
        p = hamming_cuda.hamming_matrix_plain(a, b)
        err = max(err, (k - p).abs().max().item())
    check(err == 0, f"hamming: kernel differs from plain by {err}")
    kernel = lambda: hamming_cuda.hamming_matrix(d1, d2)  # noqa: E731
    (K1, n_words), K2 = d1.shape, d2.shape[0]
    n_bits = 32 * n_words
    bound_ms, bound_by = bound(4 * (K1 + K2) * n_words + 4 * K1 * K2,
                               2 * K1 * K2 * n_bits, INT8_OPS_S)
    return dict(max_abs_err=err,
                device_ms=device_ms(kernel, "hamming_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(
                    lambda: hamming_cuda.hamming_matrix_plain(d1, d2)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=hamming_library_ms(d1, d2, hamming_cuda))


def hamming_library_ms(d1, d2, hamming_cuda):
    """Device time of one `torch._int_mm` on the +-1 int8 unpackings
    (unpacked outside the timed region): the int8 tensor-core product
    whose dot gives distance = (n_bits - dot) / 2. The port never calls
    it; it is the yardstick. Checked against the plain distances."""
    a = hamming_cuda.unpack_pm1(d1).to(torch.int8)
    b = hamming_cuda.unpack_pm1(d2).to(torch.int8).T
    dot = torch._int_mm(a, b)
    dist = (a.shape[1] - dot) // 2
    check(torch.equal(dist, hamming_cuda.hamming_matrix_plain(d1, d2)),
          "hamming: torch._int_mm distances differ from the plain ones")
    return device_ms(lambda: torch._int_mm(a, b))


def lk_edge_cases(uv0, seed, mask, H, W):
    """Copies of the keypoints, seeds and mask with the last slots replaced
    by border clamps (templates at, past and far past the image edges,
    seeds past the padded level) and by dead slots holding garbage
    positions; and the mask of the clamp slots."""
    clamps = [((1.0, 2.0), (0.5, -3.0)),
              ((W - 2.0, H - 1.5), (W + 9.0, H + 4.0)),
              ((W - 6.3, H / 2 + 0.2), (W - 4.0, H / 2 + 1.0)),
              ((3.2, H - 2.7), (-5.0, H + 30.0)),
              ((W + 20.0, 50.0), (W + 49.0, 48.0)),
              ((W / 2, H - 3.0), (W / 2 + 0.5, H + 14.0)),
              ((W - 3.5, 100.0), (W + 2.0, 101.0)),
              ((W / 3, H - 1.0), (W / 3 + 1.0, H + 6.0)),
              ((W + 600.0, H / 2), (W + 600.0, H / 2)),
              ((W / 2 + 0.3, H + 40.0), (W / 2, H + 40.0))]
    dead = [(-40.0, 900.0), (1e4, -1e4)]
    uv0, seed, mask = uv0.clone(), seed.clone(), mask.clone()
    n = len(clamps) + len(dead)
    for i, (t, s) in enumerate(clamps):
        uv0[i - n] = torch.tensor(t, device=uv0.device)
        seed[i - n] = torch.tensor(s, device=uv0.device)
    for i, s in enumerate(dead):
        seed[i - len(dead)] = torch.tensor(s, device=uv0.device)
    mask[-n:] = True
    mask[-len(dead):] = False
    edge = torch.zeros_like(mask)
    edge[-n:-len(dead)] = True
    return uv0, seed, mask, edge


def pinned_at_clamp(uv, edge, H, W):
    """[N, 2]: the coordinates of the clamp slots `edge` that sit on a
    bound of the position clamp of an H x W level, where no eps test can
    move them."""
    from ya_vo_tpu_torch.tracking import lk_cuda

    Hp, Wp = lk_cuda.padded_size(H, W)
    lo = lk_cuda.LO
    return edge[:, None] & torch.stack(
        [(uv[:, 0] == lo) | (uv[:, 0] == Wp - 8.0),
         (uv[:, 1] == lo) | (uv[:, 1] == Hp - 8.0)], dim=1)


def lk_level_errors(k, p, valid, pinned):
    """Kernel outputs k against plain outputs p of one level. A position
    may pass LK_UV_TOL only where one version took one more step than the
    other (a step within float noise of eps), never in a coordinate the
    plain one has `pinned` at a clamp; res is compared on the other
    keypoints, and dead slots must be equal bit for bit."""
    d = (k[0] - p[0]).abs()
    d_uv = d.max(1).values
    near = d_uv <= LK_UV_TOL
    out = dict(max_duv=d_uv[valid].max().item(),
               n_past_tol=int((~near & valid).sum()),
               n_pinned=int(pinned.any(1).sum()),
               pinned_past_tol=int(((d > LK_UV_TOL) & pinned).any(1).sum()),
               dead_equal=all(torch.equal(a[~valid], b[~valid])
                              for a, b in zip(k, p)))
    for name, a, b, atol in zip(("eig", "res", "std"), k[1:], p[1:],
                                LK_ATOL):
        live = valid & near if name == "res" else valid
        err = (a - b)[live].abs()
        out[f"{name}_max_abs"] = err.max().item()
        out[f"{name}_max_rel"] = (err / b[live].abs()).nan_to_num(
            posinf=0.0).max().item()
        out[f"{name}_ok"] = bool((err <= atol + LK_RTOL
                                  * b[live].abs()).all())
    return out


def compare_lk(img0, img1, uv0, seed, mask, edge):
    """K1 against its plain version on the card, level by level on
    identical inputs (each level seeded by the kernel's previous level);
    then the whole tracker (one launch) on the card against the plain one
    on the CPU. Returns (errors by level, the two pyramids, the tracker's
    errors); each level's errors hold the iterations the plain version ran
    there."""
    from ya_vo_tpu_torch.tracking import lk, lk_cuda

    pyr0 = lk.build_pyramid(img0, 3)
    pyr1 = lk.build_pyramid(img1, 3)
    lvl_seed, per_level = seed / 4.0, {}
    for lvl in (2, 1, 0):
        args = (pyr0[lvl], pyr1[lvl], (uv0 / 2.0 ** lvl).contiguous(),
                lvl_seed.contiguous(), mask)
        k = lk_cuda.track_level(*args, iters=LK_ITERS, eps=LK_EPS)
        *p, n_iters = lk_cuda.track_level_plain(
            *args, iters=LK_ITERS, eps=LK_EPS, with_iters=True)
        per_level[lvl] = lk_level_errors(
            k, p, mask, pinned_at_clamp(p[0], edge, *args[0].shape))
        per_level[lvl]["iterations"] = int(n_iters.sum())
        lvl_seed = k[0] * 2.0 if lvl > 0 else k[0]

    kern = lk_cuda.track(img0, img1, uv0, seed, mask)
    plain = lk_cuda.track(img0.cpu(), img1.cpu(), uv0.cpu(), seed.cpu(),
                          mask.cpu())
    k_st = kern.status.cpu()
    pinned = pinned_at_clamp(plain.uv, edge.cpu(), *img0.shape)
    d = (kern.uv.cpu() - plain.uv).abs()
    d_uv = d.max(1).values[k_st & plain.status]
    tracker = dict(max_duv=d_uv.max().item(),
                   n_past_tol=int((d_uv > LK_UV_TOL).sum()),
                   status_flips=int((k_st != plain.status).sum()),
                   n_pinned=int(pinned.any(1).sum()),
                   pinned_differ=int(((d > LK_UV_TOL) & pinned).any(1).sum()),
                   status_kernel=int(k_st.sum()),
                   status_plain=int(plain.status.sum()))
    return per_level, (pyr0, pyr1), tracker


def lk_problems(per_level, tracker) -> list:
    """What compare_lk's errors break of the stated tolerances."""
    bad = []
    for lvl, s in per_level.items():
        if s["n_past_tol"] > LK_FLIPS:
            bad.append(f"level {lvl}: {s['n_past_tol']} keypoints past "
                       f"{LK_UV_TOL} px (max {s['max_duv']})")
        if s["pinned_past_tol"]:
            bad.append(f"level {lvl}: {s['pinned_past_tol']} clamped "
                       f"positions past {LK_UV_TOL} px")
        if not s["dead_equal"]:
            bad.append(f"level {lvl}: dead slots differ")
        bad += [f"level {lvl}: {n} differs, max abs {s[f'{n}_max_abs']}, "
                f"max rel {s[f'{n}_max_rel']}"
                for n in ("eig", "res", "std") if not s[f"{n}_ok"]]
    if tracker["status_flips"] > LK_FLIPS:
        bad.append(f"status differs on {tracker['status_flips']} keypoints")
    if tracker["pinned_differ"]:
        bad.append(f"{tracker['pinned_differ']} clamped tracks past "
                   f"{LK_UV_TOL} px")
    if tracker["n_past_tol"] > max(LK_FLIPS,
                                   LK_TRACK_FRAC * tracker["status_plain"]):
        bad.append(f"{tracker['n_past_tol']} tracks past {LK_UV_TOL} px "
                   f"of {tracker['status_plain']}")
    return bad


def check_lk(img0, img1, uv0, mask, lk_cuda):
    H, W = img0.shape
    cases = lk_edge_cases(uv0, uv0, mask, H, W)
    per_level, (pyr0, pyr1), tracker = compare_lk(img0, img1, *cases)
    print("kernel lk_level errors: " + json.dumps(
        dict(per_level=per_level, tracker=tracker)), flush=True)
    bad = lk_problems(per_level, tracker)
    check(not bad, "lk: " + "; ".join(bad))

    uv0, seed, mask, _ = cases

    def kernel():
        return lk_cuda.track_pyramids(pyr0, pyr1, uv0, seed, mask,
                                      iters=LK_ITERS, eps=LK_EPS)

    def plain():
        return lk_cuda.track_pyramids_plain(pyr0, pyr1, uv0, seed, mask,
                                            iters=LK_ITERS, eps=LK_EPS)

    # the tracker's work: each level of both pyramids, the keypoints, seeds
    # and mask read once, uv, residual and status written once; the
    # operations of the iterations the plain version ran on these inputs
    n_live = int(mask.sum())
    n_bytes = sum(2 * 4 * a.numel() for a in pyr0) \
        + mask.numel() * (8 + 8 + 1 + 8 + 4 + 1)
    n_ops = sum(n_live * (LK_TEMPLATE_OPS + LK_FINAL_OPS)
                + s["iterations"] * LK_ITER_OPS for s in per_level.values())
    bound_ms, bound_by = bound(n_bytes, n_ops, F32_OPS_S)
    return dict(max_abs_err=max(s["max_duv"] for s in per_level.values()),
                **{f"track_{k}": v for k, v in tracker.items()},
                iterations=sum(s["iterations"] for s in per_level.values()),
                device_ms=device_ms(kernel, "lk_pyramid_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(plain, reps=5),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def with_blackout(frames):
    """The frames with BLACK_N black frames inserted at BLACK_AT."""
    black = np.zeros_like(frames[0])
    return (list(frames[:BLACK_AT]) + [black] * BLACK_N
            + list(frames[BLACK_AT:]))


def non_black(n_frames: int) -> np.ndarray:
    """Indices of the frames of a blackout run that hold a real image."""
    idx = np.arange(n_frames + BLACK_N)
    return idx[(idx < BLACK_AT) | (idx >= BLACK_AT + BLACK_N)]


def step_scale(traj, gt_wc, lo: int, hi: int) -> float:
    """Median step-length ratio (estimate / truth) over frames [lo, hi) of
    world->camera poses."""
    from ya_vo_tpu_torch.viz import evaluation

    ce = evaluation.positions_from_poses(traj[lo:hi])
    cg = evaluation.positions_from_poses(gt_wc[lo:hi])
    se = np.linalg.norm(np.diff(ce, axis=0), axis=1)
    sg = np.linalg.norm(np.diff(cg, axis=0), axis=1)
    ok = sg > 1e-6
    return float(np.median(se[ok] / sg[ok]))


def blackout_scale_ratio(traj, gt_wc) -> float:
    """Step scale after the blackout over the scale before it (frames 2 to
    BLACK_AT - 1 against BLACK_AT + 2 to the end, real frames only), the
    property of tests/test_relocalization.py; gt_wc holds the real frames'
    world->camera truth."""
    est = traj[non_black(len(gt_wc))]
    pre = step_scale(est, gt_wc, 2, BLACK_AT - 1)
    post = step_scale(est, gt_wc, BLACK_AT + 2, len(gt_wc))
    return post / pre


def path_launches(_build, name: str) -> dict:
    """The launch counts of the run just made; fails unless every kernel
    ran in it."""
    launches = dict(_build.LAUNCHES)
    check(all(launches.values()),
          f"{name}: a kernel was not launched: {launches}")
    return launches


def run_production(frames, poses_gt, cam, card, _build, create_frontend,
                   VOConfig, evaluation):
    """Phase 5: VOConfig() unmodified over the 40 frames, pipelined."""
    _build.reset_launches()
    fe = create_frontend(VOConfig(), cam, device="cuda")
    fe.run(frames[:2])                      # INIT + two-view bootstrap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = fe.run(frames[2:], pipelined=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = path_launches(_build, "production path")
    tracked = [r for r in fe.results if r.status == "TRACKING"
               and r.frame_id >= 2]
    n_tr = len(tracked)
    check(traj.shape == (40, 4, 4) and np.isfinite(traj).all(),
          f"production: trajectory shape {traj.shape} or not finite")
    check(fe.n_resets == JAX_BA_RESETS,
          f"production: {fe.n_resets} resets, JAX {JAX_BA_RESETS}")
    check(n_tr == 38, f"production: {n_tr} tracked frames of 38")
    check(fe.n_ba_runs >= 1 and fe.n_ba_discarded == 0,
          f"production: {fe.n_ba_runs} BA solves applied, "
          f"{fe.n_ba_discarded} discarded")
    ate = evaluation.ate_rmse(traj, np.linalg.inv(poses_gt),
                              with_scale=True)
    check(ate < 0.05, f"production: ATE_sim3 {ate}")
    check(round(ate, 4) == MAIN_BA_ATE,
          f"production: ATE_sim3 {ate}, not {MAIN_BA_ATE}")
    # 2 + 38 fresh extractions; LK at every fresh and redone dispatch; K3
    # at every dispatch and at the bootstrap
    n_disp = n_tr + fe.n_redone
    check(launches["fast_score"] == launches["fast_select"] == 40,
          f"production: fast launches {launches}")
    check(launches["lk_level"] == n_disp,
          f"production: lk launches {launches}, {n_disp} dispatches")
    check(launches["hamming"] == n_disp + 1,
          f"production: hamming launches {launches}")
    out = dict(frames_per_s=n_tr / dt, tracked_frames=n_tr, seconds=dt,
               ate_sim3=ate, jax_ate_sim3=JAX_BA_ATE, resets=fe.n_resets,
               keyframes=sum(r.is_keyframe for r in fe.results),
               ba_solves=fe.n_ba_runs, ba_discarded=fe.n_ba_discarded,
               ba_solve_call_ms=fe.ba_ms,
               ba_solve_call_ms_mean=float(np.mean(fe.ba_ms)),
               redone_dispatches=fe.n_redone, launches=launches,
               launches_per_frame={k: v / n_tr for k, v in launches.items()},
               card=card)
    return out, fe


def run_reset(frames, poses_gt, cam, card, _build, create_frontend,
              VOConfig, evaluation):
    """Phase 6: the blackout at VOConfig(), pipelined."""
    _build.reset_launches()
    fe = create_frontend(VOConfig(), cam, device="cuda")
    seq = with_blackout(frames)
    t0 = time.perf_counter()
    traj = fe.run(seq, pipelined=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = path_launches(_build, "reset path")
    statuses = [r.status for r in fe.results]
    check(traj.shape == (len(seq), 4, 4) and np.isfinite(traj).all(),
          f"reset: trajectory shape {traj.shape} or not finite")
    check(fe.n_resets >= 1 and fe.n_relocalizations >= 1,
          f"reset: {fe.n_resets} resets, {fe.n_relocalizations} "
          f"relocalizations")
    check(statuses[-1] == "TRACKING", f"reset: last status {statuses[-1]}")
    keep = non_black(len(frames))
    ate = evaluation.ate_rmse(traj[keep], np.linalg.inv(poses_gt),
                              with_scale=True)
    ratio = blackout_scale_ratio(traj, poses_gt)
    check(abs(ratio - 1.0) < 0.05, f"reset: scale ratio {ratio}")
    check(ate < 0.25, f"reset: ATE_sim3 {ate}")
    n_disp = launches["lk_level"]
    check(launches["hamming"] >= n_disp + 1 + fe.n_relocalizations,
          f"reset: hamming launches {launches}")
    return dict(seconds=dt, frames=len(seq), resets=fe.n_resets,
                relocalizations=fe.n_relocalizations,
                statuses_not_tracking={i: s for i, s in enumerate(statuses)
                                       if s != "TRACKING"},
                scale_ratio=ratio, ate_sim3=ate, jax=JAX_BLACKOUT,
                ba_solves=fe.n_ba_runs, ba_discarded=fe.n_ba_discarded,
                redone_dispatches=fe.n_redone, launches=launches,
                card=card)


def check_ba_determinism(fe, ba_window):
    """Phase 7: the last window problem of phase 5 solved twice, bit for
    bit; one solve's device time (all its device events) and call time."""
    bc = fe.cfg.ba
    prob = fe._last_ba_prob

    def solve():
        return ba_window.solve_window(
            prob, fe.cam, iters=bc.iters, huber_delta=bc.huber_delta,
            damping=bc.damping, n_fixed_poses=2,
            pose_prior_weight=bc.pose_prior_weight)

    a, b = solve(), solve()
    check(bits_equal(a.poses, b.poses) and bits_equal(a.landmarks,
                                                      b.landmarks),
          "solve_window: two solves of one problem differ")
    return dict(bit_identical=True, n_iters=a.n_iters,
                n_obs=int(a.n_obs), n_landmarks=int(prob.lm_valid.sum()),
                device_ms=device_ms(solve, reps=3),
                call_ms=time_ms(solve, reps=3))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ya_vo_tpu_torch import _build, create_frontend
        from ya_vo_tpu_torch.ba import window as ba_window
        from ya_vo_tpu_torch.config import VOConfig
        from ya_vo_tpu_torch.features import fast, fast_cuda, hamming_cuda
        from ya_vo_tpu_torch.tracking import lk_cuda
        from ya_vo_tpu_torch.tracking.frontend import detect_kwargs
        from ya_vo_tpu_torch.utils import synthetic
        from ya_vo_tpu_torch.viz import evaluation
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    # 1. device
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})", flush=True)

    # 3. kernels against their plain versions at the main path's shapes
    t0 = time.perf_counter()
    frames, poses_gt, _, cam = synthetic.render_sequence(**SEQ)
    print(f"render: {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = VOConfig()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba,
                                                          enabled=False))
    probe = create_frontend(cfg, cam, device="cuda")
    img0 = torch.as_tensor(frames[0]).cuda()
    img1 = torch.as_tensor(frames[1]).cuda()
    kp0, desc0 = probe._extract(img0)
    kp1, desc1 = probe._extract(img1)
    check(int(kp0.count()) == 2048 and int(kp1.count()) == 2048,
          "probe frames do not fill 2048 keypoints")
    kw = detect_kwargs(cfg.features)          # as `_extract` passes them
    fast_r, cand = check_fast(img1, kw, fast_cuda)
    results = {
        "fast_score": fast_r,
        "fast_select": check_select(cand, kw, *img1.shape, fast_cuda),
        "hamming": check_hamming(desc0, desc1, hamming_cuda),
        "lk_level": check_lk(img0.float(), img1.float(), kp0.uv,
                             kp0.mask, lk_cuda),
    }
    for name, r in results.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    print("detect: " + json.dumps(check_detect(img1, kw, fast, _build)),
          flush=True)

    # 4. main path
    _build.reset_launches()
    fe = create_frontend(cfg, cam, device="cuda")
    fe.run(frames[:2])                      # INIT + two-view bootstrap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = fe.run(frames[2:], pipelined=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    tracked = [r for r in fe.results if r.status == "TRACKING"
               and r.frame_id >= 2]
    n_tr = len(tracked)
    check(traj.shape == (40, 4, 4) and np.isfinite(traj).all(),
          f"trajectory shape {traj.shape} or not finite")
    check(fe.n_resets == 0, f"{fe.n_resets} resets")
    check(n_tr == 38, f"{n_tr} tracked frames of 38")
    check(all(r.n_keypoints == 2048 for r in tracked),
          "a tracked frame did not fill 2048 keypoints")
    ate = evaluation.ate_rmse(traj, np.linalg.inv(poses_gt),
                              with_scale=True)
    n_kf = sum(r.is_keyframe for r in fe.results)
    check(round(ate, 4) == MAIN_ATE, f"ATE_sim3 {ate}, not {MAIN_ATE}")
    check(n_kf == MAIN_KEYFRAMES, f"{n_kf} keyframes, not {MAIN_KEYFRAMES}")
    path_launches(_build, "main path")
    check(launches["lk_level"] == n_tr, f"lk launches {launches}")
    check(launches["fast_select"] == launches["fast_score"] >= n_tr,
          f"fast launches {launches}")
    check(launches["hamming"] >= n_tr, f"hamming launches {launches}")
    print("main path: " + json.dumps(dict(
        frames_per_s=n_tr / dt, tracked_frames=n_tr, seconds=dt,
        ate_sim3=ate, jax_ate_sim3=JAX_ATE, resets=fe.n_resets,
        keyframes=n_kf, launches=launches, card=card)), flush=True)

    # 5. production path, 6. reset path, 7. BA determinism
    paths = (frames, poses_gt, cam, card, _build, create_frontend, VOConfig,
             evaluation)
    prod, fe5 = run_production(*paths)
    print("production path: " + json.dumps(prod), flush=True)
    reset = run_reset(*paths)
    print("reset path: " + json.dumps(reset), flush=True)
    print("ba solve: " + json.dumps(check_ba_determinism(fe5, ba_window)),
          flush=True)
    by_path = {"ba_off": launches, "production": prod["launches"],
               "reset": reset["launches"]}

    sources = {"fast_score": ("ya_vo_tpu_torch/csrc/fast_score.cu",
                              "ya_vo_tpu/features/pallas_fast.py:70"),
               "fast_select": ("ya_vo_tpu_torch/csrc/fast_select.cu",
                               "ya_vo_tpu/features/fast.py:193 "
                               "(lax.top_k, XLA)"),
               "hamming": ("ya_vo_tpu_torch/csrc/hamming.cu",
                           "ya_vo_tpu/features/pallas_hamming.py:46"),
               "lk_level": ("ya_vo_tpu_torch/csrc/lk_level.cu",
                            "ya_vo_tpu/tracking/lk_pallas.py:217")}
    # ms is the kernel's device time per call of its wrapper (per tracker
    # call for LK); library_ms is null where no one PyTorch call computes
    # the function (LK's pyramid solve, FAST's segment test + Harris + NMS).
    # launches: the production path's (phase 5), VOConfig() unmodified
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1],
                    launches=prod["launches"][name],
                    launches_per_frame=prod["launches_per_frame"][name],
                    launches_by_path={k: v[name]
                                      for k, v in by_path.items()},
                    max_abs_err=r["max_abs_err"], ms=r["device_ms"],
                    device_ms=r["device_ms"], call_ms=r["call_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
