"""Kernel-parity selfcheck of the port on one CUDA card.

    python -m ya_vo_tpu_torch.selfcheck

Port of `tools/selfcheck.py`, the bench's parity guard. On two frames of
the textured world it renders on the card (`TexturedSequence(seed=5,
tex_size=1024, q_max=48, mip_levels=4, noise_sigma=0)` at 376x1241):
  renderer          the card's frame against a float64 numpy ray tracer:
                    fewer than 0.5% of pixels past 8 gray levels;
  fast_score        K2 against its plain version (`check_fast`);
  fast_select       the selection kernel against the plain sort path;
  brief_determinism BRIEF descriptors of one detection twice, equal;
  hamming           K3 against a numpy popcount on 256 descriptors, and
                    against its plain version (`check_hamming`);
  lk_level          K1 against its plain version (`check_lk`);
  pose_gn           K4 against its plain version on a seeded problem and
                    on a real step's solve inputs (`pose_gn_parity`);
  window_gn         K5 against JAX's recorded window solves
                    (`check_window_gn_goldens`) and against its plain
                    version on the full-width one (`window_gn_parity`).
Parity only (the `*_parity` functions): no timing, so a profiler that
drops events cannot fail the guard. Prints one JSON line a check and a
summary line; exits 1 if any check failed or could not run, 2 without a
card. Nothing is skipped.

This module is also the one copy of the kernel checks and their
measurements that `chip_smoke.py` phase 3 and `tests/test_torch_kernels.py`
use: each `check_*` runs its `*_parity` (which raises RuntimeError when
the kernel breaks a stated tolerance), then returns the kernel's device time (profiler events of its own
name), call time (CUDA events, host issue included), the plain version's
time, the least time the card could take for the same work (bound) and a
PyTorch library call's time where one computes the same function.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.ba import window
from ya_vo_tpu_torch.config import VOConfig, with_option
from ya_vo_tpu_torch.features import brief, fast, fast_cuda, hamming_cuda
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.tracking import lk, lk_cuda, pose_solver
from ya_vo_tpu_torch.tracking.frontend import detect_kwargs, gn_kwargs
from ya_vo_tpu_torch.utils import scene, synthetic
from ya_vo_tpu_torch.utils.convert import offsets_from_numpy

REPS = 20
PROFILE_TRIES = 3

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

# K4 against its plain version on the same inputs: rotation entries within
# POSE_R_TOL, translation within POSE_T_TOL * (1 + |t|), final_cost within
# POSE_COST_RTOL of the plain value, iterations equal or one off (a step
# norm within float noise of the 1e-5 exit can end the loop one iteration
# apart under two summation orders; the poses then differ by that step),
# the inlier mask equal but on points whose chi2 under either pose lies
# within POSE_CHI2_RTOL of chi2_threshold, and n_inliers off by at most
# their number. Two kernel calls are equal bit for bit.
# A problem with fewer than POSE_MIN_VALID valid points at T_init is
# degenerate: H's rank is at most 4 and the damping (1e-6) lies below
# float32's resolution of its ~1e6 eigenvalues, so a step's part along the
# null space is set by rounding. That part decides whether the guard
# (|dx| < 1) zeroes a step, and when a step norm falls to the 1e-5 exit,
# so the pose, the iterations and the inliers follow rounding: on the card
# the plain version parts from itself on the CPU as K4 parts from it
# (tests/test_torch_kernels.py prints both over 40 seeded problems). What
# rounding leaves fixed is the step's part that the valid points see: each
# version's first step, where the guard did not zero it, solves the linear
# model, r + J dx at T_init within POSE_LIN_RTOL of max |r| on the valid
# points; and each version's final cost is at most the cost at T_init.
POSE_MIN_VALID = 3
POSE_R_TOL = 1e-5
POSE_T_TOL = 1e-5
POSE_COST_RTOL = 1e-5
POSE_CHI2_RTOL = 1e-4
POSE_LIN_RTOL = 1e-2

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

# Operations of pose GN, counted from the plain version's arithmetic: a
# valid point an iteration (transform 18, projection and residual 10, J 14,
# chi2 3, weights 9, J * w 12, H's 21 and b's 6 entries at 4 each), an
# iteration's 6x6 solve, guard and exponential, and a point of the
# epilogue (transform, projection, chi2, gates, Huber cost and its sum).
POSE_POINT_OPS = 18 + 10 + 14 + 3 + 9 + 12 + 27 * 4
POSE_SOLVE_OPS = 6 ** 3 + 20 + 150
POSE_FINAL_OPS = 18 + 10 + 3 + 4 + 7 + 2

# the renderer against the float64 tracer (tools/selfcheck.py's gate)
RENDER_DIFF, RENDER_FRAC = 8, 0.005


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
    count (the profiler may drop an event of a long run).

    The profiler can lose a whole session's device events (seen once on an
    H100 for K1, in a run whose other sessions all had theirs): a session
    without them is repeated, up to PROFILE_TRIES sessions in all, and if
    none has any, the time is taken with CUDA events (`time_ms`, host
    issue included). A line on stderr tells of each lost session."""
    for attempt in range(1, PROFILE_TRIES + 1):
        evs = [e for e in profiled_events(fn, reps)
               if e.device_type == DeviceType.CUDA
               and (kernel is None or kernel in e.name)]
        if evs:
            break
        print(f"device_ms: the profiler saw no device events of {kernel} "
              f"in session {attempt} of {PROFILE_TRIES}", file=sys.stderr,
              flush=True)
    else:
        ms = time_ms(fn, reps)
        print(f"device_ms: {kernel} timed by CUDA events instead: {ms} ms",
              file=sys.stderr, flush=True)
        return ms
    total_us = sum(e.time_range.end - e.time_range.start for e in evs)
    if launches_per_call is not None:
        check(len(evs) <= reps * launches_per_call,
              f"{kernel}: {len(evs)} device events in {reps} calls, "
              f"expected {launches_per_call} a call")
        return total_us / len(evs) * launches_per_call / 1e3
    return total_us / reps / 1e3


def call_costs(fn, reps: int = REPS) -> dict:
    """A call of fn: its device ms (all its device events: kernels,
    copies, memsets), device events and CUDA runtime launch calls, and its
    call ms (CUDA events, host issue included), each the mean over
    `reps` calls."""
    evs = profiled_events(fn, reps)
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    n_launch = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith("cudaLaunch") for e in evs)
    return dict(device_ms=sum(e.time_range.end - e.time_range.start
                              for e in dev) / reps / 1e3,
                device_events=len(dev) / reps,
                runtime_launches=n_launch / reps,
                call_ms=time_ms(fn, reps))


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


def fast_work(img, args) -> dict:
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


def _fast_args(kw) -> dict:
    return dict(threshold=float(kw["threshold"]), arc_length=kw["arc_length"],
                harris_k=kw["harris_k"], nms_radius=kw["nms_radius"])


def fast_parity(img, kw):
    """K2 on the uint8 frame with the main path's parameters `kw`: the map
    (the kernel at border 0, scattered) equal to the plain map bit for bit
    on the whole frame, edges included; the candidates inside the border
    equal to the plain ones as a set, scores bit for bit. Returns the
    results and the kernel's candidates."""
    args = _fast_args(kw)
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
    return dict(max_abs_err=0.0, map_px_differ=n_map_diff,
                n_map_kept=int((plain > fast_cuda.NEG / 2).sum()),
                n_candidates=n), cand


def check_fast(img, kw):
    """`fast_parity`, then K2's costs on this frame. Returns the results
    and the kernel's candidates."""
    out, cand = fast_parity(img, kw)
    args, border, n = _fast_args(kw), kw["border"], out["n_candidates"]

    def kernel():
        return fast_cuda.fast_candidates(img, border=border, **args)

    # uint8 in, (score, index) of each candidate and the count out; the
    # operations this frame needs (fast_work)
    work = fast_work(img, args)
    nms_ops = (2 * kw["nms_radius"] + 1) ** 2 + 1 + 4
    bound_ms, bound_by = bound(
        img.numel() + 8 * n + 4,
        work["pixels"] * FAST_PRE_OPS + work["pretest"] * FAST_RING_OPS
        + work["corners"] * (FAST_HARRIS_OPS + nms_ops), F32_OPS_S)
    return dict(out, **work,
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


def select_parity(cand, kw, H, W) -> dict:
    """`fast_select` against the plain sort path, slot for slot, on K2's
    candidates, and one `torch.topk` over the candidates' unique keys
    picking the same candidates in the same order."""
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
    return dict(max_abs_err=0.0, n_candidates=n, k=K)


def check_select(cand, kw, H, W):
    """`select_parity`, then the selection's costs; its yardstick is one
    `torch.topk` over the candidates' unique keys."""
    out = select_parity(cand, kw, H, W)
    K, n = out["k"], out["n_candidates"]
    keys, m = topk_keys(cand), min(K, n)

    def kernel():
        return fast_cuda.select_top_k(*cand, H=H, W=W, k=K)

    # the candidates and the count in, K slots (uv, score, mask) out; the
    # compares of a comparison sort of the candidates
    bound_ms, bound_by = bound(8 * n + 4 + K * (8 + 4 + 1),
                               n * max(1, int(np.ceil(np.log2(max(n, 2))))),
                               F32_OPS_S)
    return dict(out,
                device_ms=device_ms(kernel, "fast_select_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: fast_cuda.select_top_k_plain(
                    *cand, H=H, W=W, k=K)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=device_ms(lambda: torch.topk(keys, m)))


def check_detect(img, kw):
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
    return dict(n_valid=int(plain.mask.sum()), kernels_a_call=kernels,
                **call_costs(lambda: fast.detect(img, **kw)))


def hamming_parity(d1, d2) -> dict:
    """K3 against its plain version on (d1, d2) and on random descriptors:
    equal."""
    gen = torch.Generator().manual_seed(0)
    r1, r2 = (torch.randint(-2 ** 31, 2 ** 31, (2048, 8), generator=gen,
                            dtype=torch.int64).to(d1.device, torch.int32)
              for _ in range(2))
    err = 0
    for a, b in ((d1, d2), (r1, r2)):
        k = hamming_cuda.hamming_matrix(a, b)
        p = hamming_cuda.hamming_matrix_plain(a, b)
        err = max(err, (k - p).abs().max().item())
    check(err == 0, f"hamming: kernel differs from plain by {err}")
    return dict(max_abs_err=err)


def check_hamming(d1, d2):
    """`hamming_parity`, then K3's costs on (d1, d2)."""
    out = hamming_parity(d1, d2)
    kernel = lambda: hamming_cuda.hamming_matrix(d1, d2)  # noqa: E731
    (K1, n_words), K2 = d1.shape, d2.shape[0]
    n_bits = 32 * n_words
    bound_ms, bound_by = bound(4 * (K1 + K2) * n_words + 4 * K1 * K2,
                               2 * K1 * K2 * n_bits, INT8_OPS_S)
    return dict(out,
                device_ms=device_ms(kernel, "hamming_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(
                    lambda: hamming_cuda.hamming_matrix_plain(d1, d2)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=hamming_library_ms(d1, d2))


def hamming_library_ms(d1, d2):
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


def lk_parity(img0, img1, uv0, mask, seed=None):
    """K1 against its plain version (`compare_lk`) on the keypoints uv0
    (seeded at `seed`, default uv0) with border clamps and dead slots
    among them, held to the stated tolerances. Returns (errors by level,
    tracker errors, the pyramids, the cases)."""
    H, W = img0.shape
    cases = lk_edge_cases(uv0, uv0 if seed is None else seed, mask, H, W)
    per_level, pyrs, tracker = compare_lk(img0, img1, *cases)
    print("kernel lk_level errors: " + json.dumps(
        dict(per_level=per_level, tracker=tracker)), flush=True)
    bad = lk_problems(per_level, tracker)
    check(not bad, "lk: " + "; ".join(bad))
    return per_level, tracker, pyrs, cases


def lk_summary(per_level, tracker) -> dict:
    return dict(max_abs_err=max(s["max_duv"] for s in per_level.values()),
                **{f"track_{k}": v for k, v in tracker.items()},
                iterations=sum(s["iterations"]
                               for s in per_level.values()))


def check_lk(img0, img1, uv0, mask, seed=None):
    """`lk_parity`, then K1's costs on these inputs."""
    per_level, tracker, (pyr0, pyr1), cases = lk_parity(img0, img1, uv0,
                                                         mask, seed)
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
    return dict(lk_summary(per_level, tracker),
                device_ms=device_ms(kernel, "lk_pyramid_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(plain, reps=5),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def template_lk_inputs(frames, cam, ahead: int = 4, device="cuda") -> dict:
    """K1's inputs under each LK template on `frames` (the stamps world):
    a frontend at VOConfig() with window BA off bootstraps on frames 0-1,
    then, from its device chain, the frontend's own `lk_inputs` for
    "anchor": the keyframe image (frame 1) and frame 1 + `ahead`, at the
    pose the constant-velocity prior extrapolates over `ahead` frames;
    "prev": frame 1 and frame 2. Each is (template image, image, uv, mask,
    seed)."""
    from ya_vo_tpu_torch.tracking.frontend import Frontend, lk_inputs

    fe = Frontend(with_option(VOConfig(), "ba", enabled=False), cam,
                  device=device)
    for img in frames[:2]:
        fe.process(img)
    check(fe.status.name == "TRACKING", "template inputs: no bootstrap")
    kf_img = fe._d_kf_img.float()
    out = {}
    for name, f, rel in (("anchor", 1 + ahead,
                          torch.linalg.matrix_power(fe._d_rel, ahead)),
                         ("prev", 2, fe._d_rel)):
        # frame 1 is both the keyframe and the previous frame
        tmpl_img, uv, seed, use = lk_inputs(
            name, cam, fe._d_pose, rel, fe._d_lm_pos, fe._d_track_uv,
            fe._d_anchor_uv, fe._d_track_valid, kf_img, kf_img)
        img = torch.as_tensor(np.asarray(frames[f])).to(device).float()
        out[name] = (tmpl_img, img, uv, use, seed)
    return out


def check_lk_templates(frames, cam, ahead: int = 4) -> dict:
    """`check_lk` at each LK template's inputs (`template_lk_inputs`):
    level by level against the plain version at the stated tolerances, and
    K1's device time and iterations under each."""
    out = {}
    for name, (img0, img1, uv, mask, seed) in template_lk_inputs(
            frames, cam, ahead).items():
        out[name] = check_lk(img0, img1, uv.contiguous(), mask,
                             seed.contiguous())
        out[name]["n_tracked"] = int(mask.sum())
    return out


# ---------------------------------------------------------------------------
# K4: pose GN
# ---------------------------------------------------------------------------
def pose_gn_problem(n: int = 2048, seed: int = 0, *, outliers: float = 0.05,
                    holes: float = 0.1, behind: int = 8, n_valid=None,
                    device="cuda"):
    """A seeded pose problem of `n` points at the KITTI camera: landmarks in
    front of the true pose (frame 1 of a forward trajectory) observed with
    0.5 px noise, a fraction `outliers` of them moved by up to 30 px,
    `holes` of the mask cleared, `behind` points placed behind the camera
    (Z <= 1e-3, invalid though masked in), and T_init the true pose
    perturbed by a seeded twist; with `n_valid`, only that many mask
    entries kept. Returns (T_init, pts_w, uv, mask, cam)."""
    rng = np.random.default_rng(seed)
    cam = synthetic.kitti_camera()
    T_gt = synthetic.forward_trajectory(2, step=0.7, yaw_rate=0.03)[1]
    pts = synthetic.random_landmarks(n, seed=seed)
    pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv = uv + rng.normal(0.0, 0.5, uv.shape)
    bad = rng.choice(n, int(outliers * n), replace=False)
    uv[bad] += rng.uniform(-30.0, 30.0, (len(bad), 2))
    mask = rng.random(n) >= holes
    back = rng.choice(n, min(behind, n), replace=False)
    pts[back, 2] = -rng.uniform(1.0, 10.0, len(back))
    if n_valid is not None:
        keep = rng.choice(np.setdiff1d(np.arange(n), back),
                          min(n_valid, n - len(back)), replace=False)
        mask[:] = False
        mask[keep] = True
    xi = rng.normal(0.0, 1.0, 6) * np.array([0.05, 0.05, 0.1, 4e-3, 4e-3,
                                             4e-3])
    T_init = lie.se3_exp(torch.as_tensor(xi)).numpy() @ T_gt
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a)).to(device, dt)
    return as_t(T_init), as_t(pts), as_t(uv), as_t(mask, torch.bool), cam


def textured_solve_inputs(warm: int = 8, device="cuda", **world):
    """A real step's solve inputs on chip_smoke.py phase 8's world
    (`TexturedSequence(n_frames=410, seed=5)`, VOConfig(), K_cap 2048;
    `world` overrides the sequence's arguments, the config follows its
    size): after `warm` processed frames, the constant-velocity prior, the
    track table's landmarks, the LK flow and its status that the fused
    step hands `solve_pose` on frame `warm`. Returns (T_prior, lm_pos, uv,
    status, cam, gn_kwargs)."""
    from ya_vo_tpu_torch import profile_step
    from ya_vo_tpu_torch.tracking.frontend import Frontend

    seq = scene.TexturedSequence(**dict(dict(n_frames=410, seed=5), **world),
                                 device=device)
    fe = Frontend(VOConfig(image_height=seq.height, image_width=seq.width),
                  seq.cam, device=device)
    st = profile_step.snapshot(*profile_step.prepare(fe, seq.frame, warm))
    x = profile_step.chain(fe, st)
    return (x["T_prior"], st.args[6], x["flow"].uv, x["flow"].status,
            seq.cam, gn_kwargs(fe.cfg.tracking))


def pose_gn_parity(T_init, pts, uv, mask, cam, **gn) -> dict:
    """K4 against `solve_pose_plain` on the same CUDA inputs, held to the
    stated tolerances, and two kernel calls bit for bit. Returns the
    errors and both versions' iterations."""
    k, k_it = pose_solver.solve_pose(T_init, pts, uv, mask, cam,
                                     with_iters=True, **gn)
    k2 = pose_solver.solve_pose(T_init, pts, uv, mask, cam, **gn)
    if T_init.is_cuda:
        sync_within(f"pose_gn at N = {len(mask)}")
    check(all(bits_equal(a, b) for a, b in zip(k, k2)),
          "pose_gn: two calls on the same inputs differ")
    p, p_it = pose_solver.solve_pose_plain(T_init, pts, uv, mask, cam,
                                           with_iters=True, **gn)
    thr = gn.get("chi2_threshold", 5.991)
    Z0 = pose_solver._residuals_and_jacobian(T_init, pts, uv, cam)[2]
    n_valid = int((mask & (Z0 > 1e-3)).sum())
    degenerate = n_valid < POSE_MIN_VALID
    t_p = p.pose[:3, 3]
    rot = (k.pose[:3, :3] - p.pose[:3, :3]).abs().max().item()
    trans = (k.pose[:3, 3] - t_p).abs().max().item()
    t_tol = POSE_T_TOL * (1.0 + t_p.norm().item())
    near = torch.zeros_like(mask)
    for T in (k.pose, p.pose):
        r = pose_solver._residuals_and_jacobian(T, pts, uv, cam)[0]
        near |= ((r * r).sum(-1) - thr).abs() <= POSE_CHI2_RTOL * thr
    flips = k.inlier_mask != p.inlier_mask
    n_near = int(near.sum())
    d_cost = abs(k.final_cost.item() - p.final_cost.item())
    out = dict(max_abs_err=max(rot, trans), rot_err=rot, trans_err=trans,
               trans_tol=t_tol, cost=p.final_cost.item(),
               cost_rel_err=d_cost / max(abs(p.final_cost.item()), 1e-30),
               iterations=int(k_it), iterations_plain=int(p_it),
               n_inliers=int(k.n_inliers), n_inliers_plain=int(p.n_inliers),
               inlier_flips=int(flips.sum()),
               flips_off_threshold=int((flips & ~near).sum()),
               near_threshold=n_near, n_points=len(mask),
               n_masked_in=int(mask.sum()), n_valid_init=n_valid,
               degenerate=degenerate)
    bad = []
    if degenerate:
        out.update(first_steps(T_init, pts, uv, mask, cam, **gn))
        for name in ("kernel", "plain"):
            lin = out[f"first_step_{name}"]
            if lin != "zero" and lin > POSE_LIN_RTOL * out["res_init"]:
                bad.append(f"the {name} version's first step leaves "
                           f"{lin} px of its linear model (max |r| "
                           f"{out['res_init']} at T_init)")
        cost0 = pose_solver.solve_pose_plain(T_init, pts, uv, mask, cam,
                                             **dict(gn, iters=0)).final_cost
        out["cost_init"] = cost0.item()
        out["cost_kernel"] = k.final_cost.item()
        if not (k.final_cost <= cost0 and p.final_cost <= cost0):
            bad.append(f"final_cost {k.final_cost.item()} (plain "
                       f"{p.final_cost.item()}) above {cost0.item()} at "
                       f"T_init")
        check(not bad, "pose_gn: " + "; ".join(bad))
        return out
    if rot > POSE_R_TOL:
        bad.append(f"rotation off by {rot}")
    if trans > t_tol:
        bad.append(f"translation off by {trans} (tolerance {t_tol})")
    if d_cost > POSE_COST_RTOL * abs(p.final_cost.item()):
        bad.append(f"final_cost {k.final_cost.item()} against "
                   f"{p.final_cost.item()}")
    if abs(out["iterations"] - out["iterations_plain"]) > 1:
        bad.append(f"{out['iterations']} iterations against "
                   f"{out['iterations_plain']}")
    if out["flips_off_threshold"]:
        bad.append(f"{out['flips_off_threshold']} inlier flips away from "
                   f"the chi2 threshold")
    if abs(out["n_inliers"] - out["n_inliers_plain"]) > n_near:
        bad.append(f"n_inliers {out['n_inliers']} against "
                   f"{out['n_inliers_plain']}")
    check(not bad, "pose_gn: " + "; ".join(bad))
    return out


def first_steps(T_init, pts, uv, mask, cam, **gn) -> dict:
    """Each version's first step (`iters=1`) against the linear model at
    T_init: "zero" where the pose is T_init bit for bit (the guard zeroed
    the step, or the step was 0), else max |r + J dx| over the points valid at T_init, in float64
    with dx = log(T_1 T_init^-1); and max |r| there (`res_init`)."""
    gn = dict(gn, iters=1)
    r, J, Z = pose_solver._residuals_and_jacobian(
        T_init.double().cpu(), pts.double().cpu(), uv.double().cpu(), cam)
    valid = mask.cpu() & (Z > 1e-3)
    T0_inv = lie.se3_inverse(T_init.double().cpu())
    out = dict(res_init=float(r[valid].abs().max()) if valid.any() else 0.0)
    for name, solve in (("kernel", pose_solver.solve_pose),
                        ("plain", pose_solver.solve_pose_plain)):
        T1 = solve(T_init, pts, uv, mask, cam, **gn).pose
        dx = lie.se3_log(T1.double().cpu() @ T0_inv)
        lin = (r + J @ dx)[valid]
        out[f"first_step_{name}"] = (
            "zero" if torch.equal(T1, T_init)
            else float(lin.abs().max()) if valid.any() else 0.0)
    return out


def check_pose_gn(T_init, pts, uv, mask, cam, **gn) -> dict:
    """`pose_gn_parity`, then K4's costs on these inputs: device ms (its
    own events), call ms, launches a call, the plain version's ms and the
    bound for the iterations the kernel ran."""
    out = pose_gn_parity(T_init, pts, uv, mask, cam, **gn)

    def kernel():
        return pose_solver.solve_pose(T_init, pts, uv, mask, cam, **gn)

    before = _build.LAUNCHES["pose_gn"]
    kernel()
    launches = _build.LAUNCHES["pose_gn"] - before
    check(launches == 1, f"pose_gn: {launches} launches a call")
    # T_init, the points, their observations and mask read once; the pose,
    # the inlier mask, the count, the cost and the iterations written once;
    # the operations of the iterations the kernel ran on these inputs, over
    # the points valid at T_init (a masked point has weight 0: it adds
    # nothing to H, b or the cost and is never an inlier)
    n, n_valid = len(mask), out["n_valid_init"]
    n_bytes = 64 + n * (12 + 8 + 1) + 64 + n + 8 + 4 + 4
    n_ops = out["iterations"] * (n_valid * POSE_POINT_OPS + POSE_SOLVE_OPS) \
        + n_valid * POSE_FINAL_OPS
    bound_ms, bound_by = bound(n_bytes, n_ops, F32_OPS_S)
    return dict(out, launches_a_call=launches,
                device_ms=device_ms(kernel, "pose_gn_kernel",
                                    launches_per_call=1),
                call_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: pose_solver.solve_pose_plain(
                    T_init, pts, uv, mask, cam, **gn), reps=5),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ---------------------------------------------------------------------------
# K4's recorded cases: solve inputs kept as files, and the outputs of the
# first K4 (one block of 256 threads) on every case, bit for bit
# ---------------------------------------------------------------------------
# step.npz: a real step's inputs (`textured_solve_inputs`); capped_*.npz:
# solves of chip_smoke.py phase 8's frames that ran to the 40-iteration
# cap; golden.npz: `record_pose_gn_goldens`' outputs (`port_pose_gn.py`)
POSE_DATA = (Path(__file__).resolve().parent.parent / "tests" / "torch_data"
             / "pose_gn")
POSE_GOLDEN = POSE_DATA / "golden.npz"
POSE_GOLDEN_ITERS = (1, 3, 40)
POSE_OUTPUTS = ("pose", "inliers", "n_inliers", "final_cost", "iterations")
# `pose_gn_problem`'s arguments of the seeded cases: N on both sides of
# 2048 (a round of the cluster) and past two rounds, every point masked
# out, and the degenerate one- and two-point problems over 20 seeds
POSE_GOLDEN_SEEDED = dict(
    n2048={}, n1000=dict(n=1000, seed=1), n37=dict(n=37, seed=2),
    n1792=dict(n=1792, seed=5), n2049=dict(n=2049, seed=6),
    n3000=dict(n=3000, seed=4), n6000=dict(n=6000, seed=7),
    all_masked=dict(n_valid=0),
    **{f"valid{v}_seed{s}": dict(n_valid=v, seed=s)
       for v in (1, 2) for s in range(20)})
SYNC_TIMEOUT_S = 60.0


def sync_within(what: str, seconds: float = SYNC_TIMEOUT_S) -> None:
    """Wait for the current stream's work, at most `seconds`; past that,
    print and end the process: a cluster whose blocks wait on each other
    forever leaves the card's context unusable, so nothing later could
    run."""
    done = torch.cuda.Event()
    done.record()
    t_end = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > t_end:
            print(f"{what}: the card has not finished after {seconds} s",
                  file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(1e-4)


def pose_inputs_arrays(T_init, pts, uv, mask, cam, gn: dict,
                       prefix: str = "") -> dict:
    """One solve's inputs as numpy arrays keyed `<prefix><name>`: the four
    tensors, the camera's intrinsics and the GN keywords (JSON)."""
    arrays = dict(T_init=T_init.cpu().numpy(), pts_w=pts.cpu().numpy(),
                  uv=uv.cpu().numpy(), mask=mask.cpu().numpy(),
                  cam=np.asarray(cam, np.float64),
                  gn=np.asarray(json.dumps(gn)))
    return {prefix + k: v for k, v in arrays.items()}


def save_pose_inputs(path, T_init, pts, uv, mask, cam, gn: dict,
                     **extra) -> None:
    """One solve's inputs (`pose_inputs_arrays`) and `extra` arrays as
    npz."""
    np.savez_compressed(path, **pose_inputs_arrays(T_init, pts, uv, mask,
                                                   cam, gn), **extra)


def load_pose_inputs(path, device="cuda", prefix: str = ""):
    """(T_init, pts_w, uv, mask, cam, gn) of a `save_pose_inputs` file, or
    of the arrays keyed `<prefix><name>` in an open npz."""
    z = np.load(path) if isinstance(path, (str, Path)) else path
    ts = [torch.as_tensor(z[prefix + k]).to(device)
          for k in ("T_init", "pts_w", "uv", "mask")]
    out = (*ts, Camera.create(*z[prefix + "cam"]),
           json.loads(str(z[prefix + "gn"])))
    if z is not path:
        z.close()
    return out


def pose_gn_golden_cases(device="cuda", data=POSE_DATA):
    """K4's recorded cases, as (key, (T_init, pts, uv, mask, cam), gn):
    the problems of POSE_GOLDEN_SEEDED, one without points, and each
    inputs file in `data`, each at every `iters` of POSE_GOLDEN_ITERS."""
    def problems():
        for name, kw in POSE_GOLDEN_SEEDED.items():
            yield name, pose_gn_problem(device=device, **kw), {}
        T, *_, cam = pose_gn_problem(n=8, device=device)
        yield "n0", (T, torch.zeros((0, 3), device=device),
                     torch.zeros((0, 2), device=device),
                     torch.zeros(0, dtype=torch.bool, device=device),
                     cam), {}
        for path in sorted(Path(data).glob("*.npz")):
            if path.name != POSE_GOLDEN.name:
                *inputs, gn = load_pose_inputs(path, device)
                yield path.stem, tuple(inputs), gn

    for name, inputs, gn in problems():
        for iters in POSE_GOLDEN_ITERS:
            yield f"{name}_iters{iters}", inputs, dict(gn, iters=iters)


def pose_gn_outputs(T_init, pts, uv, mask, cam, **gn) -> dict:
    """`solve_pose`'s outputs and iterations as numpy arrays of their bits
    (floats viewed as int32, the inlier mask packed), keyed by
    POSE_OUTPUTS."""
    out, it = pose_solver.solve_pose(T_init, pts, uv, mask, cam,
                                     with_iters=True, **gn)
    if T_init.is_cuda:
        sync_within(f"pose_gn at N = {len(mask)}")
    as_bits = lambda t: t.contiguous().view(torch.int32).cpu().numpy()  # noqa: E731
    return dict(pose=as_bits(out.pose),
                inliers=np.packbits(out.inlier_mask.cpu().numpy()),
                n_inliers=np.int64(out.n_inliers.item()),
                final_cost=as_bits(out.final_cost),
                iterations=np.int64(int(it)))


def record_pose_gn_goldens(path, device="cuda", data=POSE_DATA) -> int:
    """Write every case's `pose_gn_outputs` to `path` (npz, keys
    `<case>:<output>`); returns the number of cases."""
    rec = {}
    for key, inputs, gn in pose_gn_golden_cases(device, data):
        for name, v in pose_gn_outputs(*inputs, **gn).items():
            rec[f"{key}:{name}"] = v
    np.savez_compressed(path, **rec)
    return len(rec) // len(POSE_OUTPUTS)


def check_pose_gn_goldens(path=POSE_GOLDEN, device="cuda",
                          prefixes=None) -> dict:
    """K4 against the recorded outputs, bit for bit: pose, inlier mask,
    n_inliers, final_cost and iterations, on every case (or those whose key
    starts with one of `prefixes`), one launch each."""
    pick = lambda key: prefixes is None or key.startswith(  # noqa: E731
        tuple(prefixes))
    bad, n = [], 0
    before = _build.LAUNCHES["pose_gn"]
    with np.load(path) as ref:
        n_ref = sum(pick(k) for k in ref.files) // len(POSE_OUTPUTS)
        for key, inputs, gn in pose_gn_golden_cases(device,
                                                    Path(path).parent):
            if not pick(key):
                continue
            got = pose_gn_outputs(*inputs, **gn)
            n += 1
            diff = [k for k, v in got.items()
                    if not np.array_equal(v, ref[f"{key}:{k}"])]
            if diff:
                bad.append(f"{key} ({', '.join(diff)})")
    launches = _build.LAUNCHES["pose_gn"] - before
    check(n == n_ref and n > 0,
          f"pose_gn goldens: {n} cases, {n_ref} recorded")
    check(launches == (n if device != "cpu" else 0),
          f"pose_gn goldens: {launches} launches for {n} calls")
    check(not bad, f"pose_gn: {len(bad)} of {n} cases differ from the "
          f"recorded outputs: {'; '.join(bad[:10])}")
    return dict(cases=n, differing=0, launches=launches)


# ---------------------------------------------------------------------------
# K5, the window BA's GN loop, against JAX's recorded solves and against
# the plain version
# ---------------------------------------------------------------------------
# tests/test_torch_ba.py's `compare`: poses within WINDOW_POSE_ATOL and
# landmarks within WINDOW_LM_ATOL of the reference solve, or within twice
# the reference's own distance to a float64 solve for as many iterations
# where that is larger (monocular windows leave landmarks weakly
# constrained along their rays, where float32 rounding moves every
# solve); cost_initial within rtol WINDOW_COST_RTOL and cost_final no
# worse than the reference's by more; every observation valid at the
# reference solution within WINDOW_REPROJ_PX of its reprojection there;
# equal valid observations and iterations. The frontend's windows hold
# their poses to WINDOW_POSE_ATOL outright.
WINDOW_POSE_ATOL, WINDOW_LM_ATOL = 1e-4, 1e-3
WINDOW_COST_RTOL, WINDOW_REPROJ_PX = 1e-4, 5e-2
# JAX's solves of window problems (tests/test_torch_window_gn.py records
# them): test_torch_ba.py's two synthetic windows and the JAX frontend's
# first two windows at the live settings, and one seeded problem at the
# main path's width (W 8, O 2048, L 4096)
WINDOW_DATA = (Path(__file__).resolve().parent.parent / "tests"
               / "torch_data" / "window_gn")
WINDOW_CASES = ("synthetic", "synthetic_noisy", "frontend0", "frontend1",
                "full_width")
WINDOW_STRICT_POSES = ("frontend0", "frontend1")
WINDOW_OUTPUTS = ("poses", "landmarks", "cost_initial", "cost_final",
                  "n_obs", "n_iters")
# Operations of the window solve, counted from the plain version's
# arithmetic: an observation's validity test (depth and flags), its cost
# (transform 18, projection and residual 10, chi2 and Huber 8), its GN
# terms (besides the cost: Jacobians 26, weights 18, Hll 27, bl 12, the
# cross block 54, Hpp 108, bp 24); a landmark seen in m keyframes: its
# sums and 3x3 inverse, (Wpl Hll^-1) 90 m, the m^2 6x6 blocks of S at 6
# an entry, b_red 36 m, Hpp and bp's sums 42 m, back-substitution 36 m +
# 20; a pose's exponential, logarithm and inverse
WIN_OBS_TEST_OPS = 8
WIN_OBS_COST_OPS = 18 + 10 + 8
WIN_OBS_TERM_OPS = 26 + 18 + 27 + 12 + 54 + 108 + 24
WIN_LM_OPS = 13 + 60 + 20
WIN_POSE_OPS = 150


def load_window_case(name: str, device="cuda", data=WINDOW_DATA):
    """(prob, cam, kw, ref) of a recorded case: the problem on `device`,
    the camera, the solve's keywords and JAX's solve as numpy arrays
    (WINDOW_OUTPUTS, and `poses_to_f64` / `landmarks_to_f64`: its distances
    to a float64 solve for as many iterations)."""
    with np.load(Path(data) / f"{name}.npz") as z:
        arrays = [torch.as_tensor(z[k]) for k in window.BAProblem._fields]
        arrays[5] = arrays[5].to(torch.int64)
        prob = window.BAProblem(*(a.to(device) for a in arrays))
        cam = Camera.create(*z["cam"])
        kw = json.loads(str(z["kw"]))
        ref = {k: z["ref_" + k] for k in WINDOW_OUTPUTS}
        ref.update(poses_to_f64=float(z["poses_to_f64"]),
                   landmarks_to_f64=float(z["landmarks_to_f64"]))
    return prob, cam, kw, ref


def window_reprojections(prob, cam, poses, landmarks):
    """Each observation slot's landmark projected at (poses, landmarks)."""
    X = landmarks[prob.obs_lm.clamp(min=0)]
    pc = torch.einsum("wij,woj->woi", poses[:, :3, :3], X) \
        + poses[:, None, :3, 3]
    return torch.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                        cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)


def hold_window_solution(prob, cam, kw: dict, out, ref: dict,
                         strict_poses: bool = False) -> dict:
    """`out` (a BAResult) against the reference solve `ref` (WINDOW_OUTPUTS
    as tensors or arrays, and its distances to a float64 solve) at the
    tolerances above; raises RuntimeError past one. Returns the
    differences."""
    def as_np(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) \
            else np.asarray(t)

    d = dict(n_iters=int(out.n_iters), ref_n_iters=int(ref["n_iters"]))
    bad = []
    if d["n_iters"] != d["ref_n_iters"]:
        bad.append(f"{d['n_iters']} iterations, reference "
                   f"{d['ref_n_iters']}")
    for name, atol in (("poses", WINDOW_POSE_ATOL),
                       ("landmarks", WINDOW_LM_ATOL)):
        err = float(np.abs(as_np(getattr(out, name)).astype(np.float64)
                           - as_np(ref[name])).max())
        tol = atol if name == "poses" and strict_poses \
            else max(atol, 2 * ref[name + "_to_f64"])
        d[name], d[name + "_tol"] = err, tol
        if not err <= tol:
            bad.append(f"{name} off by {err} (tolerance {tol})")
    c0, r0 = float(out.cost_initial), float(ref["cost_initial"])
    c1, r1 = float(out.cost_final), float(ref["cost_final"])
    d["cost_initial_rel"] = abs(c0 - r0) / max(abs(r0), 1e-30)
    d["cost_final"], d["ref_cost_final"] = c1, r1
    if not d["cost_initial_rel"] <= WINDOW_COST_RTOL:
        bad.append(f"cost_initial {c0}, reference {r0}")
    if not c1 <= r1 * (1 + WINDOW_COST_RTOL):
        bad.append(f"cost_final {c1}, reference {r1}")
    d["n_obs"] = int(out.n_obs)
    if d["n_obs"] != int(ref["n_obs"]):
        bad.append(f"{d['n_obs']} observations, reference {int(ref['n_obs'])}")
    dev = prob.poses.device
    ref_poses = torch.as_tensor(as_np(ref["poses"]), device=dev)
    ref_lms = torch.as_tensor(as_np(ref["landmarks"]), device=dev)
    seg = window.segments(prob.obs_lm, prob.landmarks.shape[0])
    valid = window._obs_terms(ref_poses, ref_lms, prob, cam,
                              kw["huber_delta"], seg)[-1]
    uv = window_reprojections(prob, cam, out.poses, out.landmarks)
    uv_ref = window_reprojections(prob, cam, ref_poses, ref_lms)
    d["reproj_px"] = float((uv - uv_ref).norm(dim=-1)[valid].max()) \
        if bool(valid.any()) else 0.0
    if not d["reproj_px"] <= WINDOW_REPROJ_PX:
        bad.append(f"reprojections off by {d['reproj_px']} px")
    check(not bad, "window_gn: " + "; ".join(bad))
    return d


def _as_float64(prob):
    return window.BAProblem(*(t.double() if t.is_floating_point() else t
                              for t in prob))


def plain_reference(prob, cam, **kw) -> dict:
    """`solve_window_plain`'s solve of `prob` as a reference for
    `hold_window_solution`, with its distances to the float64 plain solve
    for as many iterations."""
    p = window.solve_window_plain(prob, cam, **kw)
    exact = window.solve_window_plain(
        _as_float64(prob), cam, **dict(kw, iters=p.n_iters, rel_tol=-1.0))
    return dict(poses=p.poses, landmarks=p.landmarks,
                cost_initial=p.cost_initial, cost_final=p.cost_final,
                n_obs=p.n_obs, n_iters=p.n_iters,
                poses_to_f64=(p.poses.double() - exact.poses).abs()
                .max().item(),
                landmarks_to_f64=(p.landmarks.double() - exact.landmarks)
                .abs().max().item())


def window_gn_parity(prob, cam, **kw) -> dict:
    """K5 (`solve_window` on the card) against `solve_window_plain` on the
    same problem at `hold_window_solution`'s tolerances, and two K5 calls
    bit for bit. Returns the differences, both versions' iterations and
    K5's launches a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    before = _build.LAUNCHES["window_gn"]
    a = window.solve_window(prob, cam, **kw)
    b = window.solve_window(prob, cam, **kw)
    launches = (_build.LAUNCHES["window_gn"] - before) / 2
    if prob.poses.is_cuda:
        sync_within("window_gn")
    check(all(bits_equal(x, y) for x, y in zip(a[:5], b[:5]))
          and int(a.n_iters) == int(b.n_iters),
          "window_gn: two calls on the same problem differ")
    d = hold_window_solution(prob, cam, kw, a, plain_reference(prob, cam,
                                                               **kw))
    return dict(d, max_abs_err=max(d["poses"], d["landmarks"]),
                launches_a_call=launches,
                n_landmarks=int(prob.lm_valid.sum()),
                shape=dict(W=prob.poses.shape[0], O=prob.obs_lm.shape[1],
                           L=prob.landmarks.shape[0]))


def window_gn_work(prob, cam, n_iters: int, huber_delta: float) -> dict:
    """What K5's bound counts on this problem for `n_iters` iterations:
    bytes (the inputs read once, the outputs written once) and operations
    (WIN_* above, over the observations with a landmark, those valid at
    the input and each landmark's keyframes with a valid observation)."""
    W, O = prob.obs_lm.shape
    L = prob.landmarks.shape[0]
    seg = window.segments(prob.obs_lm, L)
    valid = window._obs_terms(prob.poses, prob.landmarks, prob, cam,
                              huber_delta, seg)[-1].cpu().numpy()
    lm = prob.obs_lm.cpu().numpy()
    n_in = int((lm >= 0).sum())
    n_valid = int(valid.sum())
    kf = np.broadcast_to(np.arange(W)[:, None], (W, O))
    seen = np.zeros((L, W), bool)
    seen[lm[valid], kf[valid]] = True
    m = seen.sum(1).astype(np.int64)
    n = 6 * W
    lu = n * n * 3 + sum((n - k - 1) * (n - k) * 3 for k in range(n))
    per_iter = (3 * n_in * WIN_OBS_TEST_OPS
                + n_valid * (WIN_OBS_TERM_OPS + 3 * WIN_OBS_COST_OPS)
                + int((m > 0).sum()) * WIN_LM_OPS
                + int((90 * m + 216 * m * m + 36 * m + 42 * m + 36 * m)
                      .sum())
                + lu + W * 3 * WIN_POSE_OPS)
    n_ops = n_iters * per_iter + 2 * (n_in * WIN_OBS_TEST_OPS
                                      + n_valid * WIN_OBS_COST_OPS) \
        + W * WIN_POSE_OPS
    n_bytes = (W * (64 + 1) + L * (12 + 1) + W * O * (8 + 8 + 1)
               + W * 64 + L * 12 + 4 + 4 + 8 + 4)
    return dict(n_bytes=n_bytes, n_ops=n_ops, observations=n_in,
                valid_observations=n_valid,
                landmarks_seen=int((m > 0).sum()),
                mean_keyframes_a_landmark=float(m[m > 0].mean())
                if (m > 0).any() else 0.0, iterations=n_iters)


def check_window_gn(prob, cam, **kw) -> dict:
    """`window_gn_parity`, then K5's costs on this problem: its own device
    ms, the whole solve's device ms (the layout's sort and search too) and
    call ms, launches a call, the plain version's ms, and the bound for
    the iterations K5 ran with its share of K5's device ms."""
    out = window_gn_parity(prob, cam, **kw)

    def solve():
        return window.solve_window(prob, cam, **kw)

    work = window_gn_work(prob, cam, out["n_iters"], kw["huber_delta"])
    bound_ms, bound_by = bound(work["n_bytes"], work["n_ops"], F32_OPS_S)
    k5_ms = device_ms(solve, "window_gn_kernel", launches_per_call=1)
    return dict(out, work=work, device_ms=k5_ms,
                solve_device_ms=device_ms(solve),
                call_ms=time_ms(solve),
                plain_ms=time_ms(lambda: window.solve_window_plain(
                    prob, cam, **kw), reps=3),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / k5_ms, library_ms=None)


def check_window_gn_goldens(device="cuda", cases=WINDOW_CASES,
                            data=WINDOW_DATA) -> dict:
    """`solve_window` on `device` (K5 on the card) against JAX's recorded
    solve of each case at `hold_window_solution`'s tolerances, one K5
    launch a solve on the card."""
    out = {}
    for name in cases:
        prob, cam, kw, ref = load_window_case(name, device, data)
        before = _build.LAUNCHES["window_gn"]
        res = window.solve_window(prob, cam, **kw)
        launches = _build.LAUNCHES["window_gn"] - before
        if prob.poses.is_cuda:
            sync_within(f"window_gn golden {name}")
        check(launches == (0 if device == "cpu" else 1),
              f"window_gn golden {name}: {launches} launches")
        out[name] = hold_window_solution(
            prob, cam, kw, res, ref,
            strict_poses=name in WINDOW_STRICT_POSES)
    return out


# ---------------------------------------------------------------------------
# the renderer, BRIEF and K3 against numpy
# ---------------------------------------------------------------------------
def parity_sequence(device="cuda") -> scene.TexturedSequence:
    """The selfcheck's world: bench's seed with a 1024-texel atlas, 48
    quads and 4 mips (parity does not depend on the atlas size), at
    376x1241, without sensor noise."""
    return scene.TexturedSequence(n_frames=3, seed=5, noise_sigma=0.0,
                                  tex_size=1024, q_max=48, mip_levels=4,
                                  device=device)


def render_reference(seq, f: int = 0) -> np.ndarray:
    """Frame `f` of `seq` (ss 1, gain and bias of frame 0, no noise) ray
    cast in float64 numpy, quad by quad (tools/selfcheck.py's tracer)."""
    culled = scene.cull_quads(seq.quads, seq.poses[f], seq.q_max)
    K_inv = np.asarray(seq.K_inv, np.float64)
    pose = seq.poses[f].astype(np.float64)
    H, W = seq.height, seq.width
    R, t = pose[:3, :3], pose[:3, 3]
    cw = -R.T @ t
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    d_cam = np.stack([uu, vv, np.ones_like(uu)], -1) @ K_inv.T
    d_w = d_cam @ R

    bt = np.full((H, W), 1e9)
    ba = np.zeros((H, W)); bb = np.zeros((H, W))
    brect = np.zeros((H, W, 4)); bden = np.zeros((H, W))
    for q in range(len(culled.origin)):
        if not culled.valid[q]:
            continue
        o = culled.origin[q].astype(np.float64)
        v1 = culled.e1[q].astype(np.float64)
        v2 = culled.e2[q].astype(np.float64)
        rect = culled.atlas[q].astype(np.float64)
        n = np.cross(v1, v2)
        denom = d_w @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        tt = np.dot(o - cw, n) / denom
        p = cw + tt[..., None] * d_w
        rel = p - o
        a = (rel @ v1) / max(v1 @ v1, 1e-9)
        b = (rel @ v2) / max(v2 @ v2, 1e-9)
        z = tt * d_cam[..., 2]
        good = ((z > 0.2) & (tt < bt) & (a >= 0) & (a <= 1)
                & (b >= 0) & (b <= 1))
        bt = np.where(good, tt, bt)
        ba = np.where(good, a, ba); bb = np.where(good, b, bb)
        brect = np.where(good[..., None], rect, brect)
        bden = np.where(good, rect[2] / np.sqrt(max(v1 @ v1, 1e-9)), bden)
    hit = bt < 5e8

    mips = [m.cpu().numpy().astype(np.float64) for m in seq.mips]
    tu = brect[..., 0] + ba * brect[..., 2]
    tv = brect[..., 1] + bb * brect[..., 3]
    fx_eff = 1.0 / K_inv[0, 0]
    lod = np.log2(np.maximum(bt * bden / fx_eff, 1e-6))
    lod = np.clip(lod, 0.0, len(mips) - 1.001)
    val = np.zeros((H, W))
    for li, tex in enumerate(mips):
        S0, S1 = tex.shape
        u = np.clip(tu * 0.5 ** li, 0, S1 - 1.001)
        v = np.clip(tv * 0.5 ** li, 0, S0 - 1.001)
        u0 = np.floor(u).astype(int); v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        s = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
             + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)
        val += np.clip(1.0 - np.abs(lod - li), 0, 1) * s
    elev = d_cam[..., 1]
    sky = 205.0 + 28.0 * np.clip(elev, -1.0, 0.3)
    ref = np.where(hit, val, sky)
    cyy, cxx = (H - 1) / 2.0, (W - 1) / 2.0
    r2 = (((np.arange(H) - cyy) / cyy)[:, None] ** 2
          + ((np.arange(W) - cxx) / cxx)[None, :] ** 2)
    return np.clip(ref * (1.0 - 0.18 * r2 / 2.0), 0, 255)


def check_renderer(seq, img0) -> dict:
    """Frame 0 as rendered (`img0`) against the float64 tracer: fewer than
    RENDER_FRAC of the pixels past RENDER_DIFF gray levels (hit-boundary
    pixels flip quad edges on one-ULP ray differences)."""
    diff = np.abs(render_reference(seq, 0) - img0.cpu().numpy())
    frac_big = float((diff > RENDER_DIFF).mean())
    check(frac_big < RENDER_FRAC,
          f"renderer: {frac_big} of the pixels past {RENDER_DIFF} levels")
    return dict(mean_abs=float(diff.mean()), frac_gt8=frac_big,
                max_abs_err=float(diff.max()))


def check_brief(img) -> tuple:
    """FAST + BRIEF of one frame as the frontend's `_extract` runs them,
    BRIEF twice: equal bit for bit. Returns (results, keypoints, the
    descriptors)."""
    fc = VOConfig().features
    kp = fast.detect(img, **detect_kwargs(fc))
    offsets = offsets_from_numpy(brief.make_offsets(
        fc.brief_n_bits, fc.brief_patch_radius, fc.brief_seed), img.device)
    blur = brief.gaussian_blur(img.to(torch.float32), fc.blur_ksize,
                               fc.blur_sigma)
    d1, _ = brief.describe(blur, kp.uv, kp.mask, offsets)
    d2, _ = brief.describe(blur, kp.uv, kp.mask, offsets)
    check(torch.equal(d1, d2), "brief: two runs differ")
    return dict(n_desc=int(kp.mask.sum())), kp, d1


def check_hamming_popcount(desc, mask) -> dict:
    """K3 on the card against a numpy popcount on the first 256 valid
    descriptors (every pair among them)."""
    sub = torch.nonzero(mask).reshape(-1)[:256]
    a = desc[sub]
    got = hamming_cuda.hamming_matrix(a, a).cpu().numpy()
    x = a.cpu().numpy()
    ref = np.unpackbits((x[:, None, :] ^ x[None, :, :]).view(np.uint8),
                        axis=-1).sum(-1)
    err = int(np.abs(got - ref).max())
    check(err == 0, f"hamming: {err} bits from the numpy popcount")
    return dict(n=len(sub), max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("selfcheck: no CUDA device", file=sys.stderr)
        return 2
    results = []

    def run(name, fn):
        print(f"[selfcheck] running: {name}", file=sys.stderr, flush=True)
        try:
            out = fn()
            rec = {"check": name, "ok": True, **out}
        except Exception as e:    # report every check, then fail the run
            rec = {"check": name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card_line()}), flush=True)
    _build.library()
    seq = parity_sequence()
    img0, img1 = seq.frame(0), seq.frame(1)
    kw = detect_kwargs(VOConfig().features)
    state = {}

    def fast_score():
        r, state["cand"] = fast_parity(img0, kw)
        return r

    def brief_det():
        r, state["kp"], state["desc"] = check_brief(img0)
        return r

    def hamming():
        pop = check_hamming_popcount(state["desc"], state["kp"].mask)
        return dict(popcount=pop, **hamming_parity(state["desc"],
                                                   state["desc"]))

    run("renderer", lambda: check_renderer(seq, img0))
    run("fast_score", fast_score)
    run("fast_select", lambda: select_parity(state["cand"], kw,
                                             *img0.shape))
    run("brief_determinism", brief_det)
    run("hamming", hamming)
    run("lk_level", lambda: lk_summary(*lk_parity(
        img0.float(), img1.float(), state["kp"].uv, state["kp"].mask)[:2]))
    def pose_gn():
        *step, gn = textured_solve_inputs()
        return dict(seeded=pose_gn_parity(*pose_gn_problem(), **gn),
                    textured_step=pose_gn_parity(*step, **gn))

    run("pose_gn", pose_gn)

    def window_gn():
        prob, cam, kw, _ = load_window_case("full_width")
        return dict(goldens=check_window_gn_goldens(),
                    full_width=window_gn_parity(prob, cam, **kw))

    run("window_gn", window_gn)
    n_fail = sum(not r["ok"] for r in results)
    print(json.dumps({"selfcheck": "PASS" if n_fail == 0 else "FAIL",
                      "n_checks": len(results), "n_fail": n_fail}),
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
