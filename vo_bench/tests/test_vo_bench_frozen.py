"""The benchmark's frozen copies equal their sources in the port, as at the
time of copying: the renderer, the trajectory evaluation, the roofline
yardstick, the device-interval union, the device's idle time by span, and
the reference's extraction."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from vo_bench.frozen import evaluation as f_eval
from vo_bench.frozen import peaks as f_peaks
from vo_bench.frozen import scene as f_scene
from vo_bench.frozen import trace as f_trace
from vo_bench.reference import extract as r_extract
from ya_vo_tpu_torch import profile_slice, selfcheck
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.features import brief, fast, fast_cuda
from ya_vo_tpu_torch.tracking.frontend import detect_kwargs
from ya_vo_tpu_torch.utils import scene as p_scene
from ya_vo_tpu_torch.utils import profiling, synthetic
from ya_vo_tpu_torch.utils.profiling import Span
from ya_vo_tpu_torch.viz import evaluation as p_eval

CAM = [359.428, 359.428, 40.0, 12.0]


def _sequences(**kw):
    common = dict(n_frames=6, height=24, width=80, seed=3, tex_size=64,
                  device="cpu", **kw)
    return (p_scene.TexturedSequence(cam=Camera.create(*CAM), **common),
            f_scene.TexturedSequence(cam=f_scene.Camera.create(*CAM),
                                     **common))


def test_world_and_frames_bit_equal():
    p, f = _sequences()
    np.testing.assert_array_equal(p.poses, f.poses)
    for a, b in zip(p.quads, f.quads):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.mips, f.mips):
        assert torch.equal(a, b)
    for i in range(6):
        assert torch.equal(p.frame(i), f.frame(i))


def test_texture_and_camera_equal():
    np.testing.assert_array_equal(p_scene.make_texture(128, seed=9),
                                  f_scene.make_texture(128, seed=9))
    assert tuple(f_scene.kitti_camera()) == tuple(synthetic.kitti_camera())
    assert torch.equal(f_scene.kitti_camera().K(),
                       synthetic.kitti_camera().K())


def _trajectories(seed):
    rng = np.random.default_rng(seed)
    gt = p_scene.curved_trajectory(300, seed=seed, segments=((0.01, 50),))
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (300, 3))
    return est, np.linalg.inv(gt)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_equal(seed):
    est, gt_cw = _trajectories(seed)
    assert f_eval.ate_rmse(est, gt_cw) == p_eval.ate_rmse(est, gt_cw)
    assert f_eval.kitti_segment_errors(est, gt_cw, lengths=(50.0, 100.0)) \
        == p_eval.kitti_segment_errors(est, gt_cw, lengths=(50.0, 100.0))


def _frame():
    imgs, *_ = synthetic.render_sequence(n_frames=1, n_landmarks=300,
                                         height=120, width=320, seed=4)
    return torch.as_tensor(imgs[0])


def test_peaks_and_bound_equal():
    for name in ("HBM_BYTES_S", "F32_OPS_S", "INT8_OPS_S", "FAST_PRE_OPS",
                 "FAST_RING_OPS", "FAST_HARRIS_OPS"):
        assert getattr(f_peaks, name) == getattr(selfcheck, name)
    for args in ((1e6, 1e9, 67e12), (1e9, 1e6, 1979e12)):
        assert f_peaks.bound(*args) == selfcheck.bound(*args)
    K, W = 2048, 8
    assert f_peaks.hamming_bound_ms(K, K, W) == selfcheck.bound(
        4 * (K + K) * W + 4 * K * K, 2 * K * K * 32 * W,
        selfcheck.INT8_OPS_S)[0]


def test_fast_work_and_bound_equal():
    img = _frame()
    fc = VOConfig().features
    args = dict(threshold=float(fc.fast_threshold),
                arc_length=fc.fast_arc_length, harris_k=fc.harris_k,
                nms_radius=fc.nms_radius)
    work = selfcheck.fast_work(img, args)
    assert f_peaks.fast_work(img, args["threshold"],
                             args["arc_length"]) == work
    border = detect_kwargs(fc)["border"]
    n = int(fast_cuda.fast_candidates_plain(img, border=border,
                                            **args).count)
    nms_ops = (2 * fc.nms_radius + 1) ** 2 + 1 + 4
    want = selfcheck.bound(
        img.numel() + 8 * n + 4,
        work["pixels"] * selfcheck.FAST_PRE_OPS
        + work["pretest"] * selfcheck.FAST_RING_OPS
        + work["corners"] * (selfcheck.FAST_HARRIS_OPS + nms_ops),
        selfcheck.F32_OPS_S)[0]
    import dataclasses
    assert f_peaks.fast_bound_ms(img, dataclasses.asdict(fc)) == want


def test_busy_union_equal():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1000, 200)
    spans = [(x, x + d) for x, d in zip(a, rng.uniform(0, 30, 200))]
    events = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e),
                              device_type=DeviceType.CUDA) for s, e in spans]
    events.append(SimpleNamespace(time_range=SimpleNamespace(start=0,
                                                             end=5000),
                                  device_type=DeviceType.CPU))
    assert f_trace.busy_us(spans) == profile_slice.busy_us(events)
    total, union = f_trace.busy_us(spans)
    idle = f_trace.idle_by_span(spans, [], window=(0.0, 1100.0))
    assert union * 1e-9 + idle["unspanned"] == pytest.approx(1100e-9)


def _program_spans(rng, n):
    """`n` spans of the program's kind on three threads, nested on each."""
    out = []
    for k in range(n):
        a = int(rng.integers(0, 100_000))
        out.append(Span(f"s{k % 7}", a, a + int(rng.integers(1, 20_000)),
                        k + 1, 0, k % 3, None, None))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_by_span_equal(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 100_000, 300)
    busy = [(int(x), int(x + d)) for x, d in
            zip(a, rng.integers(1, 400, 300))]
    sp = _program_spans(rng, 120)
    for window in (None, (-5_000, 110_000), (20_000, 60_000)):
        assert f_trace.idle_by_span(busy, sp, window=window) == \
            profiling.idle_by_span(busy, sp, window=window)
    assert f_trace.idle_by_span([], sp) == profiling.idle_by_span([], sp)


def test_reference_extraction_equals_port():
    """The reference's plain extraction gives the port's plain detect and
    describe on the CPU, slot for slot and bit for bit."""
    img = _frame()
    import dataclasses
    fc = VOConfig().features
    kp = fast.detect(img, **detect_kwargs(fc))
    offs = torch.as_tensor(brief.make_offsets(fc.brief_n_bits,
                                              fc.brief_patch_radius,
                                              fc.brief_seed)).long()
    desc, _ = brief.describe(brief.gaussian_blur(img.float(), fc.blur_ksize,
                                                 fc.blur_sigma),
                             kp.uv, kp.mask, offs)
    uv, mask, d = r_extract.extract(img, dataclasses.asdict(fc))
    assert torch.equal(uv, kp.uv) and torch.equal(mask, kp.mask)
    assert torch.equal(d, desc)
