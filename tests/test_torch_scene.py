"""The port's textured street world against `ya_vo_tpu/utils/scene.py`.

The world building is numpy copied verbatim and is held equal array for
array. `render_frame` is re-implemented in PyTorch and held against the JAX
renderer on the CPU at `noise_sigma=0` (the sensor noise comes from another
generator on each side): on at least 99.5% of pixels the two agree on
whether a ray hit a quad, fewer than 0.5% of pixels differ by more than 8
gray levels (`tools/selfcheck.py`'s renderer gate), and the mean |diff|
is under 0.05 (measured: 1e-4 to 4e-4, at most 1 gray level, where one
float32 rounding of a ray or a lod moves a sample across a boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.utils import scene as jscene
from ya_vo_tpu.utils.synthetic import kitti_camera as jkitti_camera
from ya_vo_tpu_torch.utils import scene as tscene
from ya_vo_tpu_torch.utils.synthetic import kitti_camera

MEAN_TOL = 0.05
BIG_DIFF, BIG_FRAC = 8, 0.005
HIT_AGREE = 0.995


def _render_j(quads, mips, pose, K_inv, H, W, **kw):
    return np.asarray(jscene.render_frame(
        *(jnp.asarray(x) for x in quads), tuple(jnp.asarray(m) for m in mips),
        jnp.asarray(pose), jnp.asarray(K_inv), height=H, width=W,
        noise_key=None, **kw))


def _render_t(quads, mips, pose, K_inv, H, W, **kw):
    return tscene.render_frame(
        *(torch.as_tensor(x) for x in quads),
        tuple(torch.as_tensor(m) for m in mips), torch.as_tensor(pose),
        torch.as_tensor(K_inv), height=H, width=W, noise_key=None,
        **kw).numpy()


def _k_inv():
    return np.linalg.inv(np.asarray(kitti_camera().K(), np.float64)) \
        .astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_world_building_is_the_reference_bit_for_bit(seed):
    assert tscene.CAM_HEIGHT == jscene.CAM_HEIGHT
    np.testing.assert_array_equal(tscene.make_texture(256, seed=seed),
                                  jscene.make_texture(256, seed=seed))
    tex = jscene.make_texture(128, seed=seed)
    for a, b in zip(tscene._mip_pyramid(tex, 4), jscene._mip_pyramid(tex, 4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    segs = ((0.0, 12), (0.006, 9), (-0.008, 7))
    tp = tscene.curved_trajectory(40, segments=segs, seed=seed)
    jp = jscene.curved_trajectory(40, segments=segs, seed=seed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tscene.camera_centers(tp),
                                  jscene.camera_centers(jp))
    tq = tscene.build_street_world(tp, seed=seed, tex_size=512)
    jq = jscene.build_street_world(jp, seed=seed, tex_size=512)
    assert tscene.Quads._fields == jscene.Quads._fields
    for f in (0, 23, 39):
        for a, b in zip(tscene.cull_quads(tq, tp[f], 32),
                        jscene.cull_quads(jq, jp[f], 32)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("H,W,ss,q_max,tex_size", [(376, 1241, 1, 48, 1024),
                                                   (94, 310, 2, 64, 512)])
def test_render_frame_matches_jax(H, W, ss, q_max, tex_size):
    """One frame of the seed-5 world at full size (48 quads, tex 1024, 4
    mips) and at a quarter of it with 2x supersampling. The hit masks come
    from a black texture, on which a hit renders below 50 and the sky
    above 150."""
    poses = jscene.curved_trajectory(30, seed=5)
    quads = jscene.cull_quads(
        jscene.build_street_world(poses, seed=5, tex_size=tex_size),
        poses[17], q_max)
    mips = jscene._mip_pyramid(jscene.make_texture(tex_size, seed=5), 4)
    K_inv = _k_inv()
    kw = dict(ss=ss, gain=1.07, bias=-3.0, noise_sigma=0.0)
    j = _render_j(quads, mips, poses[17], K_inv, H, W, **kw)
    t = _render_t(quads, mips, poses[17], K_inv, H, W, **kw)
    assert t.dtype == np.uint8 and t.shape == (H, W)
    d = np.abs(j.astype(np.int32) - t)
    assert d.mean() < MEAN_TOL, d.mean()
    assert (d > BIG_DIFF).mean() < BIG_FRAC
    black = [np.zeros_like(m) for m in mips]
    hit_j = _render_j(quads, black, poses[17], K_inv, H, W, **kw) < 50
    hit_t = _render_t(quads, black, poses[17], K_inv, H, W, **kw) < 50
    assert 0.05 < hit_j.mean() < 0.99
    assert (hit_j == hit_t).mean() >= HIT_AGREE


def test_render_exact_projection_and_occlusion():
    """tests/test_scene.py's case on the port: a fronto-parallel quad at
    known depth fills its projected rectangle with its atlas region, and a
    nearer quad occludes it."""
    cam = kitti_camera()
    H, W = 376, 1241
    tex = np.full((256, 256), 60.0, np.float32)
    tex[:128] = 220.0
    quads = tscene.Quads(
        origin=np.array([[-2.0, -1.0, 10.0], [-0.5, -0.5, 5.0]], np.float32),
        e1=np.array([[4.0, 0, 0], [1.0, 0, 0]], np.float32),
        e2=np.array([[0, 2.0, 0], [0, 1.0, 0]], np.float32),
        atlas=np.array([[0, 0, 250, 120], [0, 140, 250, 110]], np.float32),
        valid=np.ones(2, bool))
    img = _render_t(quads, tscene._mip_pyramid(tex, 2),
                    np.eye(4, dtype=np.float32), _k_inv(), H, W,
                    noise_sigma=0.0, gain=1.0, bias=0.0)
    fx, cx, cy = cam.fx, cam.cx, cam.cy
    u0, u1 = cx - fx * 2.0 / 10.0, cx + fx * 2.0 / 10.0
    v0 = cy - fx * 1.0 / 10.0
    nu0, nu1 = cx - fx * 0.5 / 5.0, cx + fx * 0.5 / 5.0
    nv0, nv1 = cy - fx * 0.5 / 5.0, cy + fx * 0.5 / 5.0
    a_only = img[int(v0) + 2:int(nv0) - 2, int(u0) + 2:int(u1) - 2]
    assert np.all(a_only > 180), "far quad should sample its bright atlas"
    b_region = img[int(nv0) + 2:int(nv1) - 2, int(nu0) + 2:int(nu1) - 2]
    assert np.all(b_region < 100), "near quad must occlude the far quad"
    assert img[5, 5] > 150
    # and the JAX renderer gives the same picture
    j = _render_j(quads, tscene._mip_pyramid(tex, 2),
                  np.eye(4, dtype=np.float32), _k_inv(), H, W,
                  noise_sigma=0.0, gain=1.0, bias=0.0)
    assert (np.abs(j.astype(np.int32) - img) > BIG_DIFF).mean() < BIG_FRAC


def test_noise_is_seeded_per_frame():
    """The sensor noise is the same for one (seed, f) on every run, differs
    between frames, and its std is within 5% of noise_sigma (at sigma 8 the
    truncating cast adds ~0.1%)."""
    kw = dict(n_frames=3, height=64, width=200, seed=5, q_max=16,
              tex_size=256, mip_levels=3, device="cpu")
    seq = tscene.TexturedSequence(noise_sigma=8.0, **kw)
    clean = tscene.TexturedSequence(noise_sigma=0.0, **kw)
    a, b = seq.frame(1), seq.frame(1)
    assert torch.equal(a, b)
    n1 = a.to(torch.int32) - clean.frame(1).to(torch.int32)
    n2 = seq.frame(2).to(torch.int32) - clean.frame(2).to(torch.int32)
    assert not torch.equal(n1, n2)
    for n in (n1, n2):
        assert abs(float(n.float().std()) - 8.0) < 0.05 * 8.0
        assert abs(float(n.float().mean())) < 0.5


def test_sequence_frames_match_jax():
    """TexturedSequence(device="cpu").frame(f) against the JAX sequence's
    frame at noise_sigma=0: uint8 [H, W], within 1 gray level on 99.9% of
    pixels and past 8 levels on fewer than 0.5%; same poses and camera."""
    kw = dict(n_frames=60, height=120, width=400, seed=5, q_max=48,
              tex_size=512, mip_levels=4, noise_sigma=0.0)
    jseq = jscene.TexturedSequence(**kw)
    tseq = tscene.TexturedSequence(device="cpu", **kw)
    np.testing.assert_array_equal(tseq.poses, jseq.poses)
    np.testing.assert_array_equal(tseq.K_inv, jseq.K_inv)
    assert tuple(tseq.cam) == tuple(float(c) for c in jkitti_camera())
    assert all(m.device.type == "cpu" for m in tseq.mips)
    for f in (0, 31, 59):
        t = tseq.frame(f)
        assert t.dtype == torch.uint8 and t.shape == (120, 400)
        d = np.abs(np.asarray(jseq.frame(f)).astype(np.int32) - t.numpy())
        assert (d <= 1).mean() >= 0.999
        assert (d > BIG_DIFF).mean() < BIG_FRAC


def test_sequence_defaults_to_the_card():
    kw = dict(n_frames=2, height=32, width=64, tex_size=64, mip_levels=2)
    if torch.cuda.is_available():
        assert tscene.TexturedSequence(**kw).frame(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tscene.TexturedSequence(**kw)
