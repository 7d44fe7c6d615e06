"""The frontend options of the port against the JAX package, on the CPU, on
test_frontend_e2e.py's 10-frame 256x768 stamps sequence with 1024
keypoints: `lk_template="anchor"`, `photometric_norm=True` and
`ba.apply_mode="device"`.

The JAX frontend tracks with the TPU kernel's LK semantics (a host
callback into the port's plain LK, as in test_torch_frontend.py). Each
port run continues from the JAX state after the bootstrap, so no RANSAC
draw is taken, and is held to test_torch_reset.py's bounds with window BA
on: the same statuses and keyframe flags, the same window solves, gate
counts within 2% and camera centres within 5e-3 map units.

- (d) `lk_template="anchor"` (LK from the anchor keyframe's image and
  positions, seeded by the absolute projection), with synchronous BA and
  push apply, on the pipelined driver (its redo templates on the keyframe
  image) and on the synchronous one.
- (e) `photometric_normalize` against the JAX frontend's `_norm_img` on
  seeded frames, a black frame and a frame with std < 1: at most one gray
  level apart (float32 sums in another order move a pixel near an integer
  across it) on at most NORM_SHARE of the pixels. Then a run with
  `photometric_norm=True` on frames under a seeded gain and bias drift;
  the port's normalization is handed JAX's normalized frames, so the pose
  comparison does not hinge on those pixels, and it must be applied once
  a frame.
- (f) `apply_mode="device"`, synchronous BA, pipelined: against the JAX
  frontend's pipelined driver, with no redone dispatch; and the port's
  own copy of test_frontend_e2e.py's contract test (device against push
  within 0.15 map units at a 0.4 step, the same resets and keyframes).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_frontend import SEQ, _snapshot, _tpu_semantics_lk
from tests.test_torch_reset import make_config
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.config import with_option
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import convert

TOL = 5e-3
NORM_SHARE = 0.01


def port(cam, cfg):
    return tfrontend.Frontend(cfg, convert.camera_from_numpy(cam),
                              device="cpu")


@pytest.fixture(scope="module")
def sequence():
    return jsynthetic.render_sequence(**SEQ)


def jax_run(cfg, cam, frames, pipelined=False):
    """The JAX frontend over `frames` (its synchronous or pipelined
    driver), and its state after the bootstrap (frame 1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(cfg, cam)
        for i, img in enumerate(frames):
            if pipelined:
                jfe._pipe_step(img)
            else:
                jfe.process(img)
            if i == 1:
                snap = _snapshot(jfe)
        jfe._pipe_flush()
        jfe.finish()
    return jfe, snap


def assert_matches(fe, traj, jfe):
    ref = jfe.results[2:]
    assert len(fe.results) == len(ref) == len(traj)
    assert [r.status for r in fe.results] == [r.status for r in ref]
    assert [r.is_keyframe for r in fe.results] == \
        [r.is_keyframe for r in ref]
    assert fe.n_resets == jfe.n_resets == 0
    assert fe.n_ba_runs == jfe.n_ba_runs >= 1
    assert fe.n_ba_discarded == jfe.n_ba_discarded
    for r, q in zip(fe.results, ref):
        assert abs(r.n_flow_inliers - q.n_flow_inliers) \
            <= 0.02 * q.n_flow_inliers
        assert abs(r.n_ba_inliers - q.n_ba_inliers) <= 0.02 * q.n_ba_inliers
    err = np.abs(evaluation.positions_from_poses(traj)
                 - evaluation.positions_from_poses(
                     np.stack(jfe.trajectory[2:]))).max()
    assert err < TOL, err


@pytest.fixture(scope="module")
def anchor_reference(sequence):
    imgs, _, _, cam = sequence
    cfg = with_option(make_config(), "tracking", lk_template="anchor")
    return cfg, jax_run(cfg, cam, imgs)


@pytest.mark.parametrize("pipelined", [True, False])
def test_anchor_template_matches_jax(sequence, anchor_reference, pipelined):
    imgs, _, _, cam = sequence
    cfg, (jfe, snap) = anchor_reference
    fe = port(cam, cfg)
    convert.frontend_state_from_numpy(fe, snap)
    traj = fe.run(imgs[2:], pipelined=pipelined)
    assert_matches(fe, traj, jfe)
    # BA applies push and, pipelined, redo the frames in flight
    assert (fe.n_redone > 0) == pipelined


def drifting(imgs, seed=3):
    """The frames under a seeded gain and bias drift (an exposure change a
    frame)."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.55, 1.0, len(imgs))
    bias = rng.uniform(-25.0, 25.0, len(imgs))
    return [np.clip(im * g + b, 0, 255).astype(np.uint8)
            for im, g, b in zip(imgs, gain, bias)]


def norm_frames(imgs):
    rng = np.random.default_rng(11)
    low = np.full((64, 96), 100, np.uint8)
    low[rng.random(low.shape) < 0.2] = 101          # std 0.4 < 1
    return (list(drifting(imgs[:4])) + [rng.integers(0, 256, (64, 96),
                                                     dtype=np.uint8)]
            + [np.zeros((64, 96), np.uint8), low])


def test_normalize_matches_jax(sequence):
    imgs, _, _, cam = sequence
    jfe = JFrontend(with_option(make_config(),
                                "features", photometric_norm=True), cam)
    n_diff = n_all = 0
    for img in norm_frames(imgs):
        ref = np.asarray(jfe._norm_img(jnp.asarray(img)))
        got = tfrontend.photometric_normalize(torch.as_tensor(img)).numpy()
        assert got.dtype == ref.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
        n_all += d.size
        if img.std() < 1.0:                # passes through at its own mean
            np.testing.assert_array_equal(got, img)
    assert n_diff <= NORM_SHARE * n_all, n_diff / n_all


def test_photometric_norm_matches_jax(sequence, monkeypatch):
    imgs, _, _, cam = sequence
    frames = drifting(imgs)
    cfg = with_option(make_config(), "features", photometric_norm=True)
    jfe, snap = jax_run(cfg, cam, frames)
    normed = {f.tobytes(): np.asarray(jfe._norm_img(jnp.asarray(f)))
              for f in frames}
    calls = []

    def jax_normalized(img):
        calls.append(1)
        return torch.tensor(normed[img.numpy().tobytes()])

    monkeypatch.setattr(tfrontend, "photometric_normalize", jax_normalized)
    fe = port(cam, cfg)
    convert.frontend_state_from_numpy(fe, snap)
    traj = fe.run(frames[2:], pipelined=True)
    assert_matches(fe, traj, jfe)
    assert len(calls) == len(frames) - 2       # once a frame, redos reuse
    np.testing.assert_array_equal(fe.last_img.numpy(),
                                  normed[frames[-1].tobytes()])


def device_config():
    return with_option(make_config(), "ba", apply_mode="device")


def test_device_apply_matches_jax(sequence):
    imgs, _, _, cam = sequence
    jfe, snap = jax_run(device_config(), cam, imgs, pipelined=True)
    fe = port(cam, device_config())
    convert.frontend_state_from_numpy(fe, snap)
    traj = fe.run(imgs[2:], pipelined=True)
    assert_matches(fe, traj, jfe)
    assert fe.n_redone == 0        # BA applies compose, no push, no redo


def test_post_corr_rotation_matches_jax(sequence):
    """A record resolved after a BA correction reached the device chain:
    from the JAX state after frame 4 (window BA off), frame 5 (a keyframe)
    is dispatched by both packages and resolved with the same `post_corr`
    (2 degrees and 0.5 map units, far above the float noise): the same
    keyframe decision, pose and rel_motion within 1e-4, and the fresh
    landmarks (created in pre-correction coordinates) moved by corr^-1
    within 0.5% (a far point's depth carries the triangulation's float
    noise; the correction moves a point at depth 80 by ~3%)."""
    from tests.test_torch_frontend import make_config as ba_off_config
    imgs, _, _, cam = sequence
    cfg = ba_off_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(cfg, cam)
        for img in imgs[:5]:
            jfe.process(img)
        snap = _snapshot(jfe)
        a = np.deg2rad(2.0)
        corr = np.eye(4, dtype=np.float32)
        corr[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]]
        corr[:3, 3] = (0.3, -0.2, 0.35)
        fe = port(cam, cfg)
        convert.frontend_state_from_numpy(fe, snap)
        out = []
        for f, img in ((jfe, jnp.asarray(imgs[5])),
                       (fe, torch.as_tensor(imgs[5]))):
            f.frame_id += 1
            c0 = f.map.lm_stamp_counter
            rec = f._dispatch_track(img)
            rec["post_corr"] = corr
            res = f._finish_track(rec)
            m = f.map
            fresh = np.nonzero((m.landmark_stamp[:m.n_landmarks] >= c0)
                               & m.landmark_alive[:m.n_landmarks])[0]
            order = np.argsort(m.landmark_stamp[fresh])
            out.append((res, f.last_pose, f.rel_motion,
                        m.landmark_pos[fresh[order]]))
    (jres, jpose, jrel, jpts), (res, pose, rel, pts) = out
    assert res.is_keyframe and jres.is_keyframe
    assert res.n_new_landmarks == jres.n_new_landmarks > 0
    np.testing.assert_allclose(pose, jpose, atol=1e-4)
    np.testing.assert_allclose(rel, jrel, atol=1e-4)
    assert len(pts) == len(jpts) == res.n_new_landmarks
    np.testing.assert_allclose(pts, jpts, rtol=5e-3, atol=1e-3)


def test_apply_corr_device_matches_jax(sequence):
    """The device chain after a correction is composed into it, both
    packages from the JAX state after frame 4 (window BA off) with frames
    5 (a keyframe: its merged slots are stamped 5) and 6 in flight and the
    host map's landmarks moved by 0.5 map units (a refinement): every slot the host resolved at the map's
    position and every slot merged in flight at its fresh triangulation
    moved by corr^-1 (within 0.5%, the fresh points' float noise), and the
    records in flight carrying the correction. Pose and keyframe pose
    within 1e-4 (absolute and relative: two chained fused steps)."""
    from tests.test_torch_frontend import make_config as ba_off_config
    imgs, _, _, cam = sequence
    cfg = ba_off_config()
    a = np.deg2rad(1.0)
    corr = np.eye(4, dtype=np.float32)
    corr[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                    [0, np.sin(a), np.cos(a)]]
    corr[:3, 3] = (-0.2, 0.1, 0.4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(cfg, cam)
        for img in imgs[:5]:
            jfe.process(img)
        snap = _snapshot(jfe)
        fe = port(cam, cfg)
        convert.frontend_state_from_numpy(fe, snap)
        out = []
        for f, conv in ((jfe, jnp.asarray), (fe, torch.as_tensor)):
            for img in imgs[5:7]:
                f._pipe_step(conv(img))
            assert len(f._pending_q) == 2
            f.map.landmark_pos[: f.map.n_landmarks] += (0.5, -0.5, 0.5)
            f._apply_corr_device(corr)
            out.append([np.asarray(x) for x in (
                f._d_pose, f._d_kf_pose, f._d_lm_pos, f._d_slot_stamp,
                f._d_track_valid)]
                + [[r["post_corr"] for r in f._pending_q]])
    (jpose, jkf, jlm, jstamp, jvalid, jpc), (pose, kf, lm, stamp, valid,
                                            pc) = out
    np.testing.assert_allclose(pose, jpose, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kf, jkf, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(stamp, jstamp)
    in_flight = jvalid & (jstamp > snap["_resolved_fid"])
    assert in_flight.sum() > 0 and (jvalid & ~in_flight).sum() > 0
    np.testing.assert_allclose(lm[jvalid], jlm[jvalid], rtol=5e-3, atol=1e-3)
    for c in pc + jpc:
        np.testing.assert_array_equal(c, corr)


def test_device_apply_matches_push_apply(sequence):
    """test_frontend_e2e.py's contract on the port: the device apply
    against the push apply from the first frame, pipelined (depth 8)."""
    imgs, _, _, cam = sequence
    fe_push = port(cam, make_config())
    traj_push = fe_push.run(imgs, pipelined=True)
    fe_dev = port(cam, device_config())
    traj_dev = fe_dev.run(imgs, pipelined=True)
    np.testing.assert_allclose(traj_dev, traj_push, atol=0.15)
    assert fe_dev.n_resets == fe_push.n_resets == 0
    assert [r.is_keyframe for r in fe_dev.results] == \
        [r.is_keyframe for r in fe_push.results]
    assert fe_dev.n_ba_runs == fe_push.n_ba_runs >= 1
    assert fe_push.n_redone > 0 and fe_dev.n_redone == 0
