"""The port's checkpoint (`ya_vo_tpu_torch/utils/checkpoint.py`) against the
JAX package's: one npz schema, so a session saved by either package
resumes in the other.

On test_frontend_e2e.py's 10-frame 256x768 sequence with synchronous
window BA (push apply, the single-device solver), the JAX frontend
tracking with the TPU kernel's LK semantics (tests/test_torch_frontend.py):
- a JAX checkpoint after frame 5 loads into the port with every array
  equal (the port's save of it gives the JAX file back, key for key, dtype
  for dtype, bit for bit), and the port continues over frames 6-9 to the
  trajectory of the JAX frontend continued from the same file: the same
  keyframe flags and camera centres within 5e-3 map units
  (test_torch_reset.py's bound for BA on);
- a port checkpoint after frame 7 has the keys, dtypes and shapes of the
  JAX save at the same frame, loads into the JAX package's `load_frontend`,
  and JAX continues over frames 8-9 to the port's own continuation within
  5e-3;
- on the port alone, tests/test_aux.py's cases: save, load and continue,
  the window barrier, and the save in the middle of the pipelined driver.
Neither continuation bootstraps (no reset), so no RANSAC draw is taken."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_frontend import SEQ, _tpu_semantics_lk
from tests.test_torch_reset import make_config
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import checkpoint as jckpt
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import checkpoint as tckpt
from ya_vo_tpu_torch.utils import convert

TOL = 5e-3


def port(cam, cfg=None):
    return tfrontend.Frontend(cfg or make_config(),
                              convert.camera_from_numpy(cam), device="cpu")


def _centres(traj):
    return evaluation.positions_from_poses(np.stack(traj))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The JAX session: its checkpoints after frames 5 (A) and 7 (D), and
    JAX frontends continued from A over frames 6-9 and from D over 8-9."""
    imgs, poses, _, cam = jsynthetic.render_sequence(**SEQ)
    d = tmp_path_factory.mktemp("ckpt")
    paths = {k: str(d / f"{k}.npz") for k in ("A", "D")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(make_config(), cam)
        for img in imgs[:6]:
            jfe.process(img)
        jckpt.save_frontend(jfe, paths["A"])
        from_a = JFrontend(make_config(), cam)
        jckpt.load_frontend(from_a, paths["A"])
        for img in imgs[6:8]:
            from_a.process(img)
        jckpt.save_frontend(from_a, paths["D"])
        for img in imgs[8:]:
            from_a.process(img)
    return imgs, poses, cam, paths, from_a, d


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_jax_checkpoint_into_the_port(session, tmp_path):
    imgs, _, cam, paths, jfe, _ = session
    fe = port(cam)
    tckpt.load_frontend(fe, paths["A"])
    assert fe.frame_id == 5 and fe.status is tfrontend.VOStatus.TRACKING
    a = _npz(paths["A"])
    assert a["last_desc"].dtype == np.uint32
    np.testing.assert_array_equal(fe.last_desc.numpy().view(np.uint32),
                                  a["last_desc"])
    np.testing.assert_array_equal(fe._kf_img.numpy(), a["anchor_kf_img"])
    assert fe._d_kf_desc.dtype == fe.last_desc.dtype
    # every restored array, through the port's save: the JAX file back
    tckpt.save_frontend(fe, str(tmp_path / "B.npz"))
    b = _npz(str(tmp_path / "B.npz"))
    assert b.keys() == a.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # the port continues to the JAX frontend continued from the same file
    for img in imgs[6:]:
        fe.process(img)
    ref = jfe.results
    assert len(fe.results) == len(ref) == 4
    assert fe.n_resets == jfe.n_resets == 0
    assert [r.is_keyframe for r in fe.results] == \
        [r.is_keyframe for r in ref]
    assert len(fe.trajectory) == len(jfe.trajectory) == 10
    err = np.abs(_centres(fe.trajectory) - _centres(jfe.trajectory)).max()
    assert err < TOL, err


def test_port_checkpoint_into_jax(session, tmp_path, monkeypatch):
    imgs, _, cam, paths, jfe, _ = session
    fe = port(cam)
    tckpt.load_frontend(fe, paths["A"])
    for img in imgs[6:8]:
        fe.process(img)
    path_c = str(tmp_path / "C.npz")
    tckpt.save_frontend(fe, path_c)
    c, dref = _npz(path_c), _npz(paths["D"])
    assert c.keys() == dref.keys()
    for k in dref:
        assert c[k].dtype == dref[k].dtype, k
        assert c[k].shape == dref[k].shape, (k, c[k].shape, dref[k].shape)
    monkeypatch.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
    back = JFrontend(make_config(), cam)
    jckpt.load_frontend(back, path_c)
    assert back.frame_id == 7 and back.map.n_keyframes == fe.map.n_keyframes
    for img in imgs[8:]:
        back.process(img)
        fe.process(img)
    assert back.n_resets == fe.n_resets == 0
    assert [r.is_keyframe for r in back.results] == \
        [r.is_keyframe for r in fe.results[2:]]
    err = np.abs(_centres(back.trajectory) - _centres(fe.trajectory)).max()
    assert err < TOL, err


def test_checkpoint_resume_continues_tracking(session, tmp_path):
    """tests/test_aux.py's case on the port: 6 frames, save, resume in a
    fresh frontend, the rest; 0 resets and ATE_sim3 within max(0.05, 2x)
    of an uninterrupted run."""
    imgs, poses, cam, *_ = session
    fe1 = port(cam)
    for img in imgs[:6]:
        fe1.process(img)
    path = str(tmp_path / "state.npz")
    tckpt.save_frontend(fe1, path)
    fe2 = port(cam)
    tckpt.load_frontend(fe2, path)
    assert fe2.frame_id == fe1.frame_id
    for img in imgs[6:]:
        fe2.process(img)
    fe_ref = port(cam)
    fe_ref.run(imgs)
    gt_cw = np.linalg.inv(poses)
    ate_resumed = evaluation.ate_rmse(np.stack(fe2.trajectory), gt_cw)
    ate_ref = evaluation.ate_rmse(np.stack(fe_ref.trajectory), gt_cw)
    assert fe2.n_resets == 0
    assert ate_resumed < max(0.05, 2 * ate_ref), (ate_resumed, ate_ref)


def test_checkpoint_persists_window_barrier(session, tmp_path):
    imgs, _, cam, *_ = session
    fe1 = port(cam)
    for img in imgs[:6]:
        fe1.process(img)
    fe1.map.mark_scale_break()      # a mid-sequence bootstrap reset
    barrier = fe1.map.window_barrier
    assert barrier > 0
    path = str(tmp_path / "state.npz")
    tckpt.save_frontend(fe1, path)
    fe2 = port(cam)
    tckpt.load_frontend(fe2, path)
    assert fe2.map.window_barrier == barrier


def test_checkpoint_mid_pipeline_flushes_inflight(session, tmp_path):
    """A save while the pipelined driver holds frames in flight resolves
    them first (tests/test_aux.py's case at depth 8, 12 frames): the
    trajectory covers every frame fed, and the resumed session tracks the
    rest with 0 resets and ATE_sim3 within max(0.05, 2x) of an
    uninterrupted run."""
    cfg = make_config()
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, pipeline_depth=8))
    imgs, poses, _, cam = jsynthetic.render_sequence(**dict(SEQ,
                                                            n_frames=12))
    fe1 = port(cam, cfg)
    for img in imgs[:3]:
        fe1.process(img)
    for img in imgs[3:8]:
        fe1._pipe_step(img)
    assert len(fe1._pending_q) > 0, "precondition: in-flight frames"
    path = str(tmp_path / "state.npz")
    tckpt.save_frontend(fe1, path)
    assert len(fe1._pending_q) == 0
    assert len(fe1.trajectory) == 8
    fe2 = port(cam, cfg)
    tckpt.load_frontend(fe2, path)
    for img in imgs[8:]:
        fe2.process(img)
    fe_ref = port(cam, cfg)
    fe_ref.run(imgs)
    gt_cw = np.linalg.inv(poses)
    ate_resumed = evaluation.ate_rmse(np.stack(fe2.trajectory), gt_cw)
    ate_ref = evaluation.ate_rmse(np.stack(fe_ref.trajectory), gt_cw)
    assert fe2.n_resets == 0
    assert ate_resumed < max(0.05, 2 * ate_ref), (ate_resumed, ate_ref)


# the keys an older checkpoint lacks, by the fallback that takes their place
# (ya_vo_tpu/utils/checkpoint.py:122-166)
OLDER = {
    "kf_obs_stamp": ("kf_obs_stamp",),
    "landmark_stamp": ("landmark_stamp", "lm_free", "lm_stamp_counter",
                       "kf_stamp_counter", "kf_stamp"),
    "window_barrier": ("window_barrier",),
    "track_anchor_uv": ("track_anchor_uv", "kf_ref_inliers",
                        "anchor_kf_pose", "anchor_kf_img", "anchor_kf_kp_uv",
                        "anchor_kf_kp_score", "anchor_kf_kp_mask",
                        "anchor_kf_desc"),
}


def _host(x):
    """A state field as numpy (descriptors as their uint32 bits)."""
    if x is None:
        return None
    if hasattr(x, "numpy"):
        x = x.numpy()
    x = np.array(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim == 2 \
        and x.shape[1] == 8 else x


@pytest.mark.parametrize("case", sorted(OLDER))
def test_older_checkpoint_loads_as_in_jax(session, tmp_path, case):
    """A JAX checkpoint with one older schema's keys deleted loads into
    both packages, and the restored map and frontend state are equal field
    by field: the map's arrays and counters, the host mirrors, the device
    chain and the previous and anchor frames' images, keypoints and
    descriptors."""
    _, _, cam, paths, *_ = session
    z = _npz(paths["A"])
    for k in OLDER[case]:
        del z[k]
    path = str(tmp_path / f"older_{case}.npz")
    np.savez_compressed(path, **z)
    jfe = JFrontend(make_config(), cam)
    jckpt.load_frontend(jfe, path)
    fe = port(cam)
    tckpt.load_frontend(fe, path)
    assert fe.status.name == jfe.status.name == "TRACKING"
    jmap, tmap = convert.map_arrays(jfe.map), convert.map_arrays(fe.map)
    assert jmap.keys() == tmap.keys()
    for k in jmap:
        np.testing.assert_array_equal(tmap[k], jmap[k], err_msg=k)
    for k in (convert.HOST_KEYS + convert.DEVICE_KEYS
              + ("last_img", "last_desc", "_kf_img", "_kf_desc")):
        a, b = _host(getattr(fe, k)), _host(getattr(jfe, k))
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("last_kp", "_kf_kp"):
        a, b = getattr(fe, k), getattr(jfe, k)
        assert (a is None) == (b is None), k
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(_host(x), _host(y), err_msg=k)
