"""The port's frontend on the textured street world against the JAX package.

The JAX package renders 10 frames of `bench.py`'s world (seed 5, with its
sensor noise) at half the KITTI size, 188x620 with the camera scaled to
match and a 1024-texel atlas, the smallest size at which this world tracks
with 1024 keypoints. Both frontends get the same uint8 frames at
`VOConfig()`'s defaults but for test_frontend_e2e.py's size and gates,
with window BA on (synchronous, push apply, the single-device solver). As
in test_torch_reset.py, the JAX frontend tracks with the TPU kernel's LK
semantics and the port's bootstraps are handed the JAX RANSAC draws;
tolerances are that file's.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_frontend import (_inject_jax_draw, _snapshot,
                                       _tpu_semantics_lk)
from ya_vo_tpu.config import FeatureConfig, TrackConfig, VOConfig
from ya_vo_tpu.core.camera import Camera as JCamera
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import scene as jscene
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import convert

SCALE = 0.5
H, W = 188, 620
N_FRAMES = 10


def make_config():
    cfg = VOConfig(image_height=H, image_width=W,
                   features=FeatureConfig(max_keypoints=1024),
                   tracking=TrackConfig(min_ba_inliers=15,
                                        min_flow_inliers=5))
    return dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, asynchronous=False, apply_mode="push", distributed="off"))


@pytest.fixture(scope="module")
def textured():
    """The JAX-rendered frames and the JAX frontend's run over them, with a
    snapshot after the bootstrap."""
    cam = JCamera.create(718.856 * SCALE, 718.856 * SCALE,
                         607.1928 * SCALE, 185.2157 * SCALE)
    seq = jscene.TexturedSequence(n_frames=N_FRAMES, height=H, width=W,
                                  seed=5, cam=cam, tex_size=1024)
    frames = [np.array(seq.frame(f)) for f in range(N_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(make_config(), cam)
        for i, img in enumerate(frames):
            jfe.process(img)
            if i == 1:
                snap = _snapshot(jfe)
    return frames, seq, jfe, snap


def port(cam):
    return tfrontend.Frontend(make_config(), convert.camera_from_numpy(cam),
                              device="cpu")


def test_textured_world_matches_jax_from_the_bootstrap(textured):
    """From the JAX state after the bootstrap the pipelined port tracks
    frames 2-9 with BA on: the same keyframe flags, solves, discards and
    resets, gate counts within 2%, camera centres and the map's keyframe
    poses within 5e-3."""
    frames, seq, jfe, snap = textured
    assert jfe.n_ba_runs >= 1 and jfe.n_resets == 0
    fe = port(jfe.cam)
    convert.frontend_state_from_numpy(fe, snap)
    traj = fe.run(frames[2:], pipelined=True)
    ref = jfe.results[2:]
    assert len(fe.results) == len(ref) == N_FRAMES - 2
    assert fe.n_ba_runs == jfe.n_ba_runs
    assert fe.n_ba_discarded == jfe.n_ba_discarded == 0
    assert fe.n_resets == jfe.n_resets == 0
    assert fe.n_redone > 0
    for r, q in zip(fe.results, ref):
        assert r.is_keyframe == q.is_keyframe
        assert abs(r.n_flow_inliers - q.n_flow_inliers) \
            <= 0.02 * q.n_flow_inliers
        assert abs(r.n_ba_inliers - q.n_ba_inliers) <= 0.02 * q.n_ba_inliers
    c_port = evaluation.positions_from_poses(traj)
    c_ref = evaluation.positions_from_poses(np.stack(jfe.trajectory[2:]))
    assert np.abs(c_port - c_ref).max() < 5e-3
    n = fe.map.n_keyframes
    assert n == jfe.map.n_keyframes
    np.testing.assert_allclose(fe.map.kf_pose[:n], jfe.map.kf_pose[:n],
                               atol=5e-3)
    gt_cw = np.linalg.inv(seq.poses)
    assert evaluation.ate_rmse(np.stack(jfe.trajectory), gt_cw,
                               with_scale=True) < 0.1


def test_textured_world_from_the_first_frame(textured, monkeypatch):
    """From the first frame, pipelined, with the JAX RANSAC draws: the same
    statuses and resets as JAX, tracking at the end."""
    frames, _, jfe, _ = textured
    _inject_jax_draw(monkeypatch, make_config().ransac.seed)
    fe = port(jfe.cam)
    fe.run(frames, pipelined=True)
    assert [r.status for r in fe.results] == [r.status for r in jfe.results]
    assert fe.n_resets == jfe.n_resets
    assert fe.results[-1].status == "TRACKING"
