"""The port's frontend at production settings against the JAX package:
window BA on (synchronous, push apply), the reset path (PnP relocalization
or the unit-scale two-view fallback) and the redo of in-flight frames, on
test_frontend_e2e.py's 10-frame 256x768 sequence with 1024 keypoints.

As in test_torch_frontend.py, the JAX frontend tracks with the TPU
kernel's LK semantics through a host callback into the port's plain LK,
and the port's bootstraps are handed the JAX RANSAC draws (one
`jax.random.split` a bootstrap, as the JAX frontend takes them). The JAX
side runs the single-device window solver (`ba.distributed="off"`; the test
session shows JAX eight virtual CPU devices)."""

import dataclasses

import numpy as np
import pytest

from tests.test_frontend_e2e import make_config as e2e_config
from tests.test_torch_frontend import (SEQ, _inject_jax_draw, _snapshot,
                                       _tpu_semantics_lk)
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import convert

SCENE_B_SEED = 31   # a second stamps world: nothing of it matches world A


def make_config():
    """test_frontend_e2e.py's exact-parity config (sync BA, push apply) on
    the single-device solver."""
    cfg = e2e_config(sync_ba=True, apply_mode="push")
    return dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, distributed="off"))


def blackout(imgs):
    return list(imgs[:6]) + [np.zeros_like(imgs[0])] * 2 + list(imgs[6:])


def scene_change(imgs):
    other, *_ = jsynthetic.render_sequence(**dict(SEQ, n_frames=6,
                                                  seed=SCENE_B_SEED))
    return list(imgs[:6]) + list(other)


def port(cam):
    return tfrontend.Frontend(make_config(), convert.camera_from_numpy(cam),
                              device="cpu")


@pytest.fixture(scope="module")
def sequence():
    return jsynthetic.render_sequence(**SEQ)


@pytest.fixture(scope="module")
def jax_runs(sequence):
    """The JAX frontend, synchronous driver, on the plain sequence (with a
    snapshot after the bootstrap), the blackout and the scene change."""
    imgs, _, _, cam = sequence
    runs, snaps = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        for name, seq in (("plain", list(imgs)), ("blackout", blackout(imgs)),
                          ("scene", scene_change(imgs))):
            jfe = JFrontend(make_config(), cam)
            for i, img in enumerate(seq):
                jfe.process(img)
                if name == "plain" and i == 1:
                    snaps[name] = _snapshot(jfe)
            runs[name] = jfe
    return runs, snaps


def test_ba_on_matches_jax_from_the_bootstrap(sequence, jax_runs):
    """From the JAX state after the bootstrap, the pipelined port tracks
    frames 2..9 with BA on: the same keyframe flags, window solves and
    discards, gate counts within 2%, camera centres within 5e-3."""
    imgs, _, _, cam = sequence
    runs, snaps = jax_runs
    jfe = runs["plain"]
    assert jfe.n_ba_runs >= 1 and jfe.n_resets == 0
    fe = port(cam)
    convert.frontend_state_from_numpy(fe, snaps["plain"])
    assert type(fe.map).__module__ == "ya_vo_tpu_torch.worldmap.mapstore"
    traj = fe.run(imgs[2:], pipelined=True)
    ref = jfe.results[2:]
    assert len(fe.results) == len(ref) == 8
    assert fe.n_ba_runs == jfe.n_ba_runs
    assert fe.n_ba_discarded == jfe.n_ba_discarded == 0
    assert fe.n_resets == 0
    for r, q in zip(fe.results, ref):
        assert r.is_keyframe == q.is_keyframe
        assert abs(r.n_flow_inliers - q.n_flow_inliers) \
            <= 0.02 * q.n_flow_inliers
        assert abs(r.n_ba_inliers - q.n_ba_inliers) <= 0.02 * q.n_ba_inliers
    c_port = evaluation.positions_from_poses(traj)
    c_ref = evaluation.positions_from_poses(np.stack(jfe.trajectory[2:]))
    assert np.abs(c_port - c_ref).max() < 5e-3
    # the solves' keyframe poses landed in the map as well
    n = fe.map.n_keyframes
    assert n == jfe.map.n_keyframes
    np.testing.assert_allclose(fe.map.kf_pose[:n], jfe.map.kf_pose[:n],
                               atol=5e-3)


@pytest.mark.parametrize("corrupt", [None, "blackout"])
def test_pipelined_matches_sync_exactly(sequence, corrupt):
    """Port pipelined (depth 8: BA applies and the reset redo the in-flight
    frames) bit-equal to port sync, with BA on and through the
    2-blank-frame reset (test_frontend_e2e.py's property)."""
    imgs, _, _, cam = sequence
    seq = blackout(imgs) if corrupt else list(imgs)
    fe_sync, fe_pipe = port(cam), port(cam)
    traj_sync = fe_sync.run(seq, pipelined=False)
    traj_pipe = fe_pipe.run(seq, pipelined=True)
    np.testing.assert_array_equal(traj_sync, traj_pipe)
    assert [r.status for r in fe_sync.results] == \
        [r.status for r in fe_pipe.results]
    assert [r.is_keyframe for r in fe_sync.results] == \
        [r.is_keyframe for r in fe_pipe.results]
    assert [r.n_ba_inliers for r in fe_sync.results] == \
        [r.n_ba_inliers for r in fe_pipe.results]
    assert fe_sync.n_resets == fe_pipe.n_resets == (1 if corrupt else 0)
    assert fe_sync.n_ba_runs == fe_pipe.n_ba_runs >= 1 - bool(corrupt)
    assert fe_pipe.n_redone > 0 and fe_sync.n_redone == 0


@pytest.mark.parametrize("name,relocalizations", [("blackout", 1),
                                                  ("scene", 0)])
def test_reset_path_matches_jax(sequence, jax_runs, monkeypatch, name,
                                relocalizations):
    """From the first frame, pipelined: two blank frames reset and
    relocalize by PnP against the map; a cut to another world resets,
    fails to relocalize and falls back to the unit-scale two-view
    bootstrap. The same statuses, resets and relocalizations as JAX,
    tracking at the end."""
    imgs, _, _, cam = sequence
    jfe = jax_runs[0][name]
    seq = blackout(imgs) if name == "blackout" else scene_change(imgs)
    _inject_jax_draw(monkeypatch, make_config().ransac.seed)
    fe = port(cam)
    fe.run(seq, pipelined=True)
    assert [r.status for r in fe.results] == [r.status for r in jfe.results]
    assert fe.n_resets == jfe.n_resets >= 1
    assert fe.n_relocalizations == jfe.n_relocalizations == relocalizations
    assert fe.results[-1].status == "TRACKING"
