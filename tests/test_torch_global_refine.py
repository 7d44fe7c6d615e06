"""The port's offline global refinement (`ya_vo_tpu_torch/ba/global_refine`)
against `ya_vo_tpu/ba/global_refine.py` on the CPU.

The JAX frontend (TPU LK semantics, as in test_torch_frontend.py) runs
test_torch_reset.py's blackout sequence: 10 frames of test_frontend_e2e.py's
256x768 stamps world with two black frames after frame 5, so a PnP
relocalization fences the BA window (`window_barrier`). The map's window is
3 keyframes and its capacity 400 landmarks, so `retire_out_of_window` fills
the retirement archive. The map and trajectory cross into a port frontend
through `utils/convert`, and both sides refine from the same state.

Held: the refined trajectory and keyframe poses within 1e-4 of JAX (measured
5.9e-5); the first keyframe of each barrier segment unmoved on both sides;
archive stamps equal; archived and live landmark positions by
tests/test_torch_ba.py's landmark rule: within 1e-3 of JAX or, where the
JAX float32 sweep is itself farther than that from the same sweep solved in
float64, within twice that distance (measured: archive 0.091 against JAX's
own 0.109, live 0.38 against 0.69; the windows leave landmarks weakly
constrained along their rays).
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_frontend import SEQ, _tpu_semantics_lk
from tests.test_torch_reset import blackout
from tests.test_torch_reset import make_config as reset_config
from ya_vo_tpu.ba.global_refine import global_refine as jglobal_refine
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu_torch.ba import global_refine as tglobal_refine
from ya_vo_tpu_torch.ba import window as twindow
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import convert

POSE_ATOL, LM_ATOL = 1e-4, 1e-3


def make_config():
    cfg = reset_config()
    return dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, window_size=3, max_landmarks=400))


@pytest.fixture(scope="module")
def session():
    """The JAX session's map and trajectory before refinement, and the JAX
    frontend after `global_refine` with its refined trajectory."""
    imgs, _, _, cam = jsynthetic.render_sequence(**SEQ)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(make_config(), cam)
        for img in blackout(imgs):
            jfe.process(img)
    before = dict(map=convert.map_arrays(jfe.map),
                  trajectory=[t.copy() for t in jfe.trajectory])
    refined = jglobal_refine(jfe)
    return before, jfe, refined


def port_refine(before, cam):
    fe = Frontend(make_config(), convert.camera_from_numpy(cam),
                  device="cpu")
    fe.map = convert.mapstore_from_numpy(before["map"])
    fe.trajectory = [t.copy() for t in before["trajectory"]]
    return fe, tglobal_refine.global_refine(fe)


def _float64_solve(solve):
    def solve64(prob, cam, **kw):
        res = solve(twindow.BAProblem(*(t.double() if t.is_floating_point()
                                        else t for t in prob)), cam, **kw)
        return res._replace(poses=res.poses.float(),
                            landmarks=res.landmarks.float())
    return solve64


def test_global_refine_matches_jax(session, monkeypatch):
    before, jfe, refined = session
    m0 = before["map"]
    n = int(m0["n_keyframes"])
    barrier = int(m0["window_barrier"])
    assert 0 < barrier < n and jfe.n_relocalizations == 1
    assert len(m0["archive_stamps"]) > 0
    fe, traj = port_refine(before, jfe.cam)
    assert traj.shape == refined.shape == (12, 4, 4)
    assert np.abs(refined - np.stack(before["trajectory"])).max() > 1e-2
    np.testing.assert_allclose(traj, refined, atol=POSE_ATOL)
    np.testing.assert_allclose(fe.map.kf_pose[:n], jfe.map.kf_pose[:n],
                               atol=POSE_ATOL)
    # the first keyframe of each segment is pinned in every window it is in
    for k in (0, barrier):
        np.testing.assert_array_equal(fe.map.kf_pose[k], m0["kf_pose"][k])
        np.testing.assert_array_equal(jfe.map.kf_pose[k], m0["kf_pose"][k])

    monkeypatch.setattr(twindow, "solve_window",
                        _float64_solve(twindow.solve_window))
    fe64, _ = port_refine(before, jfe.cam)
    (sj, pj), (st, pt), (_, p64) = (m.archive.arrays() for m in
                                    (jfe.map, fe.map, fe64.map))
    np.testing.assert_array_equal(st, sj)
    live = jfe.map.landmark_alive
    for got, ref, exact in (
            (pt, pj, p64),
            (fe.map.landmark_pos[live], jfe.map.landmark_pos[live],
             fe64.map.landmark_pos[live])):
        d = np.abs(got - ref).max()
        assert d <= max(LM_ATOL, 2 * np.abs(ref - exact).max()), d


def test_global_refine_without_keyframes_returns_the_trajectory():
    """Fewer than two keyframes: nothing to solve, the trajectory as it
    was."""
    cfg = make_config()
    fe = Frontend(cfg, convert.camera_from_numpy(
        jsynthetic.kitti_camera()), device="cpu")
    assert tglobal_refine.global_refine(fe).shape == (0, 4, 4)
    fe.trajectory = [np.eye(4, dtype=np.float32)] * 3
    np.testing.assert_array_equal(tglobal_refine.global_refine(fe),
                                  np.stack(fe.trajectory))
