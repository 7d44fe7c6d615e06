"""The port's own copies of the JAX package's numpy modules (`config`,
`worldmap/mapstore`, `viz/evaluation`, `utils/synthetic.project_tracks`)
against the originals: the same defaults and loaded configs, the same
map-store arrays after one seeded sequence of operations, the same
trajectory metrics and projected tracks, exactly. The
copies of `io/prefetch`, `io/native_loader`, `viz/render` and `viz/live`
are the originals' text, up to their one import of the package."""

import dataclasses
import os

import numpy as np
import pytest

from ya_vo_tpu import config as jconfig
from ya_vo_tpu.viz import evaluation as jevaluation
from ya_vo_tpu.worldmap import mapstore as jmapstore
from ya_vo_tpu_torch import config as tconfig
from ya_vo_tpu_torch.viz import evaluation as tevaluation
from ya_vo_tpu_torch.worldmap import mapstore as tmapstore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_config_equal():
    assert (dataclasses.asdict(tconfig.VOConfig())
            == dataclasses.asdict(jconfig.VOConfig()))


@pytest.mark.parametrize("name", ["KITTI.json", "KITTI_mock_test.json"])
def test_config_files_load_equal(name):
    path = os.path.join(REPO, "configs", name)
    assert (dataclasses.asdict(tconfig.VOConfig.from_json(path))
            == dataclasses.asdict(jconfig.VOConfig.from_json(path)))


def _map_ops(mod, seed=0):
    """One seeded sequence of landmark inserts, kills, keyframe inserts,
    retirements, recycling, evictions and window queries on `mod`'s
    MapStore; returns the store and the window queries' arrays."""
    rng = np.random.default_rng(seed)
    m = mod.MapStore(max_landmarks=600, max_keyframes=8, max_obs_per_kf=64)
    windows = []
    for f in range(14):
        n = int(rng.integers(20, 90))
        lm = m.add_landmarks(rng.normal(size=(n, 3)).astype(np.float32),
                             rng.random(n) > 0.2)
        m.kill_landmarks(lm[rng.random(n) > 0.85])
        obs_n = min(n, 64)
        uv = rng.uniform(0, 500, size=(obs_n, 2)).astype(np.float32)
        if m.n_keyframes >= m.max_keyframes:
            m.evict_oldest_keyframes(2, protected_landmarks=lm[lm >= 0][:5])
        m.insert_keyframe(f, np.eye(4, dtype=np.float32) * (1 + f),
                          uv, lm[:obs_n], rng.random(obs_n) > 0.1)
        if f % 3 == 2:
            m.retire_out_of_window(3, protected=lm[:10])
            m.recycle_dead(protected=lm[:4])
        if f == 7:
            m.mark_scale_break()
        windows.append(m.active_window(4))
        windows.append(m.alive_landmarks())
    return m, windows


def test_mapstore_sequence_equal():
    tm, tw = _map_ops(tmapstore)
    jm, jw = _map_ops(jmapstore)
    assert tm.stats() == jm.stats()
    for k in ("landmark_pos", "landmark_alive", "landmark_obs_count",
              "landmark_stamp", "kf_pose", "kf_frame_id", "kf_valid",
              "kf_stamp", "kf_obs_uv", "kf_obs_lm", "kf_obs_valid",
              "kf_obs_stamp", "window_barrier", "free_landmark_capacity"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), k)
    assert len(tm.archive) == len(jm.archive) > 0
    for a, b in zip(tm.archive.arrays(), jm.archive.arrays()):
        np.testing.assert_array_equal(a, b)
    assert len(tw) == len(jw)
    for x, y in zip(tw, jw):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)


def _trajectories(n=320, seed=0):
    """Seeded ground truth (camera->world, ~1 m steps, slow yaw) and a noisy
    estimate (world->camera, at another scale)."""
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4), (n, 1, 1))
    yaw, pos = 0.0, np.zeros(3)
    for i in range(1, n):
        yaw += rng.normal(0, 0.01)
        pos = pos + np.array([np.sin(yaw), 0.0, np.cos(yaw)]) \
            * (1.0 + rng.normal(0, 0.05))
        c, s = np.cos(yaw), np.sin(yaw)
        gt[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        gt[i, :3, 3] = pos
    est_cw = gt.copy()
    est_cw[:, :3, 3] = 0.37 * (gt[:, :3, 3] + rng.normal(0, 0.2, (n, 3)))
    return np.linalg.inv(est_cw), gt


@pytest.mark.parametrize("metric", [
    lambda ev, e, g: ev.ate_rmse(e, g, with_scale=True),
    lambda ev, e, g: ev.ate_rmse(e, g, with_scale=False),
    lambda ev, e, g: ev.rpe(e, g, delta=5),
    lambda ev, e, g: ev.sim3_scale(e, g),
    lambda ev, e, g: ev.kitti_segment_errors(e, g),
], ids=["ate_sim3", "ate_se3", "rpe", "sim3_scale", "kitti_segments"])
def test_evaluation_equal(metric):
    est, gt = _trajectories()
    t, j = metric(tevaluation, est, gt), metric(jevaluation, est, gt)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert np.all(np.isfinite(np.asarray(t)))


@pytest.mark.parametrize("margin", [5, 20])
def test_project_tracks_equal(margin):
    from ya_vo_tpu.utils import synthetic as jsynthetic
    from ya_vo_tpu_torch.utils import synthetic as tsynthetic

    lms = jsynthetic.random_landmarks(300, seed=4)
    lms[:5, 2] = -lms[:5, 2]                     # behind the camera
    poses = jsynthetic.forward_trajectory(6, step=0.5, yaw_rate=0.01)
    ref = jsynthetic.project_tracks(lms, poses, jsynthetic.kitti_camera(),
                                    376, 1241, margin=margin)
    out = tsynthetic.project_tracks(lms, poses, tsynthetic.kitti_camera(),
                                    376, 1241, margin=margin)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert 0 < out[1].sum() < out[1].size


@pytest.mark.parametrize("module,import_line", [
    ("io/prefetch.py", None),
    ("io/native_loader.py", None),
    ("viz/live.py", None),
    ("viz/render.py", "from ya_vo_tpu.viz.evaluation import"),
])
def test_copied_modules_equal(module, import_line):
    with open(os.path.join(REPO, "ya_vo_tpu", module)) as fp:
        orig = fp.read()
    with open(os.path.join(REPO, "ya_vo_tpu_torch", module)) as fp:
        copy = fp.read()
    if import_line is not None:
        assert orig.count(import_line) == 1
        orig = orig.replace(import_line, import_line.replace(
            "ya_vo_tpu.", "ya_vo_tpu_torch."))
    assert copy == orig
    assert "ya_vo_tpu." not in copy
