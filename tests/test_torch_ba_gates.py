"""The cases of tests/test_ba_gates.py on the port, side by side with the
JAX package: the asynchronous apply's staleness discard, the slow-host
backoff that widens the staleness window after three discards and its
recovery, and the divergence gate's running-median step reference. The
JAX and port frontends get the same map and the same solve result; each
case checks the same outcome on both (applied or not, `n_ba_discarded`,
`_stale_relax`) and, where the result is applied, the same written-back
map and re-anchored live pose (atol 1e-6: the same float32 numpy)."""

import numpy as np
import pytest

from ya_vo_tpu.config import BAConfig as JBAConfig
from ya_vo_tpu.config import VOConfig as JVOConfig
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu_torch.config import BAConfig, VOConfig
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import synthetic


def _with_map(fe, synth):
    """test_ba_gates.py's fixture map: 32 landmarks seen by 3 keyframes."""
    lms = synth.random_landmarks(32, seed=0)
    ids = fe.map.add_landmarks(lms, np.ones(32, bool))
    poses = synth.forward_trajectory(3, step=0.5)
    O = fe.map.max_obs_per_kf
    for w in range(3):
        uv = np.zeros((O, 2), np.float32)
        lm = np.full(O, -1, np.int32)
        ok = np.zeros(O, bool)
        lm[:32] = ids
        ok[:32] = True
        fe.map.insert_keyframe(w, poses[w], uv, lm, ok)
    fe.last_pose = poses[-1].copy()
    return fe


@pytest.fixture()
def pair():
    """(JAX frontend, port frontend) holding the same map."""
    jfe = JFrontend(JVOConfig(ba=JBAConfig(asynchronous=False,
                                           distributed="off")),
                    jsynthetic.kitti_camera())
    tfe = Frontend(VOConfig(ba=BAConfig(asynchronous=False,
                                        distributed="off")),
                   synthetic.kitti_camera(), device="cpu")
    return _with_map(jfe, jsynthetic), _with_map(tfe, synthetic)


def _apply(fe, *, n_stale_extra=0, corr_t=0.0):
    """test_ba_gates.py's driver: one _apply_ba_result with a snapshot
    `n_stale_extra` keyframes stale and a translation-only correction of
    norm `corr_t`; returns whether it applied."""
    slots = np.array([0, 1, 2])
    used = np.arange(32)
    anchor_old = fe.map.kf_pose[2].copy()
    new_poses = fe.map.kf_pose[:3].copy()
    new_poses[2][:3, 3] += [corr_t, 0, 0]
    new_lms = fe.map.landmark_pos[used].copy()
    kf_stamp_snap = fe.map.kf_stamp_counter - n_stale_extra
    lm_stamp_snap = fe.map.lm_stamp_counter
    before = fe.n_ba_runs
    fe._apply_ba_result(new_poses, new_lms, slots, used, 3, anchor_old,
                        1.0, kf_stamp_snap=kf_stamp_snap,
                        lm_stamp_snap=lm_stamp_snap)
    return fe.n_ba_runs > before


def _both(pair, **kw):
    """Drive both frontends alike; check they agree and return the
    outcome."""
    jfe, tfe = pair
    applied = _apply(jfe, **kw)
    assert _apply(tfe, **kw) == applied
    assert tfe.n_ba_discarded == jfe.n_ba_discarded
    assert tfe._stale_relax == jfe._stale_relax
    assert tfe._consec_stale_discards == jfe._consec_stale_discards
    n = jfe.map.n_keyframes
    np.testing.assert_allclose(tfe.map.kf_pose[:n], jfe.map.kf_pose[:n],
                               atol=1e-6)
    np.testing.assert_allclose(tfe.map.landmark_pos, jfe.map.landmark_pos,
                               atol=1e-6)
    np.testing.assert_allclose(tfe.last_pose, jfe.last_pose, atol=1e-6)
    assert tfe._state_dirty == jfe._state_dirty
    return applied


def test_fresh_result_applies(pair):
    assert _both(pair)
    assert pair[1].n_ba_discarded == 0


def test_stale_result_discarded(pair):
    limit = pair[1].cfg.ba.max_stale_keyframes
    assert not _both(pair, n_stale_extra=limit + 1)
    assert pair[1].n_ba_discarded == 1


def test_slow_host_backoff_widens_staleness_window(pair):
    limit = pair[1].cfg.ba.max_stale_keyframes
    for _ in range(3):
        assert not _both(pair, n_stale_extra=limit + 1)
    assert pair[1]._stale_relax > 0
    assert _both(pair, n_stale_extra=limit + 1)


def test_applied_results_shrink_the_relaxation(pair):
    for fe in pair:
        fe._stale_relax = 3
    assert _both(pair)
    assert pair[1]._stale_relax == 2


def test_divergence_gate_uses_median_step_when_stationary(pair):
    for fe in pair:
        fe.rel_motion = np.eye(4, dtype=np.float32)
        fe._recent_steps.extend([0.5] * 10)
    assert _both(pair, corr_t=0.25 * pair[1].cfg.ba.max_correction_steps)


def test_divergence_gate_still_rejects_teleports(pair):
    for fe in pair:
        fe.rel_motion = np.eye(4, dtype=np.float32)
        fe._recent_steps.extend([0.5] * 10)
    assert not _both(pair, corr_t=10.0 * pair[1].cfg.ba.max_correction_steps)
    assert pair[1].n_ba_discarded == 1
