"""The port's frontend with the landmark-sharded backend
(`ba.distributed="auto"`) against the JAX package's, on the CPU: the
counterparts of tests/test_dist_ba.py's frontend tests, on their 256x768
sequence and config (1024 keypoints, a solve every keyframe, 1024 window
landmarks). The JAX frontend shards over the test session's eight virtual
CPU devices; the port's is given eight CPU shards by monkeypatching
`ya_vo_tpu_torch.parallel.mesh.landmark_mesh`, as a host with eight cards
would give it eight.

As in tests/test_torch_reset.py, the JAX frontend tracks with the TPU
kernel's LK semantics and the port starts from the JAX state after the
bootstrap (the two bootstraps' float32 eigen-solves differ)."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_frontend import _snapshot, _tpu_semantics_lk
from ya_vo_tpu.config import FeatureConfig, TrackConfig
from ya_vo_tpu.config import VOConfig as JVOConfig
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.parallel import mesh as mesh_lib
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import convert

N_FRAMES = 16


def jax_config(asynchronous: bool) -> JVOConfig:
    """tests/test_dist_ba.py's config."""
    c = JVOConfig(image_height=256, image_width=768,
                  features=FeatureConfig(max_keypoints=1024),
                  tracking=TrackConfig(min_ba_inliers=15,
                                       min_flow_inliers=5))
    return dataclasses.replace(c, ba=dataclasses.replace(
        c.ba, asynchronous=asynchronous, distributed="auto",
        every_n_keyframes=1, max_window_landmarks=1024))


def port(asynchronous: bool, cam) -> Frontend:
    return Frontend(VOConfig.from_dict(dataclasses.asdict(
        jax_config(asynchronous))), convert.camera_from_numpy(cam),
        device="cpu")


def eight_cpu_shards(*args, **kwargs) -> mesh_lib.Mesh:
    """`landmark_mesh`'s stand-in: eight shards on the CPU."""
    return mesh_lib.Mesh([torch.device("cpu")] * 8, ("lm",))


@pytest.fixture
def eight_shards(monkeypatch):
    monkeypatch.setattr(mesh_lib, "landmark_mesh", eight_cpu_shards)


@pytest.fixture(scope="module")
def sequence():
    return jsynthetic.render_sequence(
        n_frames=N_FRAMES, n_landmarks=500, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7)


@pytest.fixture(scope="module")
def jax_runs(sequence):
    """The JAX frontend with the sharded backend, synchronous and
    asynchronous, pipelined, each with a snapshot after the bootstrap. The
    asynchronous run tracks with the JAX package's own CPU LK, as
    tests/test_dist_ba.py runs it: the host callback of the TPU kernel's
    semantics holds an XLA CPU thread while the backend thread's sharded
    solve waits for all eight virtual devices at its all-reduce, and XLA
    aborts the process after 40 s of that wait."""
    imgs, _, _, cam = sequence
    out = {}
    for asynchronous in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if not asynchronous:
                mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
            jfe = JFrontend(jax_config(asynchronous), cam)
            assert jfe._dist_ba is not None
            jfe.run(imgs[:2], pipelined=False)
            snap = _snapshot(jfe)
            jfe.run(imgs[2:], pipelined=True)
        out[asynchronous] = (jfe, snap)
    return out


def _ate(traj, poses_gt):
    return evaluation.ate_rmse(traj, np.linalg.inv(poses_gt),
                               with_scale=True)


@pytest.fixture(scope="module")
def port_sync(sequence, jax_runs):
    """The port, synchronous, from the JAX state after the bootstrap."""
    imgs, _, _, cam = sequence
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_lib, "landmark_mesh", eight_cpu_shards)
        fe = port(False, cam)
    convert.frontend_state_from_numpy(fe, jax_runs[False][1])
    traj = fe.run(imgs[2:], pipelined=True)
    return fe, traj


def test_sync_sharded_backend_matches_jax(sequence, jax_runs, port_sync):
    """tests/test_dist_ba.py::test_frontend_backend_uses_dist_solver's
    rules (the sharded solver built, at least one solve, no reset,
    ATE_sim3 under 0.05) on both sides, and the port against JAX from the
    bootstrap as tests/test_torch_reset.py holds the single-device
    backend: the same keyframe flags, solves and discards; camera centres
    within test_dist_ba.py's 0.15 between two solvers. The solves at every
    keyframe compound float32 differences keyframe by keyframe: over these
    14 frames the two packages' single-device backends end 0.062 apart,
    their sharded ones 0.067 (measured on the CPU)."""
    imgs, poses_gt, _, _ = sequence
    jfe = jax_runs[False][0]
    fe, traj = port_sync
    assert fe._dist_ba is not None and fe._dist_ba[1].size == 8
    assert fe.n_ba_runs == jfe.n_ba_runs > 0
    assert fe.n_ba_discarded == jfe.n_ba_discarded == 0
    assert fe.n_resets == jfe.n_resets == 0
    assert [r.is_keyframe for r in fe.results] == \
        [r.is_keyframe for r in jfe.results[2:]]
    c_port = evaluation.positions_from_poses(traj)
    c_ref = evaluation.positions_from_poses(np.stack(jfe.trajectory[2:]))
    assert np.abs(c_port - c_ref).max() < 0.15
    full = np.concatenate([np.stack(jfe.trajectory[:2]), traj])
    assert _ate(full, poses_gt) < 0.05
    assert _ate(np.stack(jfe.trajectory), poses_gt) < 0.05


def test_async_sharded_backend_applies_refinement(sequence, jax_runs,
                                                  port_sync, eight_shards):
    """tests/test_dist_ba.py::test_async_distributed_backend_applies_
    refinement's rules on both sides: the asynchronous sharded backend
    applies at least one solve through the apply gates, no reset,
    ATE_sim3 under 0.08 and under max(0.05, 3x) the synchronous sharded
    run's (applies land at wall-clock-dependent frames, so frames are not
    compared one by one)."""
    imgs, poses_gt, _, cam = sequence
    fe = port(True, cam)
    assert fe._dist_ba is not None
    convert.frontend_state_from_numpy(fe, jax_runs[True][1])
    traj = np.concatenate([np.stack(jax_runs[True][0].trajectory[:2]),
                           fe.run(imgs[2:], pipelined=True)])
    ate_s = _ate(np.concatenate([np.stack(jax_runs[False][0].trajectory[:2]),
                                 port_sync[1]]), poses_gt)
    for f, t in ((fe, traj), (jax_runs[True][0],
                              np.stack(jax_runs[True][0].trajectory))):
        assert f.n_ba_runs >= 1
        assert f.n_resets == 0
        ate = _ate(t, poses_gt)
        assert ate < 0.08, ate
        assert ate < max(0.05, 3 * ate_s), (ate, ate_s)
