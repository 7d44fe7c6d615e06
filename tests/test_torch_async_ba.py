"""Asynchronous window BA in the port (`ba.asynchronous=True`): the solve
runs on a backend worker (on the card, on its own CUDA stream) while
tracking goes on, and `_poll_ba` applies it through the staleness and
divergence gates. On test_frontend_e2e.py's 10-frame 256x768 sequence,
on the CPU: the asynchronous run's ATE_sim3 within max(2x, 0.05) of the
synchronous run's (test_frontend_e2e.py's bound), `finish()` draining the
backend, deferral behind a slow solve, a failing solve re-raised by
`finish()` and logged and dropped by `_poll_ba` (in both packages), and
the observers firing once a frame on both drivers."""

import concurrent.futures
import dataclasses
import logging
import threading
import time

import numpy as np
import pytest

from tests.test_frontend_e2e import make_config as e2e_config
from ya_vo_tpu.ba import window as jwindow
from ya_vo_tpu.core import camera as jcamera
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu_torch.ba import window as ba_window
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.viz import evaluation


def make_config(asynchronous: bool, **ba) -> VOConfig:
    """test_frontend_e2e.py's config with push apply, as the port's own
    VOConfig, BA synchronous or not."""
    cfg = VOConfig.from_dict(dataclasses.asdict(
        e2e_config(sync_ba=True, apply_mode="push")))
    return dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, asynchronous=asynchronous, **ba))


@pytest.fixture(scope="module")
def sequence():
    return synthetic.render_sequence(
        n_frames=10, n_landmarks=500, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7)


def _ate(traj, poses):
    return evaluation.ate_rmse(traj, np.linalg.inv(poses), with_scale=True)


@pytest.mark.parametrize("pipelined", [True, False])
def test_async_matches_sync_within_tolerance(sequence, pipelined):
    imgs, poses, _, cam = sequence
    fe_a = Frontend(make_config(True), cam, device="cpu")
    traj_a = fe_a.run(imgs, pipelined=pipelined)
    fe_s = Frontend(make_config(False), cam, device="cpu")
    traj_s = fe_s.run(imgs, pipelined=pipelined)
    ate_a, ate_s = _ate(traj_a, poses), _ate(traj_s, poses)
    assert ate_a < max(2.0 * ate_s, 0.05), (ate_a, ate_s)
    assert fe_a.n_ba_runs >= 1
    assert fe_a.n_ba_discarded <= fe_a.n_ba_runs
    assert fe_a.n_resets == fe_s.n_resets == 0
    # run() ends with finish(): nothing in flight, nothing deferred
    assert fe_a._ba_pending is None and not fe_a._ba_deferred
    assert len(fe_a.ba_ms) >= fe_a.n_ba_runs


def _slow_solves(monkeypatch, seconds):
    """Every backend solve sleeps first (a slow host)."""
    solve = Frontend._solve

    def slow(self, prob):
        time.sleep(seconds)
        return solve(self, prob)

    monkeypatch.setattr(Frontend, "_solve", slow)


def test_finish_drains_the_backend(sequence, monkeypatch):
    """With slow solves, a window asked for while one is in flight is
    deferred; finish() waits for the solve in flight, applies it, solves
    the deferred window with a fresh snapshot and leaves nothing
    pending."""
    imgs, _, _, cam = sequence
    _slow_solves(monkeypatch, 1.0)
    fe = Frontend(make_config(True, every_n_keyframes=1), cam, device="cpu")
    for img in imgs:
        fe.process(img)
    deferred = fe.n_ba_deferred
    # two windows at the end: the second finds the first in flight
    fe._run_window_ba(force=True)
    fe._run_window_ba(force=True)
    assert fe._ba_pending is not None and fe._ba_deferred
    assert fe.n_ba_deferred > deferred
    calls = len(fe.ba_ms)
    fe.finish()
    assert fe._ba_pending is None and not fe._ba_deferred
    assert len(fe.ba_ms) == calls + 2       # the one in flight, the deferred
    assert len(fe.ba_ms) == fe.n_ba_runs + fe.n_ba_discarded
    assert fe.n_ba_runs >= 1
    assert len(fe.trajectory) == len(imgs)


def _jax_frontend(cam):
    """The JAX package's frontend on the same config, BA asynchronous."""
    cfg = e2e_config(sync_ba=True, apply_mode="push")
    return JFrontend(dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, asynchronous=True, distributed="off")),
        jcamera.Camera.create(*(float(c) for c in cam[:4])))


def test_failing_solve_is_logged_and_dropped(sequence, monkeypatch, caplog):
    """Both packages, each frame through `process` until the first window
    solve is submitted; every solve raises once `gate` is set. (1) Held
    pending by the gate, the failing solve makes `finish()` raise the
    solver's error in the caller's thread. (2) Found done by `_poll_ba`,
    it is logged and dropped: nothing applied, nothing left pending, and
    the frontend goes on tracking."""
    imgs, _, _, cam = sequence
    gate = threading.Event()

    def failing(*a, **kw):
        gate.wait()
        raise RuntimeError("solver failed")

    monkeypatch.setattr(ba_window, "solve_window", failing)
    monkeypatch.setattr(jwindow, "solve_window", failing)

    def until_submitted(fe):
        for img in imgs:
            fe.process(img)
            if fe._ba_pending is not None:
                return
        raise AssertionError("no window solve was submitted")

    builds = {"jax": lambda: _jax_frontend(cam),
              "port": lambda: Frontend(make_config(True), cam, device="cpu")}
    for name, build in builds.items():
        gate.clear()
        fe = build()
        until_submitted(fe)
        gate.set()
        with pytest.raises(RuntimeError, match="solver failed"):
            fe.finish()

        fe = build()
        until_submitted(fe)
        n_done = len(fe.results)
        concurrent.futures.wait([fe._ba_pending["fut"]])
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            fe._poll_ba()
        failed = [r for r in caplog.records
                  if r.getMessage() == "backend BA solve failed"]
        assert len(failed) == 1, name
        assert "solver failed" in str(failed[0].exc_info[1]), name
        assert fe._ba_pending is None and fe.n_ba_runs == 0, name
        if name == "port":
            assert fe.ba_ms == []
        res = fe.process(imgs[n_done])
        assert res.status == "TRACKING", name


@pytest.mark.parametrize("pipelined", [False, True])
def test_observers_fire_once_a_frame(sequence, pipelined, caplog):
    """Each frame reaches every observer once, in order, on both drivers;
    an observer that raises is logged and tracking goes on."""
    imgs, _, _, cam = sequence
    fe = Frontend(make_config(True), cam, device="cpu")
    seen = []

    def bad(r):
        raise ValueError("viewer down")

    fe.observers += [lambda r: seen.append((r.frame_id, r.status)), bad]
    with caplog.at_level(logging.ERROR, logger="ya_vo_tpu_torch.frontend"):
        fe.run(imgs, pipelined=pipelined)
    assert [f for f, _ in seen] == list(range(10))
    assert [s for _, s in seen] == [r.status for r in fe.results]
    assert sum(r.getMessage() == "frame observer failed"
               for r in caplog.records) == 10
