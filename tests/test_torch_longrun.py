"""The map's lifecycle, the long run and the reset and BA dumps of the port
against the JAX package, on the CPU.

(a) Keyframe eviction and landmark retirement: test_torch_reset.py's
    config (synchronous window BA, push apply) with a window of 4
    keyframes, `max_keyframes=8` and `max_landmarks=600`, over 22 frames
    of test_frontend_e2e.py's 256x768 stamps sequence, so both fire within
    the run. The JAX frontend (LK with the TPU kernel's semantics, as in
    test_torch_frontend.py) runs synchronously; the port continues
    pipelined from its state after the bootstrap: the same statuses and
    keyframe flags frame by frame, the same window solves, camera centres
    within 5e-3 map units (test_torch_reset.py's bound with BA on), and at
    the end the same keyframe ring, evictions and slot high-water mark,
    and landmark counts within 2% of the slots in use (a one-track LK flip
    at float noise kills one landmark more or less). JAX's own run must
    evict and retire.
(b) `ya_vo_tpu_torch.longrun.main` at 188x620 over the first 14 frames of
    a 20-frame route: the record
    has tools/longrun.py's keys plus `longrun.PORT_KEYS`, and the KITTI
    round trip gives the same ATE_sim3 and frame count; its CLI writes the
    tool's record layout.
(c) The dumps: `YA_VO_DUMP_RESET_DIR` on test_torch_reset.py's blackout and
    `YA_VO_DUMP_BA_DIR` with the divergence gate forced to reject every
    solve: the port writes the JAX package's files, by name, with its
    keys, dtypes and shapes.
"""

import json
import os
import pickle
import re

import numpy as np
import pytest
import torch

from tests.test_torch_frontend import (SEQ, _inject_jax_draw, _snapshot,
                                       _tpu_semantics_lk)
from tests.test_torch_reset import blackout, make_config
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch import longrun
from ya_vo_tpu_torch.config import with_option
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIFECYCLE_FRAMES = 22
TOL = 5e-3


def lifecycle_config():
    cfg = make_config()
    return with_option(cfg, "map", window_size=4, max_keyframes=8,
                       max_landmarks=600)


def port(cam, cfg):
    return tfrontend.Frontend(cfg, convert.camera_from_numpy(cam),
                              device="cpu")


def test_eviction_and_retirement_match_jax():
    imgs, _, _, cam = jsynthetic.render_sequence(
        **dict(SEQ, n_frames=LIFECYCLE_FRAMES))
    cfg = lifecycle_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(cfg, cam)
        for i, img in enumerate(imgs):
            jfe.process(img)
            if i == 1:
                snap = _snapshot(jfe)
    stats = jfe.map.stats()
    assert stats["n_evicted_keyframes"] >= 1 and stats["n_retired"] >= 1, \
        stats
    assert jfe.n_resets == 0 and jfe.n_ba_runs >= 1

    fe = port(cam, cfg)
    convert.frontend_state_from_numpy(fe, snap)
    traj = fe.run(imgs[2:], pipelined=True)
    ref = jfe.results[2:]
    assert [r.status for r in fe.results] == [r.status for r in ref]
    assert [r.is_keyframe for r in fe.results] == \
        [r.is_keyframe for r in ref]
    assert fe.n_ba_runs == jfe.n_ba_runs and fe.n_resets == 0
    err = np.abs(evaluation.positions_from_poses(traj)
                 - evaluation.positions_from_poses(
                     np.stack(jfe.trajectory[2:]))).max()
    assert err < TOL, err
    # the keyframe ring and the slot high-water mark equal; the landmark
    # counts within 2% of the slots in use, the gate counts' tolerance (a
    # one-track LK flip at float noise kills one landmark more or less, and
    # the next retirement wave carries it)
    got = fe.map.stats()
    for k in ("n_landmarks", "n_keyframes", "n_evicted_keyframes",
              "n_dropped_landmarks"):
        assert got[k] == stats[k], (k, got, stats)
    for k in ("n_alive", "n_free", "n_recycled", "n_retired"):
        assert abs(got[k] - stats[k]) <= 0.02 * stats["n_landmarks"], \
            (k, got, stats)


def _tool_keys():
    """The keys of a variant's record in tools/longrun.py's `main`, and
    those it writes only past 100 m (the KITTI segments)."""
    with open(os.path.join(REPO, "tools", "longrun.py")) as f:
        src = f.read()
    body = src[src.index("    out = {"):src.index("    print(json.dumps(out))")]
    keys = set(re.findall(r'"(\w+)":', body))
    keys |= set(re.findall(r'out\["(\w+)"\]', body))
    return keys, {"kitti_t_err_pct", "kitti_r_err_deg_per_m",
                  "kitti_n_segments"}


SMALL = dict(n_frames=14, world_frames=20, height=188, width=620,
             cam=Camera.create(359.428, 359.428, 303.5964, 92.60785),
             device="cpu", tex_size=512, probe_steps=2, max_keyframes=4)


@pytest.fixture(scope="module")
def small_record():
    return longrun.main(**SMALL)


def test_longrun_record_at_a_tiny_size(small_record):
    """The record's keys are the tool's (no KITTI segment under 100 m) and
    the port's; the KITTI round trip scores the trajectory it wrote;
    `max_keyframes=4` makes the run evict."""
    rec = small_record
    keys, seg = _tool_keys()
    assert "kitti_roundtrip_ate_sim3_m" in keys and "rss_mb" in keys
    assert set(rec) == (keys - seg) | set(longrun.PORT_KEYS)
    assert rec["backend"] == "cpu" and rec["n_frames"] == 14
    assert rec["kitti_roundtrip_frames"] == 14
    assert rec["kitti_roundtrip_ate_sim3_m"] == rec["ate_sim3_m"]
    assert np.isfinite(rec["ate_sim3_m"]) and rec["ate_sim3_m"] < 0.5
    assert rec["evicted_keyframes"] >= 1
    assert rec["first_eviction_frame"] is not None
    assert rec["dropped_landmarks"] == 0
    assert set(rec["launches_per_frame"]) == {"fast_score", "fast_select",
                                              "hamming", "lk_level",
                                              "pose_gn", "window_gn"}


def test_longrun_cli_writes_the_tools_layout(small_record, tmp_path,
                                             monkeypatch):
    """The CLI's record: the tool's top-level keys, the procedural variant
    from `main`, the photo variant skipped with the tool's wording (by
    flag, or naming the reference's fixture, which the repository does
    not hold), and no file with `--stdout-only`. Without a card, the
    default device raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            longrun.run(14)
    calls = []

    def main(n_frames, seed, photo=None, device="cuda"):
        calls.append((n_frames, seed, photo, device))
        return small_record

    monkeypatch.setattr(longrun, "main", main)
    out = tmp_path / "longrun.json"
    rec = longrun.cli(["--frames", "14", "--no-photo", "--out", str(out),
                       "--device", "cpu"])
    assert calls == [(14, 11, None, "cpu")]
    assert set(rec) == {"generated_by", "date", "frames_per_variant", "seed",
                        "variants"}
    assert rec["variants"]["photo"] == {"skipped": "--no-photo"}
    assert json.loads(out.read_text()) == rec
    rec = longrun.cli(["--frames", "14", "--stdout-only", "--seed", "3"])
    assert calls[-1] == (14, 3, None, "cuda")
    assert rec["variants"]["photo"] == {
        "skipped": "reference fixture absent (reference/tests/epilines.png)"}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_layout(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype,
                                                           y.dtype, x.shape,
                                                           y.shape)


def _run_both(seq, cfg, cam, monkeypatch, env, jdir, pdir):
    """The JAX frontend (synchronous driver) and the port (pipelined, JAX's
    draws injected) over `seq`, with the dump variable `env` naming `jdir`
    and `pdir` in turn."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        mp.setenv(env, str(jdir))
        jfe = JFrontend(cfg, cam)
        for img in seq:
            jfe.process(img)
    monkeypatch.setenv(env, str(pdir))
    _inject_jax_draw(monkeypatch, cfg.ransac.seed)
    fe = port(cam, cfg)
    fe.run(seq, pipelined=True)
    return jfe, fe


def test_reset_dump_matches_jax(tmp_path, monkeypatch):
    imgs, _, _, cam = jsynthetic.render_sequence(**SEQ)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jfe, fe = _run_both(blackout(imgs), make_config(), cam, monkeypatch,
                        "YA_VO_DUMP_RESET_DIR", jdir, pdir)
    assert fe.n_resets == jfe.n_resets >= 1
    names = sorted(os.listdir(jdir))
    assert names and sorted(os.listdir(pdir)) == names
    for name in names:
        j, p = _npz(jdir / name), _npz(pdir / name)
        assert len(j) == 17
        _same_layout(p, j, name)
        assert int(p["frame_id"]) == int(j["frame_id"])
        assert int(p["n_flow"]) < make_config().tracking.min_flow_inliers


def test_rejected_solve_dump_matches_jax(tmp_path, monkeypatch):
    imgs, _, _, cam = jsynthetic.render_sequence(**SEQ)
    cfg = with_option(make_config(), "ba", max_correction_steps=1e-9,
                      max_correction_rot_deg=1e-9)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jfe, fe = _run_both(list(imgs), cfg, cam, monkeypatch,
                        "YA_VO_DUMP_BA_DIR", jdir, pdir)
    assert fe.n_ba_runs == jfe.n_ba_runs == 0
    assert fe.n_ba_discarded == jfe.n_ba_discarded >= 1
    names = sorted(os.listdir(jdir))
    assert len(names) == jfe.n_ba_discarded
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        with open(jdir / name, "rb") as f:
            j = pickle.load(f)
        with open(pdir / name, "rb") as f:
            p = pickle.load(f)
        assert p.keys() == j.keys() == {"prob", "new_poses", "t_corr",
                                        "r_corr"}
        assert p["prob"]._fields == j["prob"]._fields
        _same_layout(p["prob"]._asdict(), j["prob"]._asdict(), name)
        _same_layout({"new_poses": p["new_poses"]},
                     {"new_poses": j["new_poses"]}, name)
        assert type(p["t_corr"]) is type(j["t_corr"]) is float
        assert type(p["r_corr"]) is type(j["r_corr"]) is float
