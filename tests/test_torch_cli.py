"""The port's entry point, `python -m ya_vo_tpu_torch.run_vo`, on the CPU
(`--device cpu`): against the JAX package's `run_vo.py` on the same
`--synthetic` arguments, and through a KITTI odometry tree of PNG frames
under the reference's 3-key config (tests/test_kitti_layout.py's run),
with window BA synchronous and asynchronous.

As in tests/test_torch_frontend.py, the JAX run tracks with the TPU
kernel's LK semantics and the port's bootstrap is handed the JAX RANSAC
draw."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_frontend import _inject_jax_draw, _tpu_semantics_lk
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu_torch import run_vo as trun_vo
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.utils import checkpoint
from ya_vo_tpu_torch.utils.scene import TexturedSequence

SUMMARY_KEYS = {
    "frames", "fps", "resets", "ba_runs", "n_landmarks", "n_alive",
    "n_keyframes", "n_free", "n_recycled", "n_retired",
    "n_evicted_keyframes", "n_dropped_landmarks", "ate_sim3_m", "ate_se3_m",
    "rpe_trans_m", "rpe_rot_deg", "scale_drift_rms_log"}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _synthetic_args(tmp_path, tag):
    return ["--synthetic", "--synthetic-frames", "8",
            "--synthetic-size", "256", "768",
            "--traj", str(tmp_path / f"{tag}.txt"),
            "--plot", str(tmp_path / f"{tag}.png"),
            "--checkpoint", str(tmp_path / f"{tag}.npz")]


def test_cli_synthetic_matches_jax(tmp_path, capsys, monkeypatch):
    """The same summary keys, frames, resets and solves as the JAX CLI;
    ATE_sim3 within 5e-3 of it (the bootstrap's float32 solve and the
    window solves differ in the last bits, test_torch_frontend.py), both
    under test_cli.py's 0.2; the trajectory file, the plot and a
    checkpoint that loads back. The CLI's VOConfig has the default
    `ba.distributed="auto"`, so each side runs the landmark-sharded
    backend: the JAX CLI over the test session's eight virtual devices,
    the port over eight CPU shards (`landmark_mesh` monkeypatched, as a
    host with eight cards would give it)."""
    import run_vo
    from ya_vo_tpu.tracking import frontend as jfrontend
    from ya_vo_tpu_torch.parallel import mesh as mesh_lib
    from ya_vo_tpu_torch.tracking import frontend as tfrontend

    made = []
    for mod in (jfrontend, tfrontend):
        class Recorded(mod.Frontend):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        monkeypatch.setattr(mod, "Frontend", Recorded)
    monkeypatch.setattr(mesh_lib, "landmark_mesh", lambda *a, **k: (
        mesh_lib.Mesh([torch.device("cpu")] * 8, ("lm",))))
    monkeypatch.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
    assert run_vo.main(_synthetic_args(tmp_path, "jax")) == 0
    ref = _last_json(capsys)
    _inject_jax_draw(monkeypatch, 7)
    assert trun_vo.main(_synthetic_args(tmp_path, "port")
                        + ["--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert len(made) == 2
    assert all(fe._dist_ba is not None for fe in made)
    assert made[1]._dist_ba[1].size == 8
    assert set(out) == set(ref) == SUMMARY_KEYS
    for k in ("frames", "resets", "ba_runs", "n_keyframes"):
        assert out[k] == ref[k], (k, out, ref)
    assert out["frames"] == 8 and out["resets"] == 0
    assert abs(out["ate_sim3_m"] - ref["ate_sim3_m"]) < 5e-3, (out, ref)
    assert out["ate_sim3_m"] < 0.2
    assert os.path.getsize(tmp_path / "port.png") > 1000
    rows = np.loadtxt(tmp_path / "port.txt")
    assert rows.shape == (8, 12)
    ckpt = np.load(tmp_path / "port.npz")
    assert set(ckpt.files) == set(np.load(tmp_path / "jax.npz").files)
    assert int(ckpt["frame_id"]) == 7


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun_vo.main(["--synthetic", "--synthetic-frames", "2"])


def _build_dataset(base, seq="07", n_frames=8):
    """tests/test_kitti_layout.py's tree at 256x768 (the KITTI camera's
    focal length and centre scaled to the smaller frame), rendered by the
    port on the CPU: PNG frames, calib.txt, poses/<seq>.txt."""
    from PIL import Image

    s = 768 / 1241
    cam = Camera.create(718.856 * s, 718.856 * s, 607.1928 * s,
                        185.2157 * 256 / 376)
    ts = TexturedSequence(n_frames=n_frames, seed=3, noise_sigma=0.0,
                          height=256, width=768, cam=cam, tex_size=512,
                          device="cpu")
    img_dir = os.path.join(base, "sequences", seq, "image_0")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(base, "poses"))
    for f in range(n_frames):
        img = ts.frame(f).numpy()
        Image.fromarray(img).save(os.path.join(img_dir, f"{f:06d}.png"))
    row = f"{cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0"
    with open(os.path.join(base, "sequences", seq, "calib.txt"), "w") as fp:
        fp.write(f"P0: {row}\nP1: {row}\n")
    gt_cw = np.linalg.inv(ts.poses)
    np.savetxt(os.path.join(base, "poses", f"{seq}.txt"),
               gt_cw[:, :3, :4].reshape(n_frames, 12))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("kitti") / "dataset")
    os.makedirs(base)
    _build_dataset(base)
    return base


@pytest.mark.parametrize("asynchronous", [False, True])
def test_cli_on_kitti_layout(dataset, tmp_path, capsys, asynchronous):
    """tests/test_kitti_layout.py's run on the port: the reference's 3-key
    config, with a `ba` entry that solves at every keyframe from the third
    (so the 8 frames' 4 keyframes run two solves) and sets `asynchronous`;
    calib parse, sorted listing, PNG decode, frontend, ATE against the
    poses file: 8 frames, 0 resets, at least one solve applied, ATE_sim3
    under 0.25, the trajectory file; and a resume from the written
    checkpoint reloads the session."""
    raw = {"basePath": dataset, "sequence": "07", "cameraType": "mono",
           "ba": {"asynchronous": asynchronous, "every_n_keyframes": 1}}
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fp:
        json.dump(raw, fp)
    traj_path = str(tmp_path / "poses_est.txt")
    ckpt_path = str(tmp_path / "state.npz")
    fe, summary = trun_vo.session(["--config", cfg_path, "--traj", traj_path,
                                   "--checkpoint", ckpt_path,
                                   "--device", "cpu"])
    assert fe.cfg.ba.asynchronous is asynchronous
    assert set(summary) == SUMMARY_KEYS
    assert summary["frames"] == 8
    assert summary["resets"] == 0
    assert summary["ba_runs"] >= 1 and fe.n_ba_discarded == 0
    assert summary["ate_sim3_m"] < 0.25, summary
    assert np.loadtxt(traj_path).shape == (8, 12)
    assert fe._ba_pending is None       # the final save drained the backend
    fe2 = type(fe)(fe.cfg, fe.cam, device="cpu")
    checkpoint.load_frontend(fe2, ckpt_path)
    assert fe2.frame_id == 7 and len(fe2.trajectory) == 8
    np.testing.assert_array_equal(fe2.last_pose, fe.last_pose)
