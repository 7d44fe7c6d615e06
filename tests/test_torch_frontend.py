"""The port's frontend slice against the JAX package on
test_frontend_e2e.py's 10-frame 256x768 sequence with window BA off.

On the CPU the JAX frontend tracks with `lk.track`, not with the TPU
kernel's `lk_pallas.track`, which the port follows. The two differ beyond
float noise: the kernel clamps coarse-level windows to the padded level,
which drops ~3% of tracks near the bottom edge that `lk.track` keeps, and
the monocular scale of the two runs then drifts apart by ~4% in 10 frames.
`lk_pallas.track` itself takes ~12 s a call in interpret mode, too slow for
every frame, so the reference run here swaps its LK for the TPU kernel's
semantics through a host callback into the port's plain LK, and keeps
each call's inputs. That LK is held against `lk_pallas` in interpret mode
on two of those calls (and in test_torch_lk.py on border clamps and dead
slots); every other stage of the JAX frontend runs unchanged. The port's bootstrap is
handed the JAX RANSAC draw, since torch cannot reproduce `jax.random`
bits."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.config import FeatureConfig, TrackConfig, VOConfig
from ya_vo_tpu.geometry import ransac as jransac
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking import lk_pallas
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch.geometry import ransac as transac
from ya_vo_tpu_torch.parallel import mesh as mesh_lib
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.tracking import lk_cuda
from ya_vo_tpu_torch.utils import convert
from ya_vo_tpu_torch.utils import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The suite runs in several pytest-xdist workers on one machine, and each
# imports this module while collecting. torch's default of one OpenMP
# thread a core in every worker oversubscribes the cores, and the spinning
# thread teams then slowed single port tests from seconds to minutes (six
# workers: 8.5 s -> 512 s for one test): one intra-op thread a worker.
torch.set_num_threads(1)
SEQ = dict(n_frames=10, n_landmarks=500, height=256, width=768, step=0.4,
           yaw_rate=0.004, seed=7)
SNAPS = (1, 5)   # JAX states after the bootstrap and after frame 5


def make_config():
    cfg = VOConfig(image_height=256, image_width=768,
                   features=FeatureConfig(max_keypoints=1024),
                   tracking=TrackConfig(min_ba_inliers=15,
                                        min_flow_inliers=5))
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba,
                                                           enabled=False))


def _snapshot(jfe):
    arrays = {k: (None if getattr(jfe, k) is None
                  else np.array(getattr(jfe, k)))
              for k in convert.DEVICE_KEYS + convert.HOST_KEYS}
    for k in convert.TENSOR_KEYS:
        v = getattr(jfe, k)
        arrays[k] = tuple(np.array(x) for x in v) if k.endswith("_kp") \
            else np.array(v)
    arrays["status"] = jfe.status.name
    arrays["map"] = convert.map_arrays(jfe.map)
    return arrays


def _tpu_semantics_lk(calls):
    """`lk.auto_track` with the TPU kernel's semantics, as a host callback
    into the port's plain LK; each call's inputs are appended to `calls`."""
    def auto_track(img0, img1, uv0, uv_init, mask, **kw):
        def host(*arrays):
            arrays = tuple(np.array(a) for a in arrays)
            calls.append((arrays, kw))
            out = lk_cuda.track(*(torch.as_tensor(a) for a in arrays), **kw)
            return tuple(x.numpy() for x in out)

        n = uv0.shape[0]
        shapes = (jax.ShapeDtypeStruct((n, 2), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.bool_),
                  jax.ShapeDtypeStruct((n,), jnp.float32))
        return jlk.FlowResult(*jax.pure_callback(host, shapes, img0, img1,
                                                 uv0, uv_init, mask))

    return auto_track


@pytest.fixture(scope="module")
def reference():
    """The JAX frontend, frame by frame (the synchronous driver, which the
    pipelined one reproduces without resets or BA), with a state snapshot
    after each frame in SNAPS and the inputs of each LK call."""
    imgs, poses, _, cam = jsynthetic.render_sequence(**SEQ)
    snaps, lk_calls = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk(lk_calls))
        jfe = JFrontend(make_config(), cam)
        for i, img in enumerate(imgs):
            jfe.process(img)
            if i in SNAPS:
                snaps[i] = _snapshot(jfe)
    return imgs, poses, jfe, snaps, lk_calls


def _port_from_snapshot(jfe, snap):
    fe = tfrontend.Frontend(make_config(), convert.camera_from_numpy(jfe.cam),
                         device="cpu")
    convert.frontend_state_from_numpy(fe, snap)
    return fe


def _inject_jax_draw(monkeypatch, seed):
    """Make each port bootstrap sample the hypotheses of the JAX
    frontend's bootstrap of the same rank (its successive key splits)."""
    state = {"rng": jax.random.PRNGKey(seed)}

    def sample_indices(generator, n_hyp, sample_size, mask):
        state["rng"], key = jax.random.split(state["rng"])
        idx = jransac._sample_indices(key, n_hyp, sample_size,
                                      jnp.asarray(mask.cpu().numpy()))
        return torch.as_tensor(np.array(idx), dtype=torch.int64)

    monkeypatch.setattr(transac, "sample_indices", sample_indices)


def test_render_sequence_byte_identical():
    kw = dict(SEQ, n_frames=3, height=128, width=384)
    j_imgs, j_poses, j_lms, j_cam = jsynthetic.render_sequence(**kw)
    t_imgs, t_poses, t_lms, t_cam = tsynthetic.render_sequence(**kw)
    for a, b in zip(j_imgs, t_imgs):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_poses, t_poses)
    np.testing.assert_array_equal(j_lms, t_lms)
    assert tuple(float(c) for c in j_cam) == tuple(t_cam)


def test_whole_slice_matches_jax(reference, monkeypatch):
    """The whole slice from the first frame, pipelined: the same statuses,
    0 resets on both sides, keyframe flags equal or within 1, the bootstrap
    camera centre within 1e-2 map units of the JAX one (same RANSAC draw;
    float32 eigen-solves, see test_torch_geometry.py), and the trajectory
    accurate against ground truth. Monocular VO amplifies the bootstrap's
    float32 difference into a few percent of scale drift by the last
    frame, so per-frame centres are held tightly in
    test_steady_state_matches_jax, which starts from the JAX bootstrap."""
    imgs, poses, jfe, *_ = reference
    _inject_jax_draw(monkeypatch, make_config().ransac.seed)
    _build.reset_launches()
    fe = create_frontend(make_config(), convert.camera_from_numpy(jfe.cam),
                         device="cpu")
    traj = fe.run(imgs, pipelined=True)
    assert fe.n_resets == 0 and jfe.n_resets == 0
    assert [r.status for r in fe.results] == [r.status for r in jfe.results]
    assert abs(fe.results[1].n_ba_inliers - jfe.results[1].n_ba_inliers) <= 2
    c_port = evaluation.positions_from_poses(traj)
    c_ref = evaluation.positions_from_poses(np.stack(jfe.trajectory))
    assert np.abs(c_port[1] - c_ref[1]).max() < 1e-2
    kf_port = np.array([r.is_keyframe for r in fe.results])
    kf_ref = np.array([r.is_keyframe for r in jfe.results])
    assert (kf_port != kf_ref).sum() <= 1, (kf_port, kf_ref)
    gt_cw = np.linalg.inv(poses)
    assert evaluation.ate_rmse(traj, gt_cw, with_scale=True) < 0.05
    # CPU tensors take the plain versions: no kernel launched
    assert all(n == 0 for n in _build.LAUNCHES.values())


@pytest.mark.parametrize("frame", [2, 9])
def test_lk_at_frontend_scale_matches_pallas_interpret(reference, frame):
    """The reference run tracks with the port's plain LK, so hold that LK
    against the TPU kernel's own `lk_pallas.track` in interpret mode on the
    inputs the JAX frontend gave it on one frame: 1024 slots, 256x768, 3
    levels, seeds moved by the projected motion. uv atol 1e-3 px, status
    equal, residual rtol 1e-4 (as in test_torch_lk.py)."""
    imgs, _, jfe, _, lk_calls = reference
    assert len(lk_calls) == len(imgs) - 2     # one call per tracked frame
    arrays, kw = lk_calls[frame - 2]
    assert arrays[2].shape == (1024, 2)
    ref = lk_pallas.track(*(jnp.asarray(a) for a in arrays), **kw)
    out = lk_cuda.track(*(torch.as_tensor(a) for a in arrays), **kw)
    np.testing.assert_allclose(out.uv.numpy(), np.asarray(ref.uv), atol=1e-3)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.residual.numpy(), np.asarray(ref.residual),
                               rtol=1e-4, atol=1e-3)
    assert out.status.sum() == jfe.results[frame].n_flow_inliers > 150


def test_steady_state_matches_jax(reference):
    """From the JAX state right after the bootstrap, the pipelined port
    tracks frames 2..9 with the same keyframe flags, keypoint counts, gate
    counts within 2% and camera centres within 1e-5 map units on the first
    frame and 5e-3 (5e-4 of the 10-unit path) on the last: float32 sums run
    in another order, and each keyframe's fresh triangulations carry the
    difference forward."""
    imgs, _, jfe, snaps, _ = reference
    fe = _port_from_snapshot(jfe, snaps[1])
    traj = fe.run(imgs[2:], pipelined=True)
    ref = jfe.results[2:]
    assert len(fe.results) == len(ref) == 8
    c_port = evaluation.positions_from_poses(traj)
    c_ref = evaluation.positions_from_poses(np.stack(jfe.trajectory[2:]))
    err = np.abs(c_port - c_ref).max(1)
    assert err[0] < 1e-5 and err.max() < 5e-3, err
    for r, q in zip(fe.results, ref):
        assert r.is_keyframe == q.is_keyframe
        assert r.n_keypoints == q.n_keypoints
        assert abs(r.n_flow_inliers - q.n_flow_inliers) \
            <= 0.02 * q.n_flow_inliers
        assert abs(r.n_ba_inliers - q.n_ba_inliers) <= 0.02 * q.n_ba_inliers


def test_one_fused_step_from_jax_state(reference):
    """Load the JAX state after frame 5 and run frame 6 on both: the same
    keyframe decision and keypoints, gate counts within 2%, the pose within
    1e-4, and the host map replay in step. The map arrives as arrays and
    becomes the port's own MapStore, equal to the JAX one."""
    imgs, _, jfe, snaps, _ = reference
    map_store = snaps[5]["map"]
    fe = _port_from_snapshot(jfe, snaps[5])
    assert type(fe.map).__module__ == "ya_vo_tpu_torch.worldmap.mapstore"
    for k, v in convert.map_arrays(fe.map).items():
        np.testing.assert_array_equal(v, map_store[k], err_msg=k)
    res = fe.process(imgs[6])
    ref = jfe.results[6]
    assert res.status == ref.status == "TRACKING"
    assert res.is_keyframe == ref.is_keyframe
    assert abs(res.n_flow_inliers - ref.n_flow_inliers) \
        <= 0.02 * ref.n_flow_inliers
    assert abs(res.n_ba_inliers - ref.n_ba_inliers) \
        <= 0.02 * ref.n_ba_inliers
    assert res.n_keypoints == ref.n_keypoints
    np.testing.assert_allclose(res.pose_wc, ref.pose_wc, atol=1e-4)
    assert fe.map.n_keyframes == \
        map_store["n_keyframes"] + int(res.is_keyframe)
    assert fe.map.n_landmarks >= map_store["n_landmarks"]


def test_unsupported_configs_raise(monkeypatch):
    """VOConfig() builds (sync window BA, push apply, one device), and so
    do asynchronous window BA, `apply_mode="device"`,
    `lk_template="anchor"` and `photometric_norm=True`; a stereo camera
    raises. With two cards visible, VOConfig() builds the landmark-sharded
    backend over the mesh (two CPU shards here, by monkeypatch), and
    `ba.distributed="off"` the single-device one."""
    cam = tsynthetic.kitti_camera()
    base = make_config()
    create_frontend(VOConfig(), cam, device="cpu")
    ba = VOConfig().ba
    fe = create_frontend(VOConfig(ba=dataclasses.replace(
        ba, asynchronous=True)), cam, device="cpu")
    assert fe.cfg.ba.asynchronous
    fe = create_frontend(VOConfig(ba=dataclasses.replace(
        ba, apply_mode="device")), cam, device="cpu")
    assert fe.cfg.ba.apply_mode == "device"
    fe = create_frontend(dataclasses.replace(base, tracking=dataclasses.replace(
        base.tracking, lk_template="anchor")), cam, device="cpu")
    assert fe.cfg.tracking.lk_template == "anchor"
    fe = create_frontend(dataclasses.replace(base, features=dataclasses.replace(
        base.features, photometric_norm=True)), cam, device="cpu")
    assert fe._norm
    with pytest.raises(ValueError, match="monocular"):
        create_frontend(dataclasses.replace(base, camera_type="stereo"), cam,
                        device="cpu")
    # more than one visible card: the landmark-sharded backend
    assert create_frontend(VOConfig(), cam, device="cpu")._dist_ba is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_lib.landmark_mesh().size == 2
    monkeypatch.setattr(mesh_lib, "landmark_mesh", lambda *a, **k: (
        mesh_lib.Mesh([torch.device("cpu")] * 2, ("lm",))))
    fe = create_frontend(VOConfig(), cam, device="cpu")
    assert fe._dist_ba is not None and fe._dist_ba[1].size == 2
    fe = create_frontend(VOConfig(ba=dataclasses.replace(
        ba, distributed="off")), cam, device="cpu")
    assert fe._dist_ba is None


def test_tracking_failure_resets():
    """A blank frame fails the tracking gates and resets: relocalization
    against the map fails on it, and so does the two-view fallback, so the
    frontend waits in INIT with its pose held."""
    imgs, *_, cam = tsynthetic.render_sequence(**dict(SEQ, n_frames=3))
    fe = create_frontend(make_config(), cam, device="cpu")
    fe.run(imgs[:2])
    res = fe.process(np.full_like(imgs[2], 25))
    assert res.status == "RESET" and res.reset
    assert fe.n_resets == 1 and fe.n_relocalizations == 0
    assert fe.status is tfrontend.VOStatus.INIT
    np.testing.assert_array_equal(res.pose_wc, fe.trajectory[1])


def test_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    create_frontend(make_config(), tsynthetic.kitti_camera(), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_runs_without_jax():
    """Every module of the port (window BA, the textured renderer, offline
    refinement, the selfcheck, the bench, the CLI, the long run, its I/O,
    checkpoint and viewers, the distributed BA, its mesh and harness and
    the profiling utilities included) and chip_smoke.py imported,
    VOConfig() unmodified run for four frames and refined offline, the
    same with the sharded backend over two CPU shards, a sharded solve,
    and a textured frame rendered, in a fresh interpreter: no JAX and
    nothing of the JAX package is loaded."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import torch\n"
        "torch.set_num_threads(1)  # beside the suite's other workers\n"
        "import chip_smoke, ya_vo_tpu_torch\n"
        "import ya_vo_tpu_torch.ba.window, ya_vo_tpu_torch.ba.global_refine\n"
        "import ya_vo_tpu_torch.utils.scene, ya_vo_tpu_torch.selfcheck\n"
        "import ya_vo_tpu_torch.bench, ya_vo_tpu_torch.run_vo\n"
        "import ya_vo_tpu_torch.longrun\n"
        "import ya_vo_tpu_torch.io.kitti, ya_vo_tpu_torch.utils.checkpoint\n"
        "import ya_vo_tpu_torch.viz.render, ya_vo_tpu_torch.viz.live\n"
        "import ya_vo_tpu_torch.parallel.mesh as mesh_lib\n"
        "import ya_vo_tpu_torch.parallel.dist_ba as dist_ba\n"
        "import ya_vo_tpu_torch.parallel.scaling_bench as scaling_bench\n"
        "import ya_vo_tpu_torch.utils.profiling\n"
        "for m in pkgutil.walk_packages(ya_vo_tpu_torch.__path__,\n"
        "                               'ya_vo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ya_vo_tpu_torch import create_frontend\n"
        "from ya_vo_tpu_torch.config import VOConfig\n"
        "from ya_vo_tpu_torch.utils import synthetic\n"
        "imgs, _, _, cam = synthetic.render_sequence(n_frames=4, "
        "n_landmarks=500, height=256, width=768, step=0.4, seed=7)\n"
        "fe = create_frontend(VOConfig(), cam, device='cpu')\n"
        "assert fe.cfg.ba.enabled\n"
        "fe.run(imgs)\n"
        "assert len(fe.results) == 4\n"
        "from ya_vo_tpu_torch.ba.global_refine import global_refine\n"
        "assert global_refine(fe).shape == (4, 4, 4)\n"
        "mesh_lib.landmark_mesh = lambda *a, **k: mesh_lib.Mesh(\n"
        "    [torch.device('cpu')] * 2, ('lm',))\n"
        "fe = create_frontend(VOConfig(), cam, device='cpu')\n"
        "assert fe._dist_ba is not None\n"
        "fe.run(imgs)\n"
        "cam2, prob = scaling_bench.build_problem(L=64, W=2)\n"
        "assert dist_ba.make_dist_solver(mesh_lib.landmark_mesh(), cam2,\n"
        "                                iters=1)(prob)[1].gather().shape \\\n"
        "    == (64, 3)\n"
        "from ya_vo_tpu_torch.utils.scene import TexturedSequence\n"
        "seq = TexturedSequence(n_frames=2, height=32, width=96, "
        "tex_size=64, mip_levels=2, device='cpu')\n"
        "assert seq.frame(1).shape == (32, 96)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ya_vo_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'ya_vo_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("build", [create_frontend, tfrontend.Frontend])
def test_frontend_defaults_to_the_card(build):
    """Without `device` the frontend is built on the CUDA card; with none
    it raises rather than run on the CPU."""
    cam = tsynthetic.kitti_camera()
    if torch.cuda.is_available():
        assert build(make_config(), cam).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(make_config(), cam)
