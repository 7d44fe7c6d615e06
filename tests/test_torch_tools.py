"""The port's profiling and diagnosis tools (`ya_vo_tpu_torch.profile_step`,
`bench_lk`, `profile_bench`, `diag_primary`, `scaling_artifact`,
`devserver`) on the CPU at small sizes, against the frontend they read and
the JAX package's functions and tools.

- profile_step: on test_frontend_e2e.py's stamps frames cut to 256x768 with
  256 keypoints, the components in the tool's order, with the step's
  arguments, reproduce the fused step's own outputs exactly (keypoints,
  descriptors, flow status and positions, pose, inliers, fresh points,
  merge order), and the fused step on the tool's snapshot equals the
  frontend's own dispatch; detect, LK and match equal JAX's `fast.detect`,
  `lk_pallas.track` (interpret mode) and `matching.match` on the same
  inputs (keypoints and matches exactly, LK positions within 1e-3 px with
  the status equal, as tests/test_torch_lk.py holds it).
- bench_lk: the tool's random draws at 64x256 with 32 keypoints; the
  status at levels {1, 3} x iters {1, 5} equals `lk_pallas.track`'s. On a
  smooth texture shifted by (0.4, -0.3) px every point tracks at levels
  {1, 3} x 5 iterations: the count and status equal JAX's and the
  positions are within 1e-3 px of JAX's, at 3 levels within 0.1 px of the
  true shift.
- profile_bench: on the 10-frame 256x768 sequence with synchronous BA and
  push apply (deterministic; the tool's asynchronous applies land at
  timing-dependent frames), the wrapped loop's trajectory equals an
  unwrapped `run(pipelined=True)` bit for bit, and its phase counts
  (fresh and redone dispatches, finishes, window-BA calls, problem
  builds) equal the JAX frontend's under the same wrapping, run with the
  TPU kernel's LK semantics and its RANSAC draws handed to the port (as
  tests/test_torch_reset.py does).
- diag_primary: a 14-frame 188x620 textured world; the record has the JAX
  tool's keys, each row the tool's row keys, and the rows are the
  frontend's `FrameResult`s.
- scaling_artifact: the rows have docs/SCALING.json's keys without
  `projected_ici_ms`, with `distinct_devices`, `backend` and `card`; the
  collective bytes are JAX's `collective_bytes_per_iter`'s.
- devserver: a job's round trip through tools/run_job.sh, then the server
  exits on its idle timeout.
"""

import ast
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontend_e2e import make_config as e2e_config
from tests.test_torch_frontend import (SEQ, _inject_jax_draw,
                                       _tpu_semantics_lk)
import tests.test_torch_frontend  # noqa: F401  (one torch thread a worker)
from ya_vo_tpu.features import fast as jfast
from ya_vo_tpu.features import matching as jmatching
from ya_vo_tpu.geometry import triangulation as jtri
from ya_vo_tpu.parallel import dist_ba as jdist
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking import lk_pallas
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu_torch import (_build, bench_lk, devserver, diag_primary,
                             profile_bench, profile_step, scaling_artifact)
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.selfcheck import bits_equal
from ya_vo_tpu_torch.geometry import triangulation as ttri
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.tracking.frontend import detect_kwargs
from ya_vo_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(height=256, width=768, n_landmarks=500)
LK_UV_TOL = 1e-3


@pytest.fixture(scope="module")
def step():
    """profile_step's frontend after its 8 warm frames at 256x768, the
    snapshot, the components' values and the fused step's outputs."""
    fe, img = profile_step.setup("cpu", world=SMALL, max_keypoints=256)
    st = profile_step.snapshot(fe, img)
    return fe, st, profile_step.chain(fe, st), profile_step.fused_step(fe, st)


def test_profile_step_components_reproduce_the_fused_step(step):
    fe, st, x, (kp, desc, _, record) = step
    assert fe.status.name == "TRACKING" and int(x["flow"].status.sum()) > 20
    assert profile_step.compare(x, kp, desc, record) == []
    with fe._throwaway_chain():
        own = fe._dispatch_track(st.img)
    assert all(bits_equal(a, b) for a, b in zip(record, own["pull"][0]))
    names = [n for n, _ in profile_step.components(fe, st, x)]
    assert names == ["fused step", "fast.detect", "gaussian_blur",
                     "brief.describe", "LK (masked, projection-seeded)",
                     "pose GN", "match (incl describe)", "triangulate",
                     "reproj errors", "2x argsort", "proximity d2"]
    row = profile_step.measure(lambda: x["keep"].sum(), "cpu", reps=2)
    assert row["call_ms"] > 0 and row["device_ms"] is None


def test_profile_step_components_match_jax(step):
    """detect, LK (interpret mode) and match of the tool's component calls
    on the same inputs as JAX's."""
    fe, st, x, _ = step
    fc, tc, mc = fe.cfg.features, fe.cfg.tracking, fe.cfg.matching
    img = st.img.numpy()
    ref = jfast.detect(jnp.asarray(img), **detect_kwargs(fc))
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(x["kp"].mask.numpy(), mask)
    np.testing.assert_array_equal(x["kp"].uv.numpy()[mask],
                                  np.asarray(ref.uv)[mask])

    tmpl_img, tmpl_uv, seed, use = (t.numpy() for t in x["lk_in"])
    ref = lk_pallas.track(
        jnp.asarray(tmpl_img.astype(np.float32)),
        jnp.asarray(img.astype(np.float32)), jnp.asarray(tmpl_uv),
        jnp.asarray(seed), jnp.asarray(use),
        **tfrontend.lk_kwargs(tc))
    status = np.asarray(ref.status)
    np.testing.assert_array_equal(x["flow"].status.numpy(), status)
    assert status.sum() > 20
    np.testing.assert_allclose(x["flow"].uv.numpy()[status],
                               np.asarray(ref.uv)[status], atol=LK_UV_TOL)

    kf_desc, kf_mask = st.args[9].numpy(), st.args[11].numpy()
    ref = jmatching.match(
        jnp.asarray(kf_desc.view(np.uint32)),
        jnp.asarray(x["desc"].numpy().view(np.uint32)), jnp.asarray(kf_mask),
        jnp.asarray(x["kp"].mask.numpy()), abs_threshold=mc.abs_threshold,
        cross_check=mc.cross_check)
    m = x["match"]
    np.testing.assert_array_equal(m.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(m.idx2.numpy()[m.mask.numpy()],
                                  np.asarray(ref.idx2)[np.asarray(ref.mask)])
    assert int(m.mask.sum()) > 10


def test_reprojection_errors_match_jax():
    rng = np.random.default_rng(4)
    P = rng.normal(size=(3, 4)).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32) + [0, 0, 5]
    uv = rng.normal(size=(50, 2)).astype(np.float32)
    out = ttri.reprojection_errors(*(torch.as_tensor(a) for a in
                                     (P, pts.astype(np.float32), uv)))
    ref = jtri.reprojection_errors(jnp.asarray(P), jnp.asarray(pts,
                                                               jnp.float32),
                                   jnp.asarray(uv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bench_lk_matches_jax():
    shape = dict(height=64, width=256, n=32)
    rows = bench_lk.run("cpu", iters=(1, 5), levels=(1, 3), reps=1, **shape)
    arrays = bench_lk.inputs(**shape)
    assert [(r["levels"], r["iters"]) for r in rows] == [(1, 1), (1, 5),
                                                         (3, 1), (3, 5)]
    for r in rows:
        assert r["call_ms"] > 0 and r["kernel_device_ms"] is None
        ref = lk_pallas.track(*(jnp.asarray(a) for a in arrays),
                              levels=r["levels"], iters=r["iters"])
        out = bench_lk.lk_cuda.track(*(torch.as_tensor(a) for a in arrays),
                                     levels=r["levels"], iters=r["iters"])
        np.testing.assert_array_equal(out.status.numpy(),
                                      np.asarray(ref.status))
        assert r["tracked"] == int(np.asarray(ref.status).sum())

    # on the tool's random images nothing converges; on a smooth texture
    # moved by a sub-pixel shift every point tracks from its own position:
    # the tool's count and the positions equal JAX's (LK_UV_TOL), and at 3
    # levels they land within 0.1 px of the true shift
    h, w = shape["height"], shape["width"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    shift = np.array([0.4, -0.3])

    def texture(x, y):
        return (128 + 40 * np.sin(0.31 * x + 0.12 * y)
                + 30 * np.cos(0.17 * y - 0.23 * x)
                + 20 * np.sin(0.41 * x + 0.37 * y)).astype(np.float32)

    uv0, mask = arrays[2], arrays[4]
    arrays = (texture(xx, yy), texture(xx - shift[0], yy - shift[1]), uv0,
              uv0.copy(), mask)
    args = tuple(torch.as_tensor(a) for a in arrays)
    for levels in (1, 3):
        r = bench_lk.measure(args, levels, 5, reps=1)
        ref = lk_pallas.track(*(jnp.asarray(a) for a in arrays),
                              levels=levels, iters=5)
        out = bench_lk.lk_cuda.track(*args, levels=levels, iters=5)
        status = np.asarray(ref.status)
        assert r["tracked"] == int(status.sum()) > 0
        np.testing.assert_array_equal(out.status.numpy(), status)
        np.testing.assert_allclose(out.uv.numpy()[status],
                                   np.asarray(ref.uv)[status], atol=LK_UV_TOL)
    np.testing.assert_allclose(out.uv.numpy()[status], uv0[status] + shift,
                               atol=0.1)


@pytest.fixture(scope="module")
def e2e():
    imgs, _, _, cam = jsynthetic.render_sequence(**SEQ)
    cfg = e2e_config(sync_ba=True, apply_mode="push")
    import dataclasses
    return imgs, cam, dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, distributed="off"))


WARM = 2     # INIT and the two-view bootstrap through `process`


def _port(cfg, cam):
    return tfrontend.Frontend(cfg, convert.camera_from_numpy(cam),
                              device="cpu")


def test_profile_bench_trajectory_equals_run(e2e):
    imgs, cam, cfg = e2e
    fe = _port(cfg, cam)
    res = profile_bench.profile(fe, imgs, warm=WARM)
    ref = _port(cfg, cam)
    for img in imgs[:WARM]:
        ref.process(img)
    ref.run(imgs[WARM:], pipelined=True)
    np.testing.assert_array_equal(np.stack(fe.trajectory),
                                  np.stack(ref.trajectory))
    assert len(res["times"]) == len(imgs) - WARM
    assert len(res["phase"]["redo"]) == fe.n_redone == ref.n_redone > 0
    assert len(res["phase"]["dispatch"]) == len(imgs) - WARM
    lines = profile_bench.summary(fe, res)
    assert lines[0].startswith(f"frames={len(imgs) - WARM} ")
    assert any(line.startswith("redo: n=") for line in lines)


def test_profile_bench_phase_counts_match_jax(e2e, monkeypatch):
    imgs, cam, cfg = e2e
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        jfe = JFrontend(cfg, cam)
        for img in imgs[:WARM]:
            jfe.process(img)
        jphase = profile_bench.wrap_phases(jfe)
        jfe.run(imgs[WARM:], pipelined=True)
    _inject_jax_draw(monkeypatch, cfg.ransac.seed)
    fe = _port(cfg, cam)
    phase = profile_bench.profile(fe, imgs, warm=WARM)["phase"]
    counts = {k: len(v) for k, v in phase.items()}
    assert counts == {k: len(v) for k, v in jphase.items()}
    assert counts["ba"] >= 1 and counts["buildprob"] >= 1


def _tool_dict_keys(path):
    """The keyword names of each `dict(...)` call in a tool's source."""
    tree = ast.parse(open(path).read())
    return [[k.arg for k in node.keywords] for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "dict"]


def test_diag_primary_record_has_the_tools_keys(tmp_path):
    out = str(tmp_path / "diag.json")
    record, fe, launches = diag_primary.main(
        ["--frames", "14", "--device", "cpu", "--out", out, "--sync",
         "--refine-sweep"],
        height=188, width=620, tex_size=512,
        cam=Camera.create(359.428, 359.428, 303.5964, 92.60785))
    row_keys, record_keys = _tool_dict_keys(
        os.path.join(REPO, "tools", "diag_primary.py"))
    assert list(record) == record_keys
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(record))
    with np.load(out + ".npz") as z:
        assert z["est"].shape == z["gt_cw"].shape == (14, 4, 4)
    assert len(record["rows"]) == len(fe.results) == 14
    for row, res in zip(record["rows"], fe.results):
        assert list(row) == row_keys
        assert (row["f"], row["st"], row["kp"], row["flow"], row["ba"],
                row["new"], row["kf"], row["reset"]) == (
            res.frame_id, res.status, res.n_keypoints, res.n_flow_inliers,
            res.n_ba_inliers, res.n_new_landmarks, res.is_keyframe,
            res.reset)
    assert record["rows"][-1]["nba"] == fe.n_ba_runs
    assert record["resets"] == fe.n_resets
    # the pipelined run's launches alone: none on the CPU, where every
    # wrapper takes its plain version
    assert set(launches) == set(_build.LAUNCHES)
    assert not any(launches.values())


def test_scaling_artifact_rows():
    L, W = 512, 4
    rec = scaling_artifact.record("cpu", L=L, W=W, iters=2, repeats=1)
    with open(os.path.join(REPO, "docs", "SCALING.json")) as f:
        ref = json.load(f)
    assert set(rec) == set(ref) | {"multi_host_2proc_2d"}
    added = {"distinct_devices", "backend", "card"}
    single_keys = set(ref["single_host"][0]) - {"projected_ici_ms"} | added
    assert len(rec["single_host"]) == 7
    for row in rec["single_host"]:
        assert set(row) == single_keys
        assert row["backend"] is None and row["card"] == "cpu"
        assert row["distinct_devices"] is (row["devices"] == 1)
    multi_keys = set(ref["multi_host_2proc"]) | added
    for key, mesh in (("multi_host_2proc", (1, 4)),
                      ("multi_host_2proc_2d", (2, 2))):
        row = rec[key]
        assert set(row) == multi_keys, key
        assert row["backend"] == "gloo" and row["processes"] == 2
        assert row["distinct_devices"] is False
        assert row["cost_decrease"] > 1
        assert row["collective_mb_per_iter"] == round(
            jdist.collective_bytes_per_iter(W, L, *mesh)["ring_bytes"]
            / 2**20, 3)
    for row in rec["single_host"]:
        n_kf, n_lm = (int(n) for n in row["mesh"].split("x"))
        assert row["collective_mb_per_iter"] == round(
            jdist.collective_bytes_per_iter(W, L, n_kf, n_lm)["ring_bytes"]
            / 2**20, 3)


def test_devserver_round_trip(tmp_path):
    jobdir = str(tmp_path / "jobs")
    server = subprocess.Popen(
        [sys.executable, "-m", "ya_vo_tpu_torch.devserver", jobdir,
         "--idle-timeout", "3", "--device", "cpu"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.time()
        while not os.path.exists(os.path.join(jobdir, "_ready")):
            assert server.poll() is None and time.time() - t0 < 60
            time.sleep(0.1)
        job = tmp_path / "job.py"
        job.write_text("import ya_vo_tpu_torch.profile_step as ps\n"
                       "print('two', 1 + 1, ps.WARM)\n")
        out = subprocess.run(["bash", os.path.join(REPO, "tools",
                                                   "run_job.sh"),
                              str(job), "60", jobdir],
                             capture_output=True, text=True, timeout=90)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "two 2 8" in out.stdout
        assert "[devserver] exit=0" in out.stdout
        log = server.communicate(timeout=60)[0]
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert server.returncode == 0, log
    assert "exiting (frees the card)" in log
    assert not os.path.exists(os.path.join(jobdir, "_devserver.pid"))


@pytest.mark.parametrize("call", [
    lambda: profile_step.main([]), lambda: profile_bench.main([]),
    lambda: bench_lk.main([]), lambda: diag_primary.main([]),
    lambda: scaling_artifact.main([]),
    lambda: devserver.main(["--idle-timeout", "1"])],
    ids=["profile_step", "profile_bench", "bench_lk", "diag_primary",
         "scaling_artifact", "devserver"])
def test_tools_run_on_the_card_by_default(call):
    """Without --device cpu each tool runs on the card, and without one it
    raises (at once, before any work)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tools would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
