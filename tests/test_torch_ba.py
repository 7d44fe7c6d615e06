"""The port's window BA (`ya_vo_tpu_torch/ba/window.py`) and the frontend's
BA apply gate against the JAX package on the CPU.

`solve_window` runs with the frontend's settings (two pinned poses, the
trust-region prior) on tests/test_ba.py's synthetic window problems and on
the window problems the JAX frontend itself builds on
test_frontend_e2e.py's 256x768 sequence with BA on (captured by wrapping
`ya_vo_tpu.ba.window.solve_window`). The JAX iteration count is read from
the while-loop's counter through a host callback.

Held (`selfcheck.hold_window_solution`, which K5's tests on the card
share): equal iteration counts; cost_initial within rtol 1e-4; cost_final no
worse than the JAX solve's by more than rtol 1e-4; every valid
observation's reprojection within 5e-2 px of the JAX solution's; poses
within atol 1e-4 and landmarks within atol 1e-3 of the JAX ones, unless
the JAX float32 solve is itself farther than that from the float64 solve
(the port's solver run in float64 for the same iterations): then within
twice that distance. Monocular windows leave landmarks weakly constrained
along their rays (the median Hll condition number is ~3e4 on the frontend
windows), so float32 rounding moves both solves there by more than 1e-3;
the two float32 solves differ from the float64 one by the same amount.
Measured maxima: frontend windows poses 3.7e-5 and 6.0e-5, landmarks
0.120 and 0.062 (JAX's own distance to float64: 0.109 and 0.128),
reprojection 0.0047 px, cost_final 9.9e-5 relative; synthetic windows
poses 2.4e-5 and 1.7e-4 (JAX to float64: 7.9e-5 and 9.0e-5),
reprojection 0.028 px.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tests.test_ba import make_problem
from tests.test_torch_frontend import SEQ, _tpu_semantics_lk
from tests.test_torch_reset import make_config
from ya_vo_tpu.ba import window as jwindow
from ya_vo_tpu.config import BAConfig
from ya_vo_tpu.config import VOConfig as JVOConfig
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend as JFrontend
from ya_vo_tpu.utils import synthetic as jsynthetic
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.ba import window as twindow
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import convert
from ya_vo_tpu_torch.utils import synthetic as tsynthetic

LIVE = dict(iters=8, huber_delta=2.4477, damping=1e-4, n_fixed_poses=2,
            rel_tol=1e-3, pose_prior_weight=100.0)   # the frontend's solve


def to_port(prob, dtype=torch.float32) -> twindow.BAProblem:
    arrays = [torch.as_tensor(np.array(x)) for x in prob]
    arrays[5] = arrays[5].to(torch.int64)            # obs_lm
    return twindow.BAProblem(*(a.to(dtype) if a.is_floating_point() else a
                               for a in arrays))


def jax_solve(prob, cam, **kw):
    """`window._solve_window` jitted as `solve_window` jits it, with the
    while-loop's final iteration counter sent to the host. Returns
    (BAResult, iterations)."""
    kw = dict(dict(iters=8, huber_delta=2.4477, damping=1e-4,
                   n_fixed_poses=1, rel_tol=1e-3, pose_prior_weight=0.0),
              **kw)
    counts = []
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        jax.debug.callback(lambda n: counts.append(int(n)), out[2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", while_loop)
        fn = jax.jit(functools.partial(jwindow._solve_window, cam=cam, **kw))
        with jax.default_matmul_precision("float32"):
            res = jax.block_until_ready(fn(prob))
    return res, counts[-1]


def jax_reference(jprob, jcam, **kw) -> dict:
    """JAX's solve of `jprob` as a reference for
    `selfcheck.hold_window_solution`: its outputs (numpy), its while-loop's
    iterations, and the distances of its poses and landmarks to the port's
    float64 solve for as many iterations."""
    res, n_ref = jax_solve(jprob, jcam, **kw)
    exact = twindow.solve_window(to_port(jprob, torch.float64),
                                 convert.camera_from_numpy(jcam),
                                 **dict(kw, iters=n_ref, rel_tol=-1.0))
    ref = {k: np.asarray(getattr(res, k)) for k in sc.WINDOW_OUTPUTS[:-1]}
    ref["n_iters"] = n_ref
    for k in ("poses", "landmarks"):
        ref[f"{k}_to_f64"] = float(np.abs(
            ref[k] - getattr(exact, k).numpy()).max())
    return ref


def compare(jprob, jcam, **kw) -> dict:
    """Solve on both sides (and the port in float64 for JAX's number of
    iterations), assert the module docstring's tolerances
    (`selfcheck.hold_window_solution`), and return the differences."""
    ref = jax_reference(jprob, jcam, **kw)
    cam = convert.camera_from_numpy(jcam)
    prob = to_port(jprob)
    out = twindow.solve_window(prob, cam, **kw)
    return sc.hold_window_solution(prob, cam, kw, out, ref)


@pytest.mark.parametrize("case", [dict(), dict(noise=0.5, seed=1)])
def test_solve_window_matches_jax_synthetic(case):
    prob, cam, *_ = make_problem(**case)
    compare(prob, cam, **LIVE)


@pytest.fixture(scope="module")
def frontend_problems():
    """The window problems the JAX frontend builds over 16 frames of the
    256x768 sequence with BA on (sync, push, single-device solver)."""
    cfg = make_config()
    imgs, _, _, cam = jsynthetic.render_sequence(**dict(SEQ, n_frames=16))
    probs = []
    orig = jwindow.solve_window

    def capture(prob, cam, **kw):
        probs.append((prob, kw))
        return orig(prob, cam, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "auto_track", _tpu_semantics_lk([]))
        mp.setattr(jwindow, "solve_window", capture)
        JFrontend(cfg, cam).run(imgs, pipelined=False)
    assert len(probs) >= 2
    return probs, cam


@pytest.mark.parametrize("index", [0, 1])
def test_solve_window_matches_jax_on_frontend_windows(frontend_problems,
                                                      index):
    """4096 landmark slots, 8 keyframes of 1024 observations, the live
    trust-region prior and two pinned poses; poses within 1e-4 outright."""
    probs, cam = frontend_problems
    prob, kw = probs[index]
    assert kw == dict(iters=8, huber_delta=2.4477, damping=1e-4,
                      n_fixed_poses=2, pose_prior_weight=100.0)
    assert np.asarray(prob.obs_valid).sum() > 1000
    d = compare(prob, cam, **kw)
    assert d["poses"] <= sc.WINDOW_POSE_ATOL, d


def test_solve_window_is_deterministic():
    prob, cam, *_ = make_problem(noise=0.5, seed=1)
    p, c = to_port(prob), convert.camera_from_numpy(cam)
    a = twindow.solve_window(p, c, **LIVE)
    b = twindow.solve_window(p, c, **LIVE)
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.landmarks, b.landmarks)


@pytest.mark.parametrize("seed,cap", [(0, 100), (1, 300), (2, 10_000)])
def test_select_window_landmarks_exact(seed, cap):
    """Random windows with repeated ids, dead landmarks and a cap below
    the number of window landmarks (but for the last case)."""
    rng = np.random.default_rng(seed)
    lm_p = rng.integers(-1, 800, (8, 256)).astype(np.int32)
    ok_p = rng.random((8, 256)) < 0.8
    alive = rng.random(1000) < 0.9
    ref = jwindow.select_window_landmarks(lm_p, ok_p, alive, cap)
    out = twindow.select_window_landmarks(lm_p, ok_p, alive, cap)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[0].dtype == ref[0].dtype
    assert out[1:] == ref[1:]
    assert (out[1] > 0) == (cap < 1000)


def test_segments_layout():
    """Each landmark's observations, in flat order, padded with W*O."""
    obs_lm = torch.tensor([[0, 2, -1], [2, 0, 0]])
    seg = twindow.segments(obs_lm, 4)
    assert seg.idx.tolist() == [[0, 4, 5], [6, 6, 6], [1, 3, 6], [6, 6, 6]]
    assert seg.kf.tolist() == [[0, 1, 1], [2, 2, 2], [0, 1, 2], [2, 2, 2]]


def _reduced(prob, cam):
    """JAX and port (S, b_red, Hll_inv, bl, Wpl), both gauge-fixed."""
    L = prob.landmarks.shape[0]
    with jax.default_matmul_precision("float32"):
        r, Jp, Jl, w, _, _ = jwindow._obs_terms(
            prob.poses, prob.landmarks, prob, cam, 2.4477)
        ref = jwindow._reduced_system(r, Jp, Jl, w, prob.obs_lm, L, 1e-4)
        S, b = jwindow._gauge_fix(ref[0], ref[1], n_fixed=2)
    tp, tc = to_port(prob), convert.camera_from_numpy(cam)
    seg = twindow.segments(tp.obs_lm, L)
    r, Jp, Jl, w, _, _ = twindow._obs_terms(tp.poses, tp.landmarks, tp, tc,
                                            2.4477, seg)
    out = twindow._reduced_system(r, Jp, Jl, w, seg, 1e-4)
    S2, b2 = twindow._gauge_fix(out[0], out[1], n_fixed=2)
    return (S, b) + tuple(ref[2:]), (S2, b2) + tuple(out[2:])


@pytest.mark.parametrize("name,i", [("S", 0), ("b_red", 1), ("Hll_inv", 2),
                                    ("bl", 3), ("Wpl", 4)])
def test_reduced_system_and_gauge_fix_match_jax(name, i):
    """rtol 1e-4 against each output's own scale (atol = 1e-4 x its
    largest entry: S and b_red are differences of large sums). Hll_inv
    block by block: an ill-conditioned 3x3 inverse carries float32
    rounding times its condition number on both sides (measured: at most
    4.1e-8 x the condition number, 1.0e-3 relative)."""
    prob, cam, *_ = make_problem(noise=0.5, seed=1)
    ref, out = _reduced(prob, cam)
    a, b = out[i].numpy(), np.asarray(ref[i])
    assert a.shape == b.shape
    if name == "Hll_inv":
        # per 3x3 block, relative to the block: the inverse's perturbation
        # bound, condition number x float32 rounding (2 x 2^-24), or 1e-4
        cond = np.linalg.cond(b.astype(np.float64))
        rel = np.abs(a - b).max((1, 2)) / np.abs(b).max((1, 2))
        assert (rel <= np.maximum(1e-4, 2 * 2.0 ** -24 * cond)).all()
        return
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


# ---- the divergence gate of the sync apply (tests/test_ba_gates.py) ----

def _gate_frontends():
    """A JAX and a port frontend holding the same tiny 3-keyframe map
    (32 landmarks observed) and live table (40 landmarks)."""
    jfe = JFrontend(JVOConfig(ba=BAConfig(asynchronous=False,
                                          distributed="off")),
                    jsynthetic.kitti_camera())
    fe = Frontend(VOConfig(), tsynthetic.kitti_camera(), device="cpu")
    lms = jsynthetic.random_landmarks(40, seed=0)
    poses = jsynthetic.forward_trajectory(3, step=0.5)
    for f in (jfe, fe):
        ids = f.map.add_landmarks(lms, np.ones(40, bool))
        O = f.map.max_obs_per_kf
        for w in range(3):
            uv = np.zeros((O, 2), np.float32)
            lm = np.full(O, -1, np.int32)
            ok = np.zeros(O, bool)
            lm[:32] = ids[:32]
            ok[:32] = True
            f.map.insert_keyframe(w, poses[w], uv, lm, ok)
        f.last_pose = poses[-1].copy()
        # 8 live-table landmarks outside the window: moved rigidly
        f.track_lm[:40] = ids
        f.track_valid[:40] = True
    return jfe, fe


@pytest.mark.parametrize("steps,corr_steps,applies", [
    (0, 0.0, True),           # a fresh result applies
    (10, 0.25, True),         # stationary now, median step 0.5: applies
    (10, 10.0, False),        # a teleport is discarded
])
def test_divergence_gate_matches_jax(steps, corr_steps, applies):
    """The port's sync `_apply_ba_result` against the JAX one on the same
    state: the same decision, and bit-equal map, live pose and keyframe
    pose after it."""
    jfe, fe = _gate_frontends()
    corr_t = corr_steps * fe.cfg.ba.max_correction_steps
    for f in (jfe, fe):
        f.rel_motion = np.eye(4, dtype=np.float32)
        f._recent_steps.extend([0.5] * steps)
    slots, used = np.array([0, 1, 2]), np.arange(32)
    new_poses = fe.map.kf_pose[:3].copy()
    new_poses[2][:3, 3] += [corr_t, 0, 0]
    new_lms = fe.map.landmark_pos[used] + 0.01
    anchor_old = fe.map.kf_pose[2].copy()
    jfe._apply_ba_result(new_poses.copy(), new_lms.copy(), slots, used, 3,
                         anchor_old.copy(), 1.0)
    fe._apply_ba_result(new_poses.copy(), new_lms.copy(), slots, used, 3,
                        anchor_old.copy(), 1.0)
    assert fe.n_ba_runs == jfe.n_ba_runs == int(applies)
    assert fe.n_ba_discarded == jfe.n_ba_discarded == int(not applies)
    assert fe._state_dirty == jfe._state_dirty == applies
    np.testing.assert_array_equal(fe.map.landmark_pos, jfe.map.landmark_pos)
    np.testing.assert_array_equal(fe.map.kf_pose, jfe.map.kf_pose)
    np.testing.assert_array_equal(fe.last_pose, jfe.last_pose)
    np.testing.assert_array_equal(fe._kf_pose, jfe._kf_pose)
