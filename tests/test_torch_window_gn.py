"""K5 (`ya_vo_tpu_torch/csrc/window_gn.cu`, the window BA's GN loop) on
the CPU: its goldens against JAX, the plain version held to them, the
outputs K5 recorded on the card (k5_bits.npz) held to JAX's goldens and
to the plain version, its CSR layout, and `solve_window`'s dispatch.

The goldens (tests/torch_data/window_gn/<case>.npz) hold a window problem,
the solve's settings, JAX's solve of it (`ya_vo_tpu.ba.window._solve_window`
jitted as `solve_window` jits it, tests/test_torch_ba.py's `jax_solve`),
the iterations JAX's while-loop ran (its counter read through a host
callback) and the distances of JAX's poses and landmarks to a float64
solve (the port's plain version in float64 for JAX's iterations). The
cases (`selfcheck.WINDOW_CASES`), all at the live backend's settings (two
pinned poses, the trust-region prior, 8 iterations at most):
  synthetic, synthetic_noisy  tests/test_ba.py's `make_problem()` and
                              `make_problem(noise=0.5, seed=1)`;
  frontend0, frontend1        the JAX frontend's first two windows on
                              test_frontend_e2e.py's 256x768 sequence
                              (tests/test_torch_ba.py's fixture);
  full_width                  a seeded problem at the main path's width
                              (`full_width_problem`: W 8, O 2048, L 4096),
                              with a landmark seen twice in one keyframe's
                              row and invalid slots that carry landmark ids.
Record them with `JAX_PLATFORMS=cpu python -m tests.test_torch_window_gn`
from the repository root (~2 min on a CPU). The tolerances are
`selfcheck.hold_window_solution`'s (tests/test_torch_ba.py's `compare`);
tests/test_torch_window_gn_card.py holds K5 to the same goldens on the
card.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import make_problem
from tests.test_torch_ba import LIVE, jax_reference, jax_solve
from ya_vo_tpu.ba import window as jwindow
from ya_vo_tpu.core.camera import Camera as JCamera
from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.ba import window as twindow
from ya_vo_tpu_torch.ba import window_cuda
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.utils import synthetic

DEFAULTS = dict(iters=8, huber_delta=2.4477, damping=1e-4, n_fixed_poses=1,
                rel_tol=1e-3, pose_prior_weight=0.0)


def full_width_problem(seed: int = 0, W: int = 8, O: int = 2048,
                       L: int = 4096, n_landmarks: int = 3000,
                       outliers: float = 0.02, pose_pert: float = 0.005,
                       lm_pert: float = 0.1):
    """A window at the main path's width (numpy arrays in BAProblem's
    order, obs_lm int32, and the camera): 3000 of the 4096 landmark slots
    used (20 of them dead: lm_valid false, still observed), seen from a
    forward trajectory with 0.5 px of noise and 2% outliers of 5-30 px; in
    every keyframe's row, in shuffled slots, 40 landmarks observed a second
    time (1 px apart) and 60 invalid slots that carry landmark ids; the
    poses after the two pinned ones perturbed by se(3) noise of sigma
    `pose_pert` (0.005: about 4 px at these intrinsics, a tracker's
    error), the landmarks by `lm_pert`. At a pose_pert of 0.02 a far
    landmark's depth is decided by float32 rounding (two minima of nearly
    equal cost: JAX's solve lands 5.1 from the float64 one, 0.71 px in
    reprojection), which no float32 solve can be held to."""
    rng = np.random.default_rng(seed)
    cam = synthetic.kitti_camera()
    lms = synthetic.random_landmarks(n_landmarks, seed=seed)
    poses = synthetic.forward_trajectory(W, step=0.5)
    uv, vis = synthetic.project_tracks(lms, poses, cam, 376, 1241, margin=5)
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out = rng.random(uv.shape[:2]) < outliers
    uv[out] += (rng.uniform(5, 30, uv[out].shape)
                * rng.choice([-1, 1], uv[out].shape)).astype(np.float32)
    obs_uv = np.zeros((W, O, 2), np.float32)
    obs_lm = np.full((W, O), -1, np.int32)
    obs_valid = np.zeros((W, O), bool)
    for w in range(W):
        ids = rng.permutation(np.nonzero(vis[w])[0])[:O - 100]
        dup = rng.choice(ids, 40, replace=False)
        bad = rng.integers(0, n_landmarks, 60)
        lm = np.concatenate([ids, dup, bad])
        row_uv = np.concatenate([
            uv[w, ids], uv[w, dup] + rng.normal(0, 1.0, (40, 2)),
            rng.uniform(0, 1000, (60, 2))]).astype(np.float32)
        ok = np.concatenate([np.ones(len(ids) + 40, bool),
                             np.zeros(60, bool)])
        slots = rng.permutation(O)[:len(lm)]
        obs_lm[w, slots], obs_uv[w, slots], obs_valid[w, slots] = \
            lm, row_uv, ok
    xi = rng.normal(0, pose_pert, (W, 6)).astype(np.float32)
    xi[:2] = 0.0
    poses_pert = (lie.se3_exp(torch.as_tensor(xi))
                  @ torch.as_tensor(poses)).numpy()
    landmarks = np.zeros((L, 3), np.float32)
    landmarks[:n_landmarks] = lms + rng.normal(
        0, lm_pert, lms.shape).astype(np.float32)
    lm_valid = np.zeros(L, bool)
    lm_valid[:n_landmarks] = True
    lm_valid[rng.choice(n_landmarks, 20, replace=False)] = False
    arrays = (poses_pert, np.ones(W, bool), landmarks, lm_valid, obs_uv,
              obs_lm, obs_valid)
    return arrays, cam


def _jax_problem(arrays):
    return jwindow.BAProblem(*(jnp.asarray(a) for a in arrays))


def _case_inputs(name: str):
    """(numpy arrays in BAProblem's order, (fx, fy, cx, cy), kw) of a
    case, made anew (JAX's frontend for the frontend windows)."""
    if name in ("synthetic", "synthetic_noisy"):
        prob, cam, *_ = make_problem(**({} if name == "synthetic"
                                        else dict(noise=0.5, seed=1)))
        return [np.array(a) for a in prob], tuple(cam), dict(LIVE)
    if name == "full_width":
        arrays, cam = full_width_problem()
        return list(arrays), tuple(cam), dict(LIVE)
    from tests.test_torch_ba import frontend_problems
    probs, cam = frontend_problems.__wrapped__()
    prob, kw = probs[int(name[-1])]
    return [np.array(a) for a in prob], tuple(cam), dict(DEFAULTS, **kw)


def record(name: str, data: Path = sc.WINDOW_DATA) -> dict:
    """Solve a case with JAX and the float64 plain version and write its
    golden; returns what was written besides the inputs."""
    arrays, cam, kw = _case_inputs(name)
    ref = jax_reference(_jax_problem(arrays), JCamera.create(*cam), **kw)
    out = {("" if k.endswith("_f64") else "ref_") + k: np.asarray(v)
           for k, v in ref.items()}
    data.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        data / f"{name}.npz",
        **dict(zip(twindow.BAProblem._fields, arrays)),
        cam=np.asarray([float(np.float32(c)) for c in cam], np.float64),
        kw=np.asarray(json.dumps(kw)), **out)
    return {k: v for k, v in out.items() if v.ndim == 0}


def _jax_case(name):
    """A golden's problem for JAX, its camera and keywords, and the
    recorded solve."""
    prob, cam, kw, ref = sc.load_window_case(name, "cpu")
    arrays = [t.numpy() for t in prob]
    arrays[5] = arrays[5].astype(np.int32)
    return _jax_problem(arrays), JCamera.create(*cam), kw, ref


@pytest.mark.parametrize("name", sc.WINDOW_CASES)
def test_golden_is_jax_solve(name):
    """JAX's solve of each golden's problem, made anew, agrees with the
    recorded one: equal iterations, and within the tolerances the port is
    held to."""
    jprob, jcam, kw, ref = _jax_case(name)
    res, n = jax_solve(jprob, jcam, **kw)
    assert n == int(ref["n_iters"])
    out = twindow.BAResult(*(torch.as_tensor(np.array(getattr(res, k)))
                             for k in sc.WINDOW_OUTPUTS[:-1]), n_iters=n)
    prob, cam, *_ = sc.load_window_case(name, "cpu")
    sc.hold_window_solution(prob, cam, kw, out, ref,
                            strict_poses=name in sc.WINDOW_STRICT_POSES)


@pytest.mark.parametrize("name", sc.WINDOW_CASES)
def test_plain_version_matches_golden(name):
    """`solve_window_plain` on the CPU against JAX's recorded solve: equal
    iterations and observations, and compare's tolerances."""
    prob, cam, kw, ref = sc.load_window_case(name, "cpu")
    out = twindow.solve_window_plain(prob, cam, **kw)
    d = sc.hold_window_solution(prob, cam, kw, out, ref,
                                strict_poses=name in sc.WINDOW_STRICT_POSES)
    print(f"window_gn golden {name}: {json.dumps(d)}")


def hold_recorded_solve(prob, cam, kw: dict, out) -> dict:
    """A recorded K5 output `out` of a window without a JAX golden against
    the CPU plain version's solve: equal iterations and observations,
    cost_initial within WINDOW_COST_RTOL, poses within `hold_window_
    solution`'s pose tolerance of the plain solve; the recorded cost_final
    within WINDOW_COST_RTOL of the float64 cost of the recorded state (one
    consistent state), and that cost no worse than the float64 GN solve's
    for as many iterations by more than WINDOW_COST_RTOL. Landmarks are
    not held position by position: at pose noise 0.02 both float32
    solves scatter along weakly constrained rays, and on some of these
    windows the two land farther apart than twice the plain version's own
    distance to float64 (the plain version's distance itself changes with
    the CPU's thread count)."""
    ref = sc.plain_reference(prob, cam, **kw)
    p64 = sc._as_float64(prob)
    exact = twindow.solve_window_plain(
        p64, cam, **dict(kw, iters=ref["n_iters"], rel_tol=-1.0))
    seg = twindow.segments(prob.obs_lm, prob.landmarks.shape[0])
    c64 = float(twindow._obs_terms(out.poses.double(),
                                   out.landmarks.double(), p64, cam,
                                   kw["huber_delta"], seg)[4])
    rtol = sc.WINDOW_COST_RTOL
    d = dict(n_iters=out.n_iters, ref_n_iters=int(ref["n_iters"]),
             poses=float((out.poses.double() - ref["poses"].double())
                         .abs().max()),
             poses_tol=max(sc.WINDOW_POSE_ATOL, 2 * ref["poses_to_f64"]),
             cost_final=float(out.cost_final), cost_final_f64=c64,
             exact_cost_final=float(exact.cost_final))
    assert d["n_iters"] == d["ref_n_iters"]
    assert int(out.n_obs) == int(ref["n_obs"])
    r0 = float(ref["cost_initial"])
    assert abs(float(out.cost_initial) - r0) <= rtol * abs(r0)
    assert d["poses"] <= d["poses_tol"]
    assert abs(d["cost_final"] - c64) <= rtol * c64
    assert c64 <= d["exact_cost_final"] * (1 + rtol)
    return d


@pytest.mark.parametrize("key", sc.window_bits_keys())
def test_recorded_k5_bits_are_sound(key):
    """Each output the first K5 recorded in k5_bits.npz (`port_window_gn.py
    record`, on the card): on the five goldens against JAX's recorded solve
    at `hold_window_solution`'s tolerances, elsewhere against the plain
    version's solve on the CPU (`hold_recorded_solve`); the iterations
    equal in both. The inputs made here are the recorded ones (their
    digest)."""
    with np.load(sc.WINDOW_BITS) as z:
        out = sc.window_result_from_bits(z, key)
        prob, cam, kw = sc.window_bits_case(key, "cpu", z)
        assert sc.window_inputs_digest(prob, cam, kw) == str(
            z[f"{key}:digest"])
    if key in sc.WINDOW_CASES:
        d = sc.hold_window_solution(
            prob, cam, kw, out, sc.load_window_case(key, "cpu")[3],
            strict_poses=key in sc.WINDOW_STRICT_POSES)
    else:
        d = hold_recorded_solve(prob, cam, kw, out)
    print(f"k5 bits {key}: {json.dumps(d)}")


@pytest.mark.parametrize("name", sc.WINDOW_CASES)
def test_csr_matches_segments(name):
    """Each landmark's run of the CSR layout is its row of `segments`:
    the same flat observation indices in the same (ascending) order."""
    prob, *_ = sc.load_window_case(name, "cpu")
    L = prob.landmarks.shape[0]
    N = prob.obs_lm.numel()
    lay = twindow.csr(prob.obs_lm, L)
    seg = twindow.segments(prob.obs_lm, L)
    off = lay.offsets.tolist()
    assert off[0] == 0 and off[-1] == int((prob.obs_lm >= 0).sum())
    assert lay.order.shape == (N,) and lay.offsets.shape == (L + 1,)
    for l in range(L):
        row = seg.idx[l]
        assert lay.order[off[l]:off[l + 1]].tolist() == row[row < N].tolist()
    if name == "full_width":
        # a landmark seen twice in one keyframe, and ids on invalid slots
        kf = lay.order // prob.obs_lm.shape[1]
        run = torch.repeat_interleave(torch.arange(L),
                                      lay.offsets.diff())
        assert bool(((kf[1:off[-1]] == kf[:off[-1] - 1])
                     & (run[1:] == run[:-1])).any())
        assert bool((~prob.obs_valid & (prob.obs_lm >= 0)).any())


def test_csr_layout():
    """Landmark 0 twice in keyframe 1, an id on an invalid slot (the layout
    ignores validity), an empty landmark and empty slots."""
    obs_lm = torch.tensor([[0, 2, -1], [2, 0, 0]])
    lay = twindow.csr(obs_lm, 4)
    assert lay.order.tolist()[:5] == [0, 4, 5, 1, 3]
    assert lay.offsets.tolist() == [0, 3, 3, 5, 5]


def test_solve_window_on_the_cpu_takes_the_plain_version(monkeypatch):
    """A CPU problem never reaches K5's wrapper and launches nothing; the
    result is the plain version's, bit for bit."""
    def refuse(*args, **kw):
        raise AssertionError("window_cuda.solve called for a CPU problem")

    monkeypatch.setattr(window_cuda, "solve", refuse)
    prob, cam, kw, _ = sc.load_window_case("synthetic_noisy", "cpu")
    _build.reset_launches()
    a = twindow.solve_window(prob, cam, **kw)
    b = twindow.solve_window_plain(prob, cam, **kw)
    assert _build.LAUNCHES["window_gn"] == 0
    for x, y in zip(a[:5], b[:5]):
        assert sc.bits_equal(x, y)
    assert a.n_iters == b.n_iters


def test_window_cuda_raises_on_cpu_tensors():
    prob, cam, kw, _ = sc.load_window_case("synthetic", "cpu")
    lay = twindow.csr(prob.obs_lm, prob.landmarks.shape[0])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        window_cuda.solve(prob, cam, lay, **kw)


def test_window_gn_work_counts():
    """The bound's counts on the full-width golden: the observations with
    a landmark (the duplicates and the invalid slots among them), those
    valid at the input (the plain solve's n_obs), and the bytes of the
    inputs and outputs."""
    prob, cam, kw, ref = sc.load_window_case("full_width", "cpu")
    work = sc.window_gn_work(prob, cam, int(ref["n_iters"]),
                             kw["huber_delta"])
    assert work["observations"] == int((prob.obs_lm >= 0).sum())
    assert work["valid_observations"] == int(ref["n_obs"])
    assert 2 <= work["mean_keyframes_a_landmark"] <= 8
    assert work["n_bytes"] == 8 * 65 + 4096 * 13 + 8 * 2048 * 17 \
        + 8 * 64 + 4096 * 12 + 20
    assert work["n_ops"] > work["iterations"] * work["valid_observations"] \
        * sc.WIN_OBS_TERM_OPS


if __name__ == "__main__":
    import sys

    for case in sys.argv[1:] or sc.WINDOW_CASES:
        print(case, record(case), flush=True)
