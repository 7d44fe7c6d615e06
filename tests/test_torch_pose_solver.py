"""Parity of the port's robust pose GN with the JAX package on seeded
observations with noise and outliers (float32), and the plain version's
early exit against JAX's while-loop. On the CPU `solve_pose` takes
`solve_pose_plain`; its CUDA kernel (K4) is held against the plain version
on the card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.core import camera as jcam
from ya_vo_tpu.core import lie as jlie
from ya_vo_tpu.tracking import pose_solver as jps
from ya_vo_tpu.utils import synthetic
from port_jax_reference import jax_pose_counter
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.tracking import pose_solver as tps


@pytest.fixture(scope="module")
def problem():
    cam = synthetic.kitti_camera()
    lms = synthetic.random_landmarks(600, seed=8)
    poses = synthetic.forward_trajectory(2, step=0.7, yaw_rate=0.03)
    uv, vis = synthetic.project_tracks(lms, poses, cam, 376, 1241)
    rng = np.random.default_rng(6)
    obs = (uv[1] + rng.normal(0, 0.5, size=uv[1].shape)).astype(np.float32)
    bad = rng.choice(600, 40, replace=False)
    obs[bad] += rng.uniform(-30, 30, size=(40, 2)).astype(np.float32)
    xi = np.array([0.05, -0.02, 0.1, 0.004, -0.006, 0.002], np.float32)
    T_init = np.array(jlie.se3_exp(jnp.asarray(xi)) @ poses[1])
    return cam, lms, obs, vis[1], T_init, poses[1]


@pytest.mark.parametrize("iters", [3, 40])
def test_solve_pose_matches(problem, iters):
    """Pose entries atol 2e-5 (rotation) / 2e-4 (translation, |t| ~ 1):
    the normal equations sum 600 residuals in another order."""
    cam, lms, obs, vis, T_init, _ = problem
    ref = jps.solve_pose(jnp.asarray(T_init), jnp.asarray(lms),
                         jnp.asarray(obs), jnp.asarray(vis), cam,
                         iters=iters)
    out = tps.solve_pose(torch.as_tensor(T_init), torch.as_tensor(lms),
                         torch.as_tensor(obs), torch.as_tensor(vis),
                         Camera.create(*(float(c) for c in cam)),
                         iters=iters)
    P_ref = np.asarray(ref.pose)
    np.testing.assert_allclose(out.pose.numpy()[:3, :3], P_ref[:3, :3],
                               atol=2e-5)
    np.testing.assert_allclose(out.pose.numpy()[:3, 3], P_ref[:3, 3],
                               atol=2e-4)
    np.testing.assert_array_equal(out.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(out.final_cost), float(ref.final_cost),
                               rtol=1e-3)


def test_solve_pose_converges(problem):
    cam, lms, obs, vis, T_init, T_gt = problem
    out = tps.solve_pose(torch.as_tensor(T_init), torch.as_tensor(lms),
                         torch.as_tensor(obs), torch.as_tensor(vis),
                         Camera.create(*(float(c) for c in cam)))
    np.testing.assert_allclose(out.pose.numpy(), T_gt, atol=5e-3)
    assert int(out.n_inliers) > 0.8 * vis.sum()


# ---------------------------------------------------------------------------
# The early exit: the plain version's iterations against JAX's while-loop
# ---------------------------------------------------------------------------
def jax_solve_counted(T_init, pts, uv, mask, cam, **gn):
    """`pose_solver._solve_pose` jitted as `solve_pose` jits it, with the
    while-loop's final counter (its state's `it`) sent to the host
    (`port_jax_reference.jax_pose_counter`). Returns (PoseSolveResult,
    iterations)."""
    return jax_pose_counter(cam, **gn)(T_init, pts, uv, mask)


EXIT_CASES = {
    "well_seeded": dict(outliers=0.0, holes=0.0, behind=0),
    "outliers_holes_behind": dict(),
    "ragged_37": dict(n=37, seed=4),
    "all_masked": dict(n_valid=0),
}


@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_plain_early_exit_equals_jax_while_loop(case):
    """The iteration at which the plain version's `active` drops equals
    the count JAX's while-loop ends at, on seeded problems (selfcheck's
    generator: 2048 points unless stated, the KITTI camera, a perturbed
    prior). JAX's count is the smallest `iters` whose pose equals the
    `iters=40` pose bit for bit (a zeroed last step aside, which leaves
    the pose as it was); the plain version's `iters=count` pose equals
    its own `iters=40` pose bit for bit too."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device="cpu",
                                                  **EXIT_CASES[case])
    ref, n_ref = jax_solve_counted(T, pts, uv, mask, cam)
    out, n_plain = tps.solve_pose_plain(T, pts, uv, mask, cam,
                                        with_iters=True)
    assert int(n_plain) == n_ref
    assert 1 <= n_ref < 40
    args = (jnp.asarray(T.numpy()), jnp.asarray(pts.numpy()),
            jnp.asarray(uv.numpy()), jnp.asarray(mask.numpy()),
            jcam.Camera.create(*cam))
    j_at = np.asarray(jps.solve_pose(*args, iters=n_ref).pose)
    assert np.array_equal(j_at.view(np.int32),
                          np.asarray(ref.pose).view(np.int32))
    p_at = tps.solve_pose_plain(T, pts, uv, mask, cam, iters=n_ref)
    assert sc.bits_equal(p_at.pose, out.pose)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=2e-4)
    if case == "all_masked":
        # H = damping * I and b = 0: a zero step, the exit at iteration 1
        assert n_ref == 1 and sc.bits_equal(out.pose, T)
        assert int(out.n_inliers) == 0 and float(out.final_cost) == 0.0


def test_solve_pose_on_cpu_is_the_plain_version(problem):
    """`solve_pose` on CPU tensors is `solve_pose_plain`, bit for bit, with
    and without the iteration count."""
    cam, lms, obs, vis, T_init, _ = problem
    args = (torch.as_tensor(T_init), torch.as_tensor(lms),
            torch.as_tensor(obs), torch.as_tensor(vis),
            Camera.create(*(float(c) for c in cam)))
    a = tps.solve_pose(*args, iters=12)
    b, n = tps.solve_pose_plain(*args, iters=12, with_iters=True)
    c, m = tps.solve_pose(*args, iters=12, with_iters=True)
    assert all(sc.bits_equal(x, y) for x, y in zip(a, b))
    assert all(sc.bits_equal(x, y) for x, y in zip(b, c))
    assert int(n) == int(m) and n.dtype == torch.int64


def test_textured_step_solve_inputs_on_cpu():
    """selfcheck's real-step inputs (chip_smoke.py phase 3's K4 check) at
    a small size: the track table's K_cap rows, live flow among them, and
    `solve_pose` on them (the plain version on the CPU) converging early
    with most of the flow inliers."""
    from ya_vo_tpu_torch.core.camera import Camera as TCamera
    cam = TCamera.create(359.428, 359.428, 303.5964, 92.60785)
    *step, gn = sc.textured_solve_inputs(
        device="cpu", n_frames=12, height=188, width=620, cam=cam,
        tex_size=512)
    _, pts, uv, status, cam_out = step
    assert cam_out == cam and gn["iters"] == 40
    assert pts.shape == (2048, 3) and uv.shape == (2048, 2)
    assert status.dtype == torch.bool and int(status.sum()) > 100
    out = sc.pose_gn_parity(*step, **gn)
    assert out["max_abs_err"] == 0.0 and out["iterations"] < 40
    assert out["n_inliers"] > 0.8 * int(status.sum())


@pytest.mark.parametrize("n_valid", [0, 1, 2])
def test_degenerate_parity_on_cpu(n_valid):
    """selfcheck's degenerate branch on the CPU (the plain version on both
    sides): every first step taken solves the linear model on the valid
    points, to float64 rounding of the float32 pose; none with no valid
    point, where H = damping * I and b = 0 give a zero step."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device="cpu", n=512,
                                                  n_valid=n_valid, seed=3)
    out = sc.pose_gn_parity(T, pts, uv, mask, cam)
    assert out["degenerate"] and out["n_valid_init"] == n_valid
    assert out["first_step_kernel"] == out["first_step_plain"]
    if n_valid:
        assert out["first_step_plain"] <= 1e-4 * out["res_init"]
    else:
        assert out["first_step_plain"] == "zero" and out["iterations"] == 1


def test_degenerate_parity_catches_a_wrong_step(monkeypatch):
    """The degenerate branch fails a solver whose first step is half the
    Gauss-Newton step (a pose that a final-cost bound alone lets pass)."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device="cpu", n=512,
                                                  n_valid=2, seed=3)
    plain = tps.solve_pose_plain

    def half_step(T_init, *args, iters=40, **kw):
        out = plain(T_init, *args, iters=iters, **kw)
        if iters != 1:
            return out
        dx = tps.lie.se3_log(out.pose @ tps.lie.se3_inverse(T_init))
        return out._replace(pose=tps.lie.se3_exp(0.5 * dx) @ T_init)

    monkeypatch.setattr(tps, "solve_pose", half_step)
    with pytest.raises(RuntimeError, match="linear model"):
        sc.pose_gn_parity(T, pts, uv, mask, cam)


# ---------------------------------------------------------------------------
# Recorded inputs (tests/torch_data/pose_gn): the solves of chip_smoke.py
# phase 8's frames that ran to the 40-iteration cap on the card
# ---------------------------------------------------------------------------
CAPPED = sorted(sc.POSE_DATA.glob("capped_*.npz"))


@pytest.mark.parametrize("path", CAPPED, ids=lambda p: p.stem)
def test_capped_solves_against_jax_while_loop(path):
    """On each recorded solve that K4 ran to the 40-iteration cap on the
    card, JAX's while-loop (`_solve_pose` jitted, its count read through
    the host callback) against the plain version on the CPU: the port's
    plain version does not cap where JAX exits early (the fault this test
    looks for), and the two end on the same float32 point, where a step
    norm hovering near the 1e-5 exit decides by rounding whether a solver
    stops (PERF.md section 6): translations within 2 float32
    spacings of the largest |t| (1.2 measured), rotations within 2e-7
    (1.1e-7), equal inlier counts, costs within 1e-4 relative (1.4e-5)."""
    T, pts, uv, mask, cam, gn = sc.load_pose_inputs(path, device="cpu")
    ref, n_jax = jax_solve_counted(T, pts, uv, mask, cam, **gn)
    out, n_plain = tps.solve_pose_plain(T, pts, uv, mask, cam,
                                        with_iters=True, **gn)
    print(f"{path.stem}: JAX {n_jax}, plain {int(n_plain)} iterations")
    assert not (int(n_plain) == gn["iters"] and n_jax < gn["iters"])
    P, P_ref = out.pose.numpy(), np.asarray(ref.pose)
    spacing = np.spacing(np.abs(P_ref[:3, 3]).max())
    assert np.abs(P[:3, 3] - P_ref[:3, 3]).max() <= 2 * spacing
    np.testing.assert_allclose(P[:3, :3], P_ref[:3, :3], atol=2e-7)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(out.final_cost), float(ref.final_cost),
                               rtol=1e-4)


def test_recorded_inputs_round_trip(tmp_path):
    """`save_pose_inputs` / `load_pose_inputs` keep every bit, the camera
    and the GN keywords."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device="cpu", n=300, seed=5)
    gn = dict(iters=40, huber_delta=2.4477, chi2_threshold=5.991)
    sc.save_pose_inputs(tmp_path / "x.npz", T, pts, uv, mask, cam, gn,
                        frame=np.int64(3))
    *got, cam2, gn2 = sc.load_pose_inputs(tmp_path / "x.npz", device="cpu")
    assert all(sc.bits_equal(a, b) for a, b in zip(got, (T, pts, uv, mask)))
    assert cam2 == cam and gn2 == gn


def test_golden_record_and_check_round_trip(tmp_path, monkeypatch):
    """`record_pose_gn_goldens` then `check_pose_gn_goldens` on the CPU
    (the plain version on both sides, a few seeded problems and one inputs
    file) pass, and a changed output bit fails them."""
    monkeypatch.setattr(sc, "POSE_GOLDEN_SEEDED",
                        dict(n37=dict(n=37, seed=2), all_masked=dict(
                            n=64, n_valid=0)))
    T, pts, uv, mask, cam = sc.pose_gn_problem(device="cpu", n=200, seed=9)
    sc.save_pose_inputs(tmp_path / "capped_f001.npz", T, pts, uv, mask, cam,
                        dict(iters=40, huber_delta=2.4477,
                             chi2_threshold=5.991))
    path = tmp_path / sc.POSE_GOLDEN.name
    assert sc.record_pose_gn_goldens(path, device="cpu",
                                     data=tmp_path) == 4 * 3
    out = sc.check_pose_gn_goldens(path, device="cpu")
    assert out["cases"] == 12 and out["launches"] == 0
    assert sc.check_pose_gn_goldens(path, device="cpu",
                                    prefixes=["capped_"])["cases"] == 3
    with np.load(path) as z:
        rec = dict(z)
    rec["n37_iters3:pose"] = rec["n37_iters3:pose"] ^ 1
    np.savez(path, **rec)
    with pytest.raises(RuntimeError, match="n37_iters3 \\(pose\\)"):
        sc.check_pose_gn_goldens(path, device="cpu")


def test_golden_file_covers_every_case():
    """The committed goldens hold exactly the cases `pose_gn_golden_cases`
    makes (the seeded problems, no point, the real step and the capped
    solves, each at `iters` 1, 3 and 40)."""
    with np.load(sc.POSE_GOLDEN) as z:
        keys = {k.rsplit(":", 1)[0] for k in z.files}
        assert len(z.files) == len(keys) * len(sc.POSE_OUTPUTS)
    names = [k for k, *_ in sc.pose_gn_golden_cases(device="cpu")]
    assert set(names) == keys and len(names) == len(keys)
    assert len(CAPPED) >= 4 and any(k.startswith("step_") for k in keys)
