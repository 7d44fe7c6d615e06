"""Parity of the port's geometry (triangulation, epipolar, RANSAC) with the
JAX package on seeded two-view data. RANSAC gets the JAX draw injected
(`sample_idx`), since torch cannot reproduce `jax.random` bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.geometry import epipolar as jepi
from ya_vo_tpu.geometry import ransac as jransac
from ya_vo_tpu.geometry import triangulation as jtri
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu_torch.geometry import epipolar as tepi
from ya_vo_tpu_torch.geometry import ransac as transac
from ya_vo_tpu_torch.geometry import triangulation as ttri


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def two_view():
    cam = synthetic.kitti_camera()
    lms = synthetic.random_landmarks(400, seed=2)
    poses = synthetic.forward_trajectory(2, step=0.8, yaw_rate=0.02)
    uv, vis = synthetic.project_tracks(lms, poses, cam, 376, 1241)
    rng = np.random.default_rng(4)
    uv = (uv + rng.normal(0, 0.3, size=uv.shape)).astype(np.float32)
    mask = vis[0] & vis[1]
    # gross outliers
    out = rng.choice(np.flatnonzero(mask), 30, replace=False)
    uv[1, out] += rng.uniform(-40, 40, size=(30, 2)).astype(np.float32)
    K = np.asarray(cam.K, np.float32)
    return uv[0], uv[1], mask, K, poses


def _projections(K, poses):
    return (K @ poses[0][:3, :4]).astype(np.float32), \
        (K @ poses[1][:3, :4]).astype(np.float32)


def _rel_err(p, ref):
    return np.abs(p - ref).max(1) / np.abs(ref).max(1)


@pytest.mark.parametrize("fn,max_flips", [("triangulate_fast", 0),
                                          ("triangulate", 0.05)])
def test_triangulation_matches(two_view, fn, max_flips):
    """Pixel-scale DLT in float32 is ill-conditioned: both packages land
    up to ~1% (median ~4e-4) away from a float64 solve, in different
    directions. So the port is held to the JAX package's own float32 error
    against float64 (the port run in float64), within 2x plus 1e-4. The
    sigma-ratio quality gate of `triangulate` flips ~3.5% of these points
    on either side against float64; at most 5% may differ."""
    uv1, uv2, mask, K, poses = two_view
    P1, P2 = _projections(K, poses)
    pj, vj = (np.asarray(x) for x in getattr(jtri, fn)(P1, P2, uv1, uv2,
                                                        mask))
    pt, vt = (x.numpy() for x in getattr(ttri, fn)(
        _t(P1), _t(P2), _t(uv1), _t(uv2), _t(mask)))
    p64, v64 = (x.numpy() for x in getattr(ttri, fn)(
        *(_t(x).double() for x in (P1, P2, uv1, uv2)), _t(mask)))
    assert (vt != vj).sum() <= max_flips * mask.sum()
    sel = vj & vt & v64
    assert sel.sum() > 100
    e_j, e_t = _rel_err(pj[sel], p64[sel]), _rel_err(pt[sel], p64[sel])
    assert e_t.max() <= 2 * e_j.max() + 1e-4, (e_t.max(), e_j.max())
    assert np.median(e_t) <= 2 * np.median(e_j) + 1e-5


def _sign_dist(a, b):
    """Max-abs distance of two matrices up to sign and scale."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_eight_point_and_sampson_match(two_view):
    uv1, uv2, mask, K, poses = two_view
    clean = mask.copy()
    Fj = np.asarray(jepi.eight_point(uv1, uv2, clean))
    Ft = tepi.eight_point(_t(uv1), _t(uv2), _t(clean)).numpy()
    assert _sign_dist(Ft, Fj) < 1e-4
    np.testing.assert_allclose(
        tepi.sampson_error(_t(Fj), _t(uv1), _t(uv2)).numpy(),
        np.asarray(jepi.sampson_error(Fj, uv1, uv2)), rtol=1e-3, atol=1e-4)
    E = np.asarray(jepi.essential_from_fundamental(Fj, K, K))
    np.testing.assert_allclose(
        tepi.essential_from_fundamental(_t(Fj), _t(K), _t(K)).numpy(), E,
        rtol=1e-5, atol=1e-6)
    # the four (R, t) candidates are the same set
    Rj, tj = (np.asarray(x) for x in jepi.decompose_essential(E))
    Rt, tt = (x.numpy() for x in tepi.decompose_essential(_t(E)))
    for R, t in zip(Rt, tt):
        assert min(np.abs(R - Rj[i]).max() + np.abs(t - tj[i]).max()
                   for i in range(4)) < 1e-4


def test_epipolar_error_and_relative_pose_match(two_view):
    """|x2^T F x1| against JAX's at F from the eight-point solve (rtol
    1e-4: a float32 dot product of pixel-scale terms that cancel); the
    relative pose assembled bit for bit."""
    uv1, uv2, mask, K, poses = two_view
    F = np.asarray(jepi.eight_point(uv1, uv2, mask))
    err = tepi.epipolar_error(_t(F), _t(uv1), _t(uv2)).numpy()
    ref = np.asarray(jepi.epipolar_error(jnp.asarray(F), uv1, uv2))
    np.testing.assert_allclose(err, ref, rtol=1e-4, atol=1e-6)
    assert np.median(err[mask]) < np.median(err[~mask])
    R, t = poses[1][:3, :3].astype(np.float32), \
        poses[1][:3, 3].astype(np.float32)
    np.testing.assert_array_equal(
        transac.relative_pose_to_se3(_t(R), _t(t)).numpy(),
        np.asarray(jransac.relative_pose_to_se3(jnp.asarray(R),
                                                jnp.asarray(t))))


def test_ransac_with_injected_samples(two_view):
    """Same hypotheses on both sides: equal inlier masks and cheirality
    votes. F (up to sign and scale) and the unit t are compared through a
    float64 run of the port on the same samples: the port's float32 error
    stays within 2x the JAX package's (both are ~1e-2 on this forward-motion
    pair, where the epipole is poorly conditioned)."""
    uv1, uv2, mask, K, poses = two_view
    key = jax.random.PRNGKey(7)
    idx = _t(jransac._sample_indices(key, 512, 8, jnp.asarray(mask))).long()
    ref = jransac.estimate_two_view(uv1, uv2, mask, K, key)
    out = transac.estimate_two_view(_t(uv1), _t(uv2), _t(mask), _t(K),
                                    sample_idx=idx)
    o64 = transac.estimate_two_view(_t(uv1).double(), _t(uv2).double(),
                                    _t(mask), _t(K).double(), sample_idx=idx)
    np.testing.assert_array_equal(out.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    assert int(out.n_inliers) == int(ref.n_inliers) > 300
    # the cheirality winner's triangulation has the same quality-gate
    # flips as test_triangulation_matches
    flips = (out.points_valid.numpy() != np.asarray(ref.points_valid)).sum()
    assert flips <= 0.05 * mask.sum()
    # floor: the float32 null vector of the refit's 9x9 A^T A is good to
    # ~6e-4 in either package (eigen-gap 5e-3 against a norm of ~1e3)
    F64 = o64.F.numpy()
    assert _sign_dist(out.F.numpy(), F64) \
        <= 2 * _sign_dist(np.asarray(ref.F), F64) + 1e-3
    # t is the epipole direction, which forward motion conditions poorly:
    # it moves ~10x as far as F, so its floor is 1e-2
    t64 = o64.t.numpy()
    assert np.abs(out.t.numpy() - t64).max() \
        <= 2 * np.abs(np.asarray(ref.t) - t64).max() + 1e-2
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-3)
    t_gt = poses[1][:3, 3] / np.linalg.norm(poses[1][:3, 3])
    assert abs(float(out.t.numpy() @ t_gt)) > 0.99


def test_ransac_own_draw_recovers_motion(two_view):
    uv1, uv2, mask, K, poses = two_view
    out = transac.estimate_two_view(_t(uv1), _t(uv2), _t(mask), _t(K),
                                    torch.Generator().manual_seed(7))
    t_gt = poses[1][:3, 3] / np.linalg.norm(poses[1][:3, 3])
    assert float(out.t.numpy() @ t_gt) > 0.99
    np.testing.assert_allclose(out.R.numpy(), poses[1][:3, :3], atol=2e-3)


def test_eight_point_null_vector_precision(two_view, monkeypatch):
    """The 8-point null vector on the CPU is LAPACK's float32 eigh of the
    float32 AᵀA, the JAX package's solver there (the card's float64 solve
    is held in tests/test_torch_kernels.py)."""
    uv1, uv2, mask, *_ = two_view
    seen = []
    eigh = torch.linalg.eigh

    def spy(M):
        seen.append(M)
        return eigh(M)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    F = tepi.eight_point(_t(uv1), _t(uv2), _t(mask))
    assert F.dtype == torch.float32
    assert [M.dtype for M in seen] == [torch.float32]
