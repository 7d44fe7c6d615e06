"""Parity of the PyTorch port's core modules (lie, camera) with the JAX
package on the same seeded numpy inputs, at float32 (atol 1e-5 unless
stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.core import camera as jcamera
from ya_vo_tpu.core import lie as jlie
from ya_vo_tpu_torch.core import camera as tcamera
from ya_vo_tpu_torch.core import lie as tlie

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def tangents():
    rng = np.random.default_rng(11)
    xi = rng.normal(0.0, 0.4, size=(64, 6)).astype(np.float32)
    xi[:4, 3:] = 0.0                    # theta == 0: the Taylor branch
    xi[4:8, 3:] *= 1e-5                 # theta^2 below the 1e-8 switch
    return xi


@pytest.mark.parametrize("fn", ["hat", "so3_exp"])
def test_so3_maps_match(tangents, fn):
    w = tangents[:, 3:]
    np.testing.assert_allclose(getattr(tlie, fn)(_t(w)).numpy(),
                               np.asarray(getattr(jlie, fn)(jnp.asarray(w))),
                               atol=ATOL)


def test_se3_exp_log_match(tangents):
    T_j = np.asarray(jlie.se3_exp(jnp.asarray(tangents)))
    T_t = tlie.se3_exp(_t(tangents)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=ATOL)
    np.testing.assert_allclose(tlie.se3_log(_t(T_j)).numpy(),
                               np.asarray(jlie.se3_log(jnp.asarray(T_j))),
                               atol=1e-4)   # log divides by sin(theta)
    np.testing.assert_allclose(tlie.so3_log(_t(T_j[:, :3, :3])).numpy(),
                               np.asarray(jlie.so3_log(
                                   jnp.asarray(T_j[:, :3, :3]))), atol=1e-4)


def test_inverse_compose_transform_match(tangents):
    T = np.asarray(jlie.se3_exp(jnp.asarray(tangents)))
    pts = np.random.default_rng(3).normal(size=(64, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.se3_inverse(_t(T)).numpy(),
                               np.asarray(jlie.se3_inverse(jnp.asarray(T))),
                               atol=ATOL)
    np.testing.assert_allclose(
        tlie.transform_points(_t(T), _t(pts)).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T), jnp.asarray(pts))),
        atol=1e-4)   # |points| up to ~4, float32 products
    np.testing.assert_allclose(
        tlie.transform_points(_t(T[0]), _t(pts[0, 0])).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T[0]),
                                         jnp.asarray(pts[0, 0]))), atol=1e-5)
    R, t = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(tlie.rt_to_mat(_t(R), _t(t)).numpy(),
                                  np.asarray(jlie.rt_to_mat(R, t)))


def test_se3_compose_and_identity_match(tangents):
    T = np.asarray(jlie.se3_exp(jnp.asarray(tangents)))
    A, B = T[:32], T[32:]
    np.testing.assert_allclose(
        tlie.se3_compose(_t(A), _t(B)).numpy(),
        np.asarray(jlie.se3_compose(jnp.asarray(A), jnp.asarray(B))),
        atol=ATOL)
    eye = tlie.se3_identity()
    assert eye.dtype == torch.float32
    np.testing.assert_array_equal(eye.numpy(),
                                  np.asarray(jlie.se3_identity()))
    assert tlie.se3_identity(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("margin", [0, 5])
def test_in_bounds_matches(margin):
    rng = np.random.default_rng(9)
    uv = rng.uniform(-20, 1260, size=(2, 300, 2)).astype(np.float32)
    uv[0, :4] = [[0, 0], [1240, 375], [1240.5, 10], [5, 370]]  # the edges
    out = tcamera.in_bounds(_t(uv), 376, 1241, margin).numpy()
    ref = np.asarray(jcamera.in_bounds(jnp.asarray(uv), 376, 1241, margin))
    np.testing.assert_array_equal(out, ref)
    assert out.any() and not out.all()


def test_camera_matches():
    jc = jcamera.Camera.create(718.856, 718.856, 607.1928, 185.2157)
    tc = tcamera.Camera.create(718.856, 718.856, 607.1928, 185.2157)
    np.testing.assert_array_equal(tc.K().numpy(), np.asarray(jc.K))
    rng = np.random.default_rng(5)
    pc = rng.uniform([-10, -3, -1], [10, 3, 40], size=(500, 3)).astype(
        np.float32)
    pc[:5, 2] = 0.0                      # the z_safe branch
    uv_j, z_j = jc.project(jnp.asarray(pc))
    uv_t, z_t = tc.project(_t(pc))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6,
                               atol=1e-3)   # |uv| up to ~7e9 at z_safe
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    uv = rng.uniform(0, 1241, size=(100, 2)).astype(np.float32)
    depth = rng.uniform(1, 50, size=100).astype(np.float32)
    np.testing.assert_allclose(tc.unproject(_t(uv)).numpy(),
                               np.asarray(jc.unproject(jnp.asarray(uv))),
                               atol=ATOL)
    np.testing.assert_allclose(
        tc.unproject(_t(uv), _t(depth)).numpy(),
        np.asarray(jc.unproject(jnp.asarray(uv), jnp.asarray(depth))),
        atol=1e-4)
    T = np.asarray(jlie.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, size=(4, 6)).astype(np.float32))))
    np.testing.assert_allclose(tc.projection_matrix(_t(T)).numpy(),
                               np.asarray(jc.projection_matrix(T)),
                               rtol=1e-6, atol=1e-3)
