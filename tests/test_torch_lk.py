"""Parity of the port's LK (`lk_cuda.track`, plain version on the CPU) with
the Pallas kernel's `lk_pallas.track` in interpret mode: same seeded
inputs, uv atol 1e-3 px, status equal. One interpret-mode call is shared
by the module (it takes seconds per call)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.features import fast as jfast
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking import lk_pallas
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.tracking import lk as tlk
from ya_vo_tpu_torch.tracking import lk_cuda

H, W, N = 128, 256, 32


@pytest.fixture(scope="module")
def case():
    imgs, *_ = synthetic.render_sequence(
        n_frames=2, n_landmarks=150, height=H, width=W, step=0.5,
        yaw_rate=0.01, seed=3)
    kp = jfast.detect(jnp.asarray(imgs[0]), max_keypoints=N, border=16)
    uv0 = np.array(kp.uv)
    mask = np.array(kp.mask)
    rng = np.random.default_rng(0)
    seed = (uv0 + rng.normal(0.0, 1.5, size=uv0.shape)).astype(np.float32)
    # dead slots with garbage positions
    mask[[3, 17]] = False
    seed[3] = (-40.0, 900.0)
    # border clamps: templates at and beyond the edges, seeds past the
    # padded level (the level-0 clamp reaches u = 248 in a 256 image)
    uv0[20], seed[20] = (1.0, 2.0), (0.5, -3.0)
    uv0[21], seed[21] = (W - 2.0, H - 1.5), (W + 9.0, H + 4.0)
    uv0[22], seed[22] = (W - 6.3, 60.2), (W - 4.0, 61.0)
    mask[20:23] = True
    uv0, seed = uv0.astype(np.float32), seed.astype(np.float32)
    ref = lk_pallas.track(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                          jnp.asarray(uv0), jnp.asarray(seed),
                          jnp.asarray(mask))
    return imgs, uv0, seed, mask, ref


def _port(case):
    imgs, uv0, seed, mask, _ = case
    return lk_cuda.track(torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]),
                         torch.as_tensor(uv0), torch.as_tensor(seed),
                         torch.as_tensor(mask))


def test_track_matches_pallas_interpret(case):
    ref = case[-1]
    out = _port(case)
    np.testing.assert_allclose(out.uv.numpy(), np.asarray(ref.uv), atol=1e-3)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.residual.numpy(), np.asarray(ref.residual),
                               rtol=1e-4, atol=1e-3)
    assert out.status.sum() >= 10


def test_track_matches_pallas_v3_interpret(case, monkeypatch):
    """The same inputs through the TPU kernel's other body,
    `_lk_level_kernel_batched` (`YA_VO_LK_KERNEL=v3`, read when
    `lk_pallas.track` is traced, so the jit caches are cleared around the
    call), against the port's LK, which computes the same level: uv atol
    1e-3 px, status equal, residual rtol 1e-4 (as for the default body)."""
    imgs, uv0, seed, mask, ref_v2 = case
    traced = []
    body = lk_pallas._lk_level_kernel_batched

    def batched(*args, **kw):
        traced.append(kw)
        return body(*args, **kw)

    monkeypatch.setattr(lk_pallas, "_lk_level_kernel_batched", batched)
    monkeypatch.setenv("YA_VO_LK_KERNEL", "v3")
    jax.clear_caches()
    try:
        ref = lk_pallas.track(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                              jnp.asarray(uv0), jnp.asarray(seed),
                              jnp.asarray(mask))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        jax.clear_caches()      # later calls trace the default body again
    assert traced, "the v3 body was not traced"
    out = _port(case)
    np.testing.assert_allclose(out.uv.numpy(), ref.uv, atol=1e-3)
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    np.testing.assert_allclose(out.residual.numpy(), ref.residual,
                               rtol=1e-4, atol=1e-3)
    assert out.status.sum() >= 10
    # the two bodies agree with each other as closely
    np.testing.assert_allclose(ref.uv, np.asarray(ref_v2.uv), atol=1e-3)
    np.testing.assert_array_equal(ref.status, np.asarray(ref_v2.status))


def test_dead_slots_and_clamps(case):
    _, uv0, seed, mask, ref = case
    out = _port(case)
    # dead slots return the seed (rescaled through the levels) and 1e9
    np.testing.assert_allclose(out.uv.numpy()[3], seed[3], rtol=1e-6)
    assert out.residual[3].item() == 1e9 and not out.status[3]
    # clamped tracks stay inside the padded level: [6, 248] x [6, 120]
    uv = out.uv.numpy()[mask]
    assert uv[:, 0].min() >= 6.0 and uv[:, 0].max() <= 248.0
    assert uv[:, 1].min() >= 6.0 and uv[:, 1].max() <= 120.0


def test_build_pyramid_matches():
    img = np.random.default_rng(1).uniform(0, 255, size=(75, 141)).astype(
        np.float32)
    ref = jlk.build_pyramid(jnp.asarray(img), 3)
    out = tlk.build_pyramid(torch.as_tensor(img), 3)
    assert [tuple(o.shape) for o in out] == [(75, 141), (37, 70), (18, 35)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4)


def test_padded_size():
    assert lk_cuda.padded_size(376, 1241) == (376, 1280)
    assert lk_cuda.padded_size(188, 620) == (192, 640)
    assert lk_cuda.padded_size(94, 310) == (96, 384)
    assert lk_cuda.padded_size(20, 100) == (32, 256)


def test_cpu_tensors_do_not_count_launches(case):
    _build.reset_launches()
    _port(case)
    assert _build.LAUNCHES["lk_level"] == 0

