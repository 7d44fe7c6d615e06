"""Parity of the port's Hamming matrix and matcher with the JAX package:
the plain distance matrix against `hamming_matrix_pallas` in interpret mode
(exact), and `match` exact on tie-heavy descriptors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ya_vo_tpu.features import matching as jmatching
from ya_vo_tpu.features.pallas_hamming import hamming_matrix_pallas
from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.features import hamming_cuda
from ya_vo_tpu_torch.features import matching as tmatching


def _desc(rng, k, words=8):
    return rng.integers(0, 2 ** 32, size=(k, words), dtype=np.uint32)


def _t(d):
    return torch.as_tensor(d.view(np.int32))


def _popcount_oracle(d1, d2):
    x = d1[:, None, :] ^ d2[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)


def test_hamming_matches_pallas_interpret_and_oracle():
    rng = np.random.default_rng(0)
    d1, d2 = _desc(rng, 256), _desc(rng, 512)
    d2[:3] = d1[:3]                         # distance 0
    d2[3] = ~d1[3]                          # distance 256
    ref = np.asarray(hamming_matrix_pallas(jnp.asarray(d1), jnp.asarray(d2)))
    out = hamming_cuda.hamming_matrix(_t(d1), _t(d2)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _popcount_oracle(d1, d2))
    assert out[3, 3] == 256 and out[0, 0] == 0


def _tie_heavy(rng, k):
    """Descriptors drawn from a small pool with few differing bits, so
    rows and columns hold many equal minimum distances."""
    base = _desc(rng, 1)
    pool = np.repeat(base, 24, axis=0)
    for i in range(24):
        pool[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(32)))
    return pool[rng.integers(0, 24, size=k)]


@pytest.mark.parametrize("cross_check,abs_threshold",
                         [(True, 20), (False, 20), (True, 1)])
def test_match_exact_on_ties(cross_check, abs_threshold):
    rng = np.random.default_rng(3)
    d1, d2 = _tie_heavy(rng, 300), _tie_heavy(rng, 280)
    m1 = rng.random(300) > 0.1
    m2 = rng.random(280) > 0.1
    ref = jmatching.match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1),
                          jnp.asarray(m2), abs_threshold=abs_threshold,
                          cross_check=cross_check)
    out = tmatching.match(_t(d1), _t(d2), torch.as_tensor(m1),
                          torch.as_tensor(m2), abs_threshold=abs_threshold,
                          cross_check=cross_check)
    np.testing.assert_array_equal(out.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert int(ref.mask.sum()) > 0


def test_match_on_random_descriptors():
    rng = np.random.default_rng(5)
    d1 = _desc(rng, 512)
    d2 = d1[rng.permutation(512)].copy()
    d2[::3, 0] ^= np.uint32(0x11)           # a few flipped bits
    m = np.ones(512, bool)
    ref = jmatching.match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m),
                          jnp.asarray(m))
    out = tmatching.match(_t(d1), _t(d2), torch.as_tensor(m),
                          torch.as_tensor(m))
    np.testing.assert_array_equal(out.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))


def test_gather_matched_uv_matches():
    rng = np.random.default_rng(7)
    d1, d2 = _desc(rng, 200), _desc(rng, 240)
    d2[:150] = d1[rng.permutation(200)[:150]]
    m1, m2 = rng.random(200) > 0.1, np.ones(240, bool)
    uv1 = rng.uniform(0, 1241, size=(200, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 1241, size=(240, 2)).astype(np.float32)
    ref = jmatching.gather_matched_uv(
        jnp.asarray(uv1), jnp.asarray(uv2),
        jmatching.match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1),
                        jnp.asarray(m2)))
    out = tmatching.gather_matched_uv(
        torch.as_tensor(uv1), torch.as_tensor(uv2),
        tmatching.match(_t(d1), _t(d2), torch.as_tensor(m1),
                        torch.as_tensor(m2)))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(out[2].sum()) > 100


def test_cpu_tensors_do_not_count_launches():
    rng = np.random.default_rng(1)
    _build.reset_launches()
    hamming_cuda.hamming_matrix(_t(_desc(rng, 8)), _t(_desc(rng, 8)))
    assert _build.LAUNCHES["hamming"] == 0

