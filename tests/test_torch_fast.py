"""Parity of the port's FAST detector with the JAX package: the plain score
map and candidates against `pallas_fast.fast_score_map` in interpret mode,
and `detect` against `fast.detect`. The port reads zeros outside the image
where the JAX paths wrap, so maps are compared on the interior (16 px in).
Also the contracts the CUDA kernels rely on: the cardinal pre-test of the
segment test is exact, and the selection of the top K from candidates in
any order gives the slots of the stable sort."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.lib.stride_tricks import sliding_window_view
import torch

from ya_vo_tpu.features import fast as jfast
from ya_vo_tpu.features import pallas_fast
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.features import fast as tfast
from ya_vo_tpu_torch.features import fast_cuda

ARGS = dict(threshold=20.0, arc_length=12, harris_k=0.04, nms_radius=3)


def _frame(h, w, seed, n=120):
    imgs, *_ = synthetic.render_sequence(n_frames=1, n_landmarks=n,
                                         height=h, width=w, seed=seed)
    return imgs[0]


@pytest.fixture(scope="module")
def small():
    img = _frame(128, 256, 4, n=300)
    ref = np.asarray(pallas_fast.fast_score_map(
        jnp.asarray(img, jnp.float32), **ARGS))
    return img, ref


def test_score_map_matches_pallas_interpret(small):
    img, ref = small
    out = fast_cuda.fast_score_map(torch.as_tensor(img).float(), **ARGS)
    out = out.numpy()
    interior = np.zeros(img.shape, bool)
    interior[16:-16, 16:-16] = True
    keep_ref = ref > pallas_fast.NEG / 2
    keep_out = out > fast_cuda.NEG / 2
    np.testing.assert_array_equal(keep_out & interior, keep_ref & interior)
    sel = keep_ref & interior
    assert sel.sum() > 20
    np.testing.assert_allclose(out[sel], ref[sel], rtol=1e-5)


def test_score_map_parts_match_jnp(small):
    img, _ = small
    f_j = jnp.asarray(img, jnp.float32)
    f_t = torch.as_tensor(img).float()
    sl = (slice(8, -8), slice(8, -8))   # roll vs zero fill: 8 px edge
    np.testing.assert_array_equal(
        fast_cuda.fast_response(f_t, 20.0, 12).numpy()[sl],
        np.asarray(jfast.fast_response(f_j, 20.0, 12))[sl])
    np.testing.assert_allclose(fast_cuda.harris_response(f_t, 0.04).numpy()[sl],
                               np.asarray(jfast.harris_response(f_j, 0.04))[sl],
                               rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("threshold,max_kp", [(20, 1024), (40, 256)])
def test_detect_matches(threshold, max_kp):
    img = _frame(256, 512, 1)
    ref = jfast.detect(jnp.asarray(img), max_keypoints=max_kp,
                       threshold=threshold, border=16)
    out = tfast.detect(torch.as_tensor(img), max_keypoints=max_kp,
                       threshold=threshold, border=16)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    np.testing.assert_array_equal(out.uv.numpy()[mask],
                                  np.asarray(ref.uv)[mask])
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score),
                               rtol=1e-5)
    assert mask.sum() > 100


def test_detect_breaks_ties_by_index():
    # a tiled speckle pattern: many corners with identical Harris scores
    cells = np.random.default_rng(2).choice([30, 220], size=(8, 8))
    tile = np.kron(cells, np.ones((2, 2))).astype(np.uint8)
    img = np.tile(tile, (8, 16))
    ref = jfast.detect(jnp.asarray(img), max_keypoints=64, border=16)
    out = tfast.detect(torch.as_tensor(img), max_keypoints=64, border=16)
    assert len(np.unique(np.asarray(ref.score)[np.asarray(ref.mask)])) \
        < int(ref.mask.sum())           # the case really has ties
    np.testing.assert_array_equal(out.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))


def test_cpu_tensors_do_not_count_launches(small):
    _build.reset_launches()
    tfast.detect(torch.as_tensor(small[0]), max_keypoints=64)
    assert _build.LAUNCHES["fast_score"] == 0
    assert _build.LAUNCHES["fast_select"] == 0



def _np_has_run(bits: np.ndarray, n: int) -> np.ndarray:
    """[B, 16] bools -> [B]: some cyclic run of n positions all set."""
    doubled = np.concatenate([bits, bits], axis=1)
    return sliding_window_view(doubled, n, axis=1)[:, :16].all(-1).any(-1)


def _np_has_run_doubled(b: np.ndarray, n: int) -> np.ndarray:
    """The kernel's form of the run test: the field doubled into 32 bits,
    so each rotation is a plain shift."""
    r, covered = b | (b << 16), 1
    while covered < n:
        s = min(covered, n - covered)
        r = r & (r >> s)
        covered += s
    return (r & 0xFFFF) != 0


@pytest.mark.parametrize("n", range(1, 17))
def test_cardinal_pretest_is_exact(n):
    """Over every 16-bit ring field: a cyclic run of n set positions holds
    at least n // 4 of the cardinal positions 0, 4, 8 and 12, so the
    kernel's pre-test never rejects a corner. The port's `_has_run` and
    the kernel's doubled-field form agree with a direct numpy test."""
    b = np.arange(1 << 16)
    bits = (b[:, None] >> np.arange(16)) & 1 == 1
    run = _np_has_run(bits, n)
    np.testing.assert_array_equal(
        fast_cuda._has_run(torch.as_tensor(b), n).numpy(), run)
    np.testing.assert_array_equal(_np_has_run_doubled(b, n), run)
    cardinals = bits[:, [0, 4, 8, 12]].sum(1)
    assert (cardinals[run] >= n // 4).all()
    if n >= 4:                       # and the bound is tight
        assert cardinals[run].min() == n // 4


def test_plain_candidates_match_pallas_interpret(small):
    """Candidates at border 0 are the plain map's non-NEG entries in index
    order, and on the interior the non-NEG entries of the Pallas kernel."""
    img, ref = small
    t = torch.as_tensor(img)
    cand = fast_cuda.fast_candidates(t, border=0, **ARGS)
    n = int(cand.count[0])
    idx = cand.idx[:n].numpy()
    assert cand.idx.dtype == torch.int32 and (np.diff(idx) > 0).all()
    smap = fast_cuda.fast_score_map_plain(t.float(), **ARGS).numpy().ravel()
    np.testing.assert_array_equal(idx, np.flatnonzero(smap > fast_cuda.NEG / 2))
    np.testing.assert_array_equal(cand.score[:n].numpy(), smap[idx])
    H, W = img.shape
    v, u = idx // W, idx % W
    inner = (v >= 16) & (v < H - 16) & (u >= 16) & (u < W - 16)
    ref_flat = ref.ravel()
    interior = np.zeros((H, W), bool)
    interior[16:-16, 16:-16] = True
    ref_idx = np.flatnonzero((ref > pallas_fast.NEG / 2) & interior)
    np.testing.assert_array_equal(idx[inner], ref_idx)
    assert ref_idx.size > 20
    np.testing.assert_allclose(cand.score[:n].numpy()[inner],
                               ref_flat[ref_idx], rtol=1e-5)
    inside = fast_cuda.fast_candidates(t, border=16, **ARGS)
    np.testing.assert_array_equal(inside.idx.numpy(), idx[inner])


def _np_select(score, idx, H, W, k):
    """Top k of the candidates by score descending, ties by lower index;
    then the lowest indices that are not candidates, score 0, mask false."""
    order = np.lexsort((idx, -score.astype(np.float64)))[:k]
    free = np.setdiff1d(np.arange(H * W), idx)[:k - order.size]
    flat = np.concatenate([idx[order], free])
    uv = np.stack([flat % W, flat // W], -1).astype(np.float32)
    top = np.concatenate([score[order], np.zeros(free.size, np.float32)])
    mask = np.arange(k) < order.size
    return uv, top, mask


@pytest.mark.parametrize("n,k,low", [(40, 64, False), (64, 64, False),
                                     (300, 64, False), (40, 64, True),
                                     (300, 256, True)])
def test_selection_contract(n, k, low):
    """Candidates in shuffled order (as the kernel's atomics leave them),
    with many tied scores and a count below, at and above k, select the
    slots of a lexicographic reference; with `low`, candidates sit among
    the lowest indices too, so the masked slots must skip them."""
    H, W = 24, 37
    rng = np.random.default_rng(n + k + low)
    pool = np.arange(H * W) if low else np.arange(5 * W, H * W)
    idx = rng.choice(pool, size=n, replace=False).astype(np.int32)
    score = rng.choice(np.float32([-2.5, 0.0, 1.0, 7.25, 1e6]), size=n)
    score[::7] = -0.0                      # -0 ties with +0, as in the sort
    perm = rng.permutation(n)
    count = torch.tensor([n], dtype=torch.int32)
    uv, top, mask = fast_cuda.select_top_k(
        torch.as_tensor(score[perm]), torch.as_tensor(idx[perm]), count,
        H=H, W=W, k=k)
    ref = _np_select(score, idx, H, W, k)
    np.testing.assert_array_equal(uv.numpy(), ref[0])
    np.testing.assert_array_equal(top.numpy(), ref[1])
    np.testing.assert_array_equal(mask.numpy(), ref[2])
    assert len(np.unique(score)) < min(n, k)     # the case has ties


@pytest.mark.parametrize("max_kp,border", [(64, 16), (700, 16), (4096, 16),
                                           (512, 0), (64, 3)])
def test_detect_equals_the_sort_of_the_map(small, max_kp, border):
    """`detect` in every slot, masked ones included, against the stable
    sort of the whole score map with -inf off the candidates (the plain
    detection before candidates and selection were split)."""
    t = torch.as_tensor(small[0])
    H, W = t.shape
    kp = tfast.detect(t, max_keypoints=max_kp, border=border, threshold=20,
                      arc_length=12, nms_radius=3, harris_k=0.04)
    smap = fast_cuda.fast_score_map(t.float(), **ARGS)
    inside = torch.zeros((H, W), dtype=torch.bool)
    inside[border:H - border, border:W - border] = True
    flat = torch.where((smap > fast_cuda.NEG / 2) & inside, smap,
                       -torch.inf).reshape(-1)
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:max_kp], idx[:max_kp]
    mask = torch.isfinite(top)
    assert torch.equal(kp.mask, mask)
    assert torch.equal(kp.score, torch.where(mask, top, 0.0))
    assert torch.equal(kp.uv, torch.stack([idx % W, idx // W], -1).float())
