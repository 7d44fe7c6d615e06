"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. The card's machine has
no JAX, which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

from the repository root (the kernel checks and their tolerances are
`ya_vo_tpu_torch/selfcheck.py`'s). This file imports no JAX. Also here: the
card's float64 8-point null vector (geometry/epipolar.py), alone and in the
textured world's bootstrap against a float64 solve on the CPU, the
CPU-side contract of the wrappers (a CPU tensor takes the plain version and
launches nothing), and the distributed window BA with its shards on one
card (chip_smoke.py phase 12 (a) and (c) at a small size, and the sharded
solve on the backend stream).
"""

import json

import numpy as np
import pytest
import torch

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.features import fast, fast_cuda, hamming_cuda, matching
from ya_vo_tpu_torch.geometry import epipolar, ransac
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.utils.scene import TexturedSequence


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the docstring)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames():
    imgs, *_ = synthetic.render_sequence(n_frames=2, n_landmarks=400,
                                         height=192, width=640, step=0.5,
                                         seed=3)
    return [torch.as_tensor(i) for i in imgs]


FAST = dict(threshold=20.0, arc_length=12, harris_k=0.04, nms_radius=3)


@pytest.fixture(scope="module")
def big():
    """A 376x1241 frame of the main path's sequence, and uniform noise."""
    imgs, *_ = synthetic.render_sequence(**{**synthetic.STAMPS,
                                               "n_frames": 1})
    noise = np.random.default_rng(5).integers(0, 256, (256, 512), np.uint8)
    return torch.as_tensor(imgs[0]), torch.as_tensor(noise)


def _ragged(big, size):
    """A crop of the big frame: 192x640, 193x641 (odd rows, odd width), and
    40x70, smaller than one 32x64 tile plus its halo."""
    h, w = size
    return big[0][150:150 + h, 300:300 + w].contiguous()


def assert_fast_exact(img, cuda, border=16, **args):
    """The kernel against its plain version: the score map (border 0) bit
    for bit on the whole frame, edges included, and the candidates inside
    `border` as a set, scores bit for bit."""
    plain = fast_cuda.fast_score_map(img, **args)
    kern = fast_cuda.fast_score_map(img.to(cuda), **args).cpu()
    assert torch.equal(kern, plain)
    p = fast_cuda.fast_candidates(img, border=border, **args)
    k = fast_cuda.fast_candidates(img.to(cuda), border=border, **args)
    n = int(k.count)
    assert n == int(p.count)
    idx, order = k.idx[:n].cpu().sort()
    assert torch.equal(idx, p.idx)
    assert torch.equal(k.score[:n].cpu()[order], p.score)
    return int((plain > fast_cuda.NEG / 2).sum())


@pytest.mark.cuda
def test_fast_score_kernel_matches_plain(cuda, frames):
    """Bit for bit on the whole frame (-fmad=false, the plain version's
    order of operations): the map at border 0, candidates at border 16."""
    assert assert_fast_exact(frames[0], cuda, **FAST) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("arc_length", [9, 12])
@pytest.mark.parametrize("nms_radius", [0, 1, 2, 3])
@pytest.mark.parametrize("size", [(192, 640), (193, 641), (40, 70)])
def test_fast_candidates_kernel_exact(cuda, big, size, nms_radius,
                                      arc_length):
    args = dict(FAST, nms_radius=nms_radius, arc_length=arc_length)
    assert assert_fast_exact(_ragged(big, size), cuda, border=4, **args) > 0


@pytest.mark.cuda
def test_fast_kernels_on_noise_and_plateaus(cuda, big):
    """Uniform noise (corners at most pixels; at radius 0 its candidates
    overflow `fast_select`'s shared-memory path) and the tie-plateau
    speckle of test_detect_breaks_ties_by_index: both kernels exact."""
    cells = np.random.default_rng(2).choice([30, 220], size=(8, 8))
    tile = np.kron(cells, np.ones((2, 2))).astype(np.uint8)
    speckle = torch.as_tensor(np.tile(tile, (8, 16)))
    for img in (big[1], speckle):
        for r in (0, 3):
            assert_fast_exact(img, cuda, **dict(FAST, nms_radius=r))
            for k in (64, 2048):
                assert_detect_equal(img, cuda, max_keypoints=k,
                                    nms_radius=r, threshold=20)
    n0 = fast_cuda.fast_candidates(big[1].to(cuda), border=16,
                                   **dict(FAST, nms_radius=0)).count
    assert int(n0) > fast_cuda.MAX_SELECT_K


def assert_detect_equal(img, cuda, **kw):
    """`detect` on the card equals `detect` on the CPU in every slot."""
    kp_c = fast.detect(img, **kw)
    kp_k = fast.detect(img.to(cuda), **kw)
    for a, b in zip(kp_k, kp_c):
        assert torch.equal(a.cpu(), b)
    return int(kp_c.mask.sum())


@pytest.mark.cuda
def test_detect_on_card_equals_cpu(cuda, big):
    """The main path's frame and parameters, with the count below K, at K
    and above K; two launches a call."""
    img = big[0]
    kw = dict(threshold=20, arc_length=12, nms_radius=3, border=16,
              harris_k=0.04)
    n = int(fast_cuda.fast_candidates(img, border=16, **FAST).count)
    assert 2048 < n < fast_cuda.MAX_SELECT_K
    for k in (2048, n, n + 500):
        _build.reset_launches()
        got = assert_detect_equal(img, cuda, max_keypoints=k, **kw)
        assert got == min(k, n)
        assert _build.LAUNCHES["fast_score"] == 1
        assert _build.LAUNCHES["fast_select"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,low", [(1000, 2048, False), (2048, 2048, False),
                                     (5000, 2048, False), (3000, 4096, True),
                                     (20000, 2048, False),
                                     (20000, 8192, True)])
def test_fast_select_kernel_matches_plain(cuda, n, k, low):
    """Shuffled candidates with tied scores, count below, at and above k,
    and past the shared-memory path (20,000 > 8,192 keys); with `low`,
    candidates among the lowest indices, so masked slots skip them."""
    H, W = 376, 1241
    rng = np.random.default_rng(n + k)
    lo = 0 if low else 16 * W
    idx = rng.choice(np.arange(lo, H * W), size=n, replace=False)
    score = rng.choice(np.float32([-3e5, -0.0, 0.0, 2.5, 1e9]), size=n)
    score[::3] = rng.normal(0, 1e6, size=len(score[::3]))
    cand = (torch.as_tensor(score, dtype=torch.float32),
            torch.as_tensor(idx, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32))
    plain = fast_cuda.select_top_k(*cand, H=H, W=W, k=k)
    kern = fast_cuda.select_top_k(*(t.to(cuda) for t in cand), H=H, W=W, k=k)
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_hamming_kernel_exact(cuda):
    gen = torch.Generator().manual_seed(2)
    d1, d2 = (torch.randint(-2 ** 31, 2 ** 31, (k, 8), generator=gen,
                            dtype=torch.int64).to(torch.int32)
              for k in (300, 701))
    kern = hamming_cuda.hamming_matrix(d1.to(cuda), d2.to(cuda)).cpu()
    assert torch.equal(kern, hamming_cuda.hamming_matrix(d1, d2))


@pytest.mark.cuda
def test_lk_kernel_matches_plain(cuda, frames):
    """selfcheck's K1 check at a smaller size on FAST corners with seeds
    moved by up to a few px, border clamps and dead slots among them: the
    kernel with a one-level table, level by level on identical inputs,
    positions within LK_UV_TOL px and eig, res and std within LK_ATOL +
    LK_RTOL |plain|, dead slots equal; then the whole tracker in one launch,
    status equal keypoint by keypoint (LK_FLIPS and LK_TRACK_FRAC as
    selfcheck.py states them)."""
    kp = fast.detect(frames[0], max_keypoints=256)
    rng = np.random.default_rng(0)
    seed = kp.uv + torch.as_tensor(rng.normal(0, 1.0, size=(256, 2)),
                                   dtype=torch.float32)
    mask = kp.mask & torch.as_tensor(rng.random(256) > 0.1)
    cases = sc.lk_edge_cases(kp.uv, seed, mask, 192, 640)
    per_level, _, tracker = sc.compare_lk(
        *(t.to(cuda) for t in (frames[0].float(), frames[1].float(),
                               *cases)))
    assert not sc.lk_problems(per_level, tracker)
    assert tracker["status_plain"] > 100


@pytest.mark.cuda
def test_lk_tracker_is_one_launch(cuda, frames):
    """One tracker call launches the kernel once, whatever the levels."""
    uv = torch.full((64, 2), 100.0, device=cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    for levels in (1, 3, 4):
        _build.reset_launches()
        lk_cuda.track(frames[0].to(cuda), frames[1].to(cuda), uv, uv, mask,
                      levels=levels)
        assert _build.LAUNCHES["lk_level"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1, 4, 12, 16])
def test_hamming_kernel_exact_other_lengths(cuda, n_words):
    """Descriptors shorter than 256 bits are zero-padded to the kernel's
    8 words, longer ones take its 16-word instance; ragged shapes."""
    gen = torch.Generator().manual_seed(n_words)
    d1, d2 = (torch.randint(-2 ** 31, 2 ** 31, (k, n_words), generator=gen,
                            dtype=torch.int64).to(torch.int32)
              for k in (77, 130))
    kern = hamming_cuda.hamming_matrix(d1.to(cuda), d2.to(cuda)).cpu()
    assert torch.equal(kern, hamming_cuda.hamming_matrix(d1, d2))


# seeded pose problems (selfcheck.pose_gn_problem): 2048, 1000 and 37
# points with 5% outliers, 10% mask holes and 8 points behind the camera,
# and 3000 (past the 2048 the kernel holds in registers); every point
# masked out; two valid points
POSE_CASES = {"n2048": dict(), "n1000": dict(n=1000, seed=1),
              "n37": dict(n=37, seed=2), "n3000": dict(n=3000, seed=4),
              "all_masked": dict(n_valid=0),
              "two_valid": dict(n_valid=2, seed=3)}


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 3, 40])
@pytest.mark.parametrize("case", list(POSE_CASES))
def test_pose_gn_kernel_matches_plain(cuda, case, iters):
    """K4 against `solve_pose_plain` on the card at selfcheck's
    tolerances (`pose_gn_parity`, which also holds two kernel calls bit
    for bit; the all-masked and two-point problems are degenerate, their
    pose set by float32 rounding along H's null space, and are held to
    what they determine, with a third call for the first step): one
    launch a call."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device=cuda,
                                                  **POSE_CASES[case])
    _build.reset_launches()
    out = sc.pose_gn_parity(T, pts, uv, mask, cam, iters=iters)
    print(f"pose_gn {case} iters={iters}: {json.dumps(out)}")
    assert _build.LAUNCHES["pose_gn"] == (3 if out["degenerate"] else 2)
    assert out["iterations"] <= iters
    assert out["degenerate"] == (case in ("all_masked", "two_valid"))
    if case == "all_masked":
        assert out["iterations"] == 1 and out["max_abs_err"] == 0.0
    if case == "two_valid":
        # not the kernel's doing: the plain version on the card and on the
        # CPU part along H's null space as well
        card = pose_solver.solve_pose_plain(T, pts, uv, mask, cam,
                                            iters=iters)
        cpu = pose_solver.solve_pose_plain(
            *(t.cpu() for t in (T, pts, uv, mask)), cam, iters=iters)
        d = (card.pose.cpu() - cpu.pose).abs().max().item()
        print(f"pose_gn two_valid iters={iters}: the plain version on the "
              f"card against the CPU's, pose {d}")


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [1, 2])
def test_pose_gn_degenerate_problems_over_seeds(cuda, n_valid):
    """Degenerate problems (one or two valid points of 2048) on 20 seeds
    at `iters` 1, 3 and 40, each held by `pose_gn_parity` (every first
    step that the guard did not zero solves the linear model on the valid
    points; no final cost above the cost at T_init). Rounding along H's
    null space decides whether the guard zeroes a step, so a problem's
    first step may be zeroed in one version and taken in the other; K4
    must take it on at least half the problems where the plain version
    does (a kernel that never steps fails). Prints each problem and the
    ranges of K4 against the plain version on the card, and of that
    against the plain version on the CPU."""
    rows = []
    for seed in range(20):
        T, pts, uv, mask, cam = sc.pose_gn_problem(device=cuda,
                                                      n_valid=n_valid,
                                                      seed=seed)
        for iters in (1, 3, 40):
            out = sc.pose_gn_parity(T, pts, uv, mask, cam, iters=iters)
            card = pose_solver.solve_pose_plain(T, pts, uv, mask, cam,
                                                iters=iters, with_iters=True)
            cpu = pose_solver.solve_pose_plain(
                *(t.cpu() for t in (T, pts, uv, mask)), cam, iters=iters,
                with_iters=True)
            out.update(seed=seed, iters=iters,
                       iterations_cpu=int(cpu[1]),
                       card_cpu_pose_err=(card[0].pose.cpu()
                                          - cpu[0].pose).abs().max().item(),
                       n_inliers_cpu=int(cpu[0].n_inliers))
            print(f"pose_gn degenerate n_valid={n_valid}: {json.dumps(out)}")
            rows.append(out)
    firsts = [r for r in rows if r["iters"] == 1]
    taken = {v: sum(r[f"first_step_{v}"] != "zero" for r in firsts)
             for v in ("kernel", "plain")}
    lin = [r[f"first_step_{v}"] for r in firsts for v in ("kernel", "plain")
           if r[f"first_step_{v}"] != "zero"]
    summary = dict(
        n_valid=n_valid, problems=len(rows), first_steps_taken=taken,
        first_step_res_max=max(lin),
        first_step_res_rel_max=max(
            r[f"first_step_{v}"] / r["res_init"] for r in firsts
            for v in ("kernel", "plain") if r[f"first_step_{v}"] != "zero"),
        guard_flips=sum((r["first_step_kernel"] == "zero")
                        != (r["first_step_plain"] == "zero")
                        for r in firsts),
        pose_err_max=max(r["max_abs_err"] for r in rows),
        card_cpu_pose_err_max=max(r["card_cpu_pose_err"] for r in rows),
        iterations_off_max=max(abs(r["iterations"] - r["iterations_plain"])
                               for r in rows),
        card_cpu_iterations_off_max=max(
            abs(r["iterations_plain"] - r["iterations_cpu"]) for r in rows),
        n_inliers_off_max=max(abs(r["n_inliers"] - r["n_inliers_plain"])
                              for r in rows),
        card_cpu_n_inliers_off_max=max(
            abs(r["n_inliers_plain"] - r["n_inliers_cpu"]) for r in rows))
    print(f"pose_gn degenerate summary: {json.dumps(summary)}")
    assert taken["kernel"] >= taken["plain"] / 2


# the recorded cases of `selfcheck.pose_gn_golden_cases` by problem: N on
# both sides of a 2048-point round and past two rounds, every point masked
# out and no point at all, the degenerate one- and two-point problems, a
# real step's inputs and the solves that ran to the 40-iteration cap
POSE_GOLDEN_GROUPS = {
    "n37": ["n37_"], "n1000": ["n1000_"], "n1792": ["n1792_"],
    "n2048": ["n2048_"], "n2049": ["n2049_"], "n3000": ["n3000_"],
    "n6000": ["n6000_"], "empty": ["all_masked_", "n0_"],
    "degenerate": ["valid1_", "valid2_"], "real_step": ["step_"],
    "capped": ["capped_"]}


@pytest.mark.cuda
@pytest.mark.parametrize("group", list(POSE_GOLDEN_GROUPS))
def test_pose_gn_kernel_equals_recorded_outputs(cuda, group):
    """K4 bit for bit against the outputs recorded from the first K4 (one
    block of 256 threads; tests/torch_data/pose_gn/golden.npz): pose,
    inlier mask, n_inliers, final_cost and iterations at `iters` 1, 3 and
    40, one launch a call, each call under `selfcheck.sync_within`'s
    timeout."""
    out = sc.check_pose_gn_goldens(prefixes=POSE_GOLDEN_GROUPS[group])
    print(f"pose_gn goldens {group}: {json.dumps(out)}")
    assert out["cases"] >= 3 and out["launches"] == out["cases"]


@pytest.mark.cuda
def test_pose_gn_reads_views_on_the_callers_stream(cuda):
    """Views that are not contiguous (the frontend hands the kernel slices
    of its tables) give the contiguous inputs' result bit for bit, and a
    call on a side stream (the backend BA thread's case) equals one on
    the default stream."""
    T, pts, uv, mask, cam = sc.pose_gn_problem(device=cuda)
    n = len(mask)
    ref = pose_solver.solve_pose(T, pts, uv, mask, cam)
    wide = torch.zeros((n, 5), device=cuda)
    wide[:, 1:4] = pts
    uv_t = uv.T.contiguous().T
    mask2 = torch.zeros(2 * n, dtype=torch.bool, device=cuda)
    mask2[::2] = mask
    T_t = T.T.contiguous().T
    assert not any(t.is_contiguous() for t in (wide[:, 1:4], uv_t,
                                               mask2[::2], T_t))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pose_solver.solve_pose(T_t, wide[:, 1:4], uv_t, mask2[::2],
                                     cam)
        sc.sync_within("pose_gn on a side stream")
    torch.cuda.current_stream().wait_stream(side)
    assert all(sc.bits_equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_wrappers_raise_on_bad_cuda_input(cuda):
    img = torch.zeros((64, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="torch.uint8"):
        fast_cuda.fast_score_map(img, **FAST)
    score = torch.zeros(16, device=cuda)
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        fast_cuda.select_top_k(score, idx, count, H=376, W=1241,
                               k=fast_cuda.MAX_SELECT_K + 1)
    d = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_matrix(d, d[:, :4].contiguous())
    d17 = torch.zeros((8, 17), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1 to 16"):
        hamming_cuda.hamming_matrix(d17, d17)
    pyr = [torch.zeros((64, 64), device=cuda)] * 5
    uv = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        lk_cuda.track_pyramids(pyr, pyr, uv, uv,
                               torch.ones(4, dtype=torch.bool, device=cuda))
    T, pts, uv_p, mask_p, cam = sc.pose_gn_problem(n=64, device=cuda)
    with pytest.raises(ValueError, match="torch.float32"):
        pose_solver.solve_pose(T.double(), pts, uv_p, mask_p, cam)
    with pytest.raises(ValueError, match="torch.bool"):
        pose_solver.solve_pose(T, pts, uv_p, mask_p.to(torch.uint8), cam)


@pytest.mark.cuda
def test_eight_point_null_vector_in_float64_on_the_card(cuda, monkeypatch):
    """On the card the 8-point null vector is solved in float64 (the
    card's float32 eigh bent the textured world's bootstrap; see
    geometry/epipolar.py); F comes back float32, unit norm and rank 2."""
    rng = np.random.default_rng(0)
    uv1 = torch.as_tensor(rng.uniform(0, 1241, (4, 300, 2)),
                          dtype=torch.float32)
    uv2 = uv1 + torch.as_tensor(rng.normal(0, 2, (4, 300, 2)),
                                dtype=torch.float32)
    mask = torch.ones((4, 300), dtype=torch.bool)
    seen = []
    eigh = torch.linalg.eigh

    def spy(M):
        seen.append(M.dtype)
        return eigh(M)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    F = epipolar.eight_point(uv1.to(cuda), uv2.to(cuda), mask.to(cuda))
    assert seen == [torch.float64] and F.dtype == torch.float32
    F = F.cpu().double()
    assert torch.allclose(F.flatten(1).norm(dim=1),
                          torch.ones(4, dtype=torch.float64))
    assert torch.linalg.det(F).abs().max() < 1e-6


# The bootstrap of bench.py's textured world on the card against the same
# two-view problem solved in float64 on the CPU. With the card's float32
# eigh for the 8-point null vector the bootstrap translation sat 0.030 from
# the float64 solve, with LAPACK's float32 on the CPU 0.00056
# (geometry/epipolar.py): BOOT_TOL lies between the two, and holds R and t
# entry by entry and the refit F (unit norm, up to sign).
BOOT_TOL = 5e-3


def _f_err(a, b):
    """Largest entry difference of F [..., 3, 3] up to sign."""
    d = (a - b).abs().amax((-2, -1))
    return torch.minimum(d, (a + b).abs().amax((-2, -1)))


def _bootstrap(uv1, uv2, mask, K, idx, device, dtype):
    rc = VOConfig().ransac
    return ransac.estimate_two_view(
        uv1.to(device, dtype), uv2.to(device, dtype), mask.to(device),
        K.to(device, dtype), sample_idx=idx.to(device),
        n_hypotheses=rc.n_hypotheses, sample_size=rc.sample_size,
        inlier_threshold_px=rc.inlier_threshold_px)


def _boot_errors(uv1, uv2, mask, K, idx, ref, device) -> dict:
    """The bootstrap in float32 on `device` (the frontend's path) and its
    refit F on the reference's inliers, against the float64 solve `ref`."""
    got = _bootstrap(uv1, uv2, mask, K, idx, device, torch.float32)
    uv1, uv2, idx = uv1.to(device), uv2.to(device), idx.to(device)
    F = epipolar.eight_point(uv1, uv2, ref.inlier_mask.to(device))
    F_ref = epipolar.eight_point(uv1.cpu().double(), uv2.cpu().double(),
                                 ref.inlier_mask)
    ones = torch.ones(idx.shape, dtype=torch.bool)
    F_hyp = epipolar.eight_point(uv1[idx], uv2[idx], ones.to(device))
    F_hyp_ref = epipolar.eight_point(uv1.cpu().double()[idx.cpu()],
                                     uv2.cpu().double()[idx.cpu()], ones)
    hyp = _f_err(F_hyp.cpu().double(), F_hyp_ref)
    return dict(
        R=float((got.R.cpu().double() - ref.R).abs().max()),
        t=float((got.t.cpu().double() - ref.t).abs().max()),
        F_refit=float(_f_err(F.cpu().double(), F_ref)),
        F_hyp_median=float(hyp.median()), F_hyp_max=float(hyp.max()),
        n_inliers=int(got.n_inliers), n_inliers_ref=int(ref.n_inliers),
        inliers_differ=int((got.inlier_mask.cpu()
                            != ref.inlier_mask).sum()))


@pytest.mark.cuda
def test_bootstrap_on_the_card_agrees_with_a_float64_solve(cuda,
                                                           monkeypatch):
    """Frames 0 and 1 of `TexturedSequence(n_frames=410, seed=5)` rendered
    on the card at 376x1241, extracted and matched as the frontend's
    bootstrap does, with its first RANSAC draw: R, t and the refit F
    within BOOT_TOL of a float64 solve on the CPU from the same matches
    and draw. Prints the errors, and as readings only (not held) those
    of the CPU's float32 path (LAPACK's eigh) and of the card's float32
    eigh in place of the float64 null vector."""
    seq = TexturedSequence(n_frames=410, seed=5, device=cuda)
    cfg = VOConfig()
    fe = create_frontend(cfg, seq.cam, device=cuda)
    kp0, d0 = fe._extract(seq.frame(0))
    kp1, d1 = fe._extract(seq.frame(1))
    m = matching.match(d0, d1, kp0.mask, kp1.mask,
                       abs_threshold=cfg.matching.abs_threshold,
                       cross_check=cfg.matching.cross_check)
    uv1, uv2, K = kp0.uv, kp1.uv[m.idx2], fe.K
    rc = cfg.ransac
    idx = ransac.sample_indices(torch.Generator().manual_seed(rc.seed),
                                rc.n_hypotheses, rc.sample_size, m.mask)
    ref = _bootstrap(uv1, uv2, m.mask, K, idx, "cpu", torch.float64)
    err = _boot_errors(uv1, uv2, m.mask, K, idx, ref, cuda)
    err_cpu = _boot_errors(uv1, uv2, m.mask, K, idx, ref,
                           torch.device("cpu"))
    monkeypatch.setattr(epipolar, "_null_vector",
                        lambda M: torch.linalg.eigh(M)[1][..., :, 0])
    err_f32 = _boot_errors(uv1, uv2, m.mask, K, idx, ref, cuda)
    print("bootstrap vs float64: " + json.dumps(dict(
        n_matches=int(m.count()), card=err, cpu_float32=err_cpu,
        card_float32_eigh=err_f32)))
    assert max(err["R"], err["t"], err["F_refit"]) <= BOOT_TOL, err


def test_cpu_tensors_take_the_plain_versions(frames):
    _build.reset_launches()
    fast_cuda.fast_score_map(frames[0], **FAST)
    cand = fast_cuda.fast_candidates(frames[0], border=16, **FAST)
    fast_cuda.select_top_k(*cand, H=192, W=640, k=64)
    d = torch.zeros((4, 8), dtype=torch.int32)
    hamming_cuda.hamming_matrix(d, d)
    uv = torch.full((8, 2), 50.0)
    mask = torch.ones(8, dtype=bool)
    lk_cuda.track(frames[0], frames[1], uv, uv, mask)
    pyr = lk_cuda.build_pyramid(frames[0].float(), 3)
    lk_cuda.track_pyramids(pyr, pyr, uv, uv, mask)
    lk_cuda.track_level(pyr[0], pyr[0], uv, uv, mask, iters=30, eps=0.01)
    T, pts, uv_p, mask_p, cam = sc.pose_gn_problem(n=64, device="cpu")
    pose_solver.solve_pose(T, pts, uv_p, mask_p, cam)
    pose_solver.solve_pose(T, pts, uv_p, mask_p, cam, with_iters=True)
    assert _build.LAUNCHES == {"fast_score": 0, "fast_select": 0,
                               "hamming": 0, "lk_level": 0, "pose_gn": 0}


def test_lk_level_table_from_pyramids(frames):
    """The kernel's by-value level table: each level's pointers, size and
    padded size, level 0 first; 1 to MAX_LK_LEVELS levels of equal sizes in
    both pyramids, else it raises."""
    pyr0 = lk_cuda.build_pyramid(frames[0].float(), 4)
    pyr1 = lk_cuda.build_pyramid(frames[1].float(), 4)
    lv = lk_cuda.level_descriptors(pyr0, pyr1)
    assert lv.n == 4 == _build.MAX_LK_LEVELS
    assert [(lv.H[i], lv.W[i]) for i in range(4)] == [
        (192, 640), (96, 320), (48, 160), (24, 80)]
    assert [(lv.Hp[i], lv.Wp[i]) for i in range(4)] == [
        lk_cuda.padded_size(lv.H[i], lv.W[i]) for i in range(4)] == [
        (192, 640), (96, 384), (48, 256), (32, 256)]
    assert [lv.img0[i] for i in range(4)] == [p.data_ptr() for p in pyr0]
    assert [lv.img1[i] for i in range(4)] == [p.data_ptr() for p in pyr1]
    assert lk_cuda.level_descriptors(pyr0[:1], pyr1[:1]).n == 1
    five = pyr0 + (pyr0[-1][::2, ::2].contiguous(),)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        lk_cuda.level_descriptors(five, five)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        lk_cuda.level_descriptors(pyr0, pyr1[:3])
    with pytest.raises(ValueError, match="shapes"):
        lk_cuda.level_descriptors(pyr0[:2], (pyr1[0], pyr1[0]))


def test_lk_plain_iteration_counts(frames):
    """The plain tracker's per-keypoint iteration counts (a flag the main
    path never sets) leave its outputs as they are: at most `iters` a
    level, 0 on dead slots, and one level's counts agree with the level
    solve's."""
    kp = fast.detect(frames[0], max_keypoints=64)
    rng = np.random.default_rng(1)
    seed = kp.uv + torch.as_tensor(rng.normal(0, 2.0, size=(64, 2)),
                                   dtype=torch.float32)
    mask = kp.mask.clone()
    mask[::7] = False
    pyr0 = lk_cuda.build_pyramid(frames[0].float(), 3)
    pyr1 = lk_cuda.build_pyramid(frames[1].float(), 3)
    flow = lk_cuda.track_pyramids_plain(pyr0, pyr1, kp.uv, seed, mask)
    flow_i, iters = lk_cuda.track_pyramids_plain(pyr0, pyr1, kp.uv, seed,
                                                 mask, with_iters=True)
    for a, b in zip(flow, flow_i):
        assert torch.equal(a, b)
    assert iters.shape == (3, 64) and iters.dtype == torch.int64
    assert int(iters.min()) >= 0 and int(iters.max()) <= 30
    assert (iters[:, ~mask] == 0).all() and (iters[:, mask] >= 1).all()
    *out, n = lk_cuda.track_level_plain(pyr0[2], pyr1[2],
                                        (kp.uv / 4).contiguous(),
                                        (seed / 4).contiguous(), mask,
                                        iters=30, eps=0.01, with_iters=True)
    assert torch.equal(n, iters[0])
    for a, b in zip(out, lk_cuda.track_level_plain(
            pyr0[2], pyr1[2], (kp.uv / 4).contiguous(),
            (seed / 4).contiguous(), mask, iters=30, eps=0.01)):
        assert torch.equal(a, b)


def test_profile_busy_time_counts_overlaps_once():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from ya_vo_tpu_torch.profile_slice import busy_us

    def ev(a, b, dev=DeviceType.CUDA):
        return NS(time_range=NS(start=a, end=b), device_type=dev)

    events = [ev(0, 10), ev(5, 12), ev(20, 25), ev(0, 100, DeviceType.CPU)]
    assert busy_us(events) == (22, 17)


def test_build_is_keyed_by_sources():
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert path.name == "libyavo_kernels.so"
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "fast_score.cu", "fast_select.cu", "hamming.cu", "lk_level.cu",
        "pose_gn.cu"]
    assert [f"{k}.cu" for k in _build.KERNELS] == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))


def _backend_vs_default_stream(device):
    """A window problem of the stamps world's first 12 frames at
    VOConfig() with asynchronous BA, built while the card's default stream
    is still busy (a ~0.1 s spin queued ahead of the problem's uploads),
    solved by the frontend's backend worker on its own stream after the
    frontend stream's event, then on the calling thread's stream. Returns
    both ((poses, landmarks), ms) and the worker's stream."""
    import dataclasses

    imgs, *_, cam = synthetic.render_sequence(
        **dict(synthetic.STAMPS, n_frames=12))
    cfg = VOConfig()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, asynchronous=True))
    fe = create_frontend(cfg, cam, device=device)
    for img in imgs:
        fe.process(img)
    fe.finish()
    ready = None
    if fe.device.type == "cuda":
        torch.cuda._sleep(200_000_000)
    job = fe._build_window_problem()
    assert job is not None
    if fe.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    side = fe._ba_executor.submit(fe._solve_on_backend, job[0], ready)
    return side.result(timeout=120), fe._solve(job[0]), fe._ba_stream


@pytest.mark.cuda
def test_backend_stream_solve_equals_default_stream(cuda):
    """Asynchronous window BA solves on a side stream from the worker
    thread; the solve is bit-reproducible, so the side-stream result equals
    the default-stream one bit for bit (a missing wait on the frontend
    stream's event would read the problem before its uploads landed)."""
    (side, _), (default, _), stream = _backend_vs_default_stream(cuda)
    assert stream is not None and stream != torch.cuda.default_stream()
    for a, b in zip(side, default):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _small_window(cuda):
    """A window of 512 landmarks and 4 keyframes on the card, the live
    backend's solve settings, and 1- and 4-shard solvers on cuda:0."""
    from chip_smoke import card_mesh
    from ya_vo_tpu_torch.parallel import dist_ba, scaling_bench

    bc = VOConfig().ba
    kw = dict(iters=bc.iters, huber_delta=bc.huber_delta,
              damping=bc.damping, n_fixed_poses=2,
              pose_prior_weight=bc.pose_prior_weight)
    cam = synthetic.kitti_camera()
    prob = scaling_bench.window_problem(512, 4, device=cuda)
    solve = {n: dist_ba.make_dist_solver(card_mesh(n), cam, **kw)
             for n in (1, 4)}
    return prob, dist_ba.from_window_problem(prob), cam, kw, solve


@pytest.mark.cuda
def test_dist_solver_on_the_card(cuda):
    """Phase 12 (a) of chip_smoke.py at a small size: the landmark-sharded
    solver reads nothing back to the host inside a solve (sync debug mode
    "error"); 4 shards on cuda:0 against 1 within 1e-4 in poses, rtol 1e-4
    in costs and 5e-2 px in reprojections; both within 5e-3 of
    `solve_window` run for the same iterations; a second 4-shard solve bit
    for bit."""
    from chip_smoke import _reprojection_px, _solution
    from ya_vo_tpu_torch.ba import window as ba_window

    prob, dprob, cam, kw, solve = _small_window(cuda)
    for s in solve.values():
        s(dprob)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = {n: s(dprob) for n, s in solve.items()}
        again = solve[4](dprob)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    one, four = _solution(out[1]), _solution(out[4])
    assert float((four[0] - one[0]).abs().max()) <= 1e-4
    for i in (2, 3):
        assert abs(float(out[4][i]) - float(out[1][i])) \
            <= 1e-4 * float(out[1][i])
    assert _reprojection_px(dprob, cam, one, four) <= 5e-2
    sw = ba_window.solve_window(prob, cam, rel_tol=-1.0, **kw)
    for sol in (one, four):
        assert float((sol[0] - sw.poses).abs().max()) <= 5e-3
    again = _solution(again)
    assert sc.bits_equal(again[0], four[0])
    assert sc.bits_equal(again[1], four[1])


@pytest.mark.cuda
def test_dist_solver_through_an_nccl_group(cuda):
    """Phase 12 (c) at a small size: through `init_multihost` with a
    127.0.0.1 coordinator and one process (NCCL for the CUDA tensors), the
    4-shard solve all-reduces and equals the local one bit for bit; the
    group is destroyed after."""
    import socket

    import torch.distributed as dist

    from chip_smoke import _solution
    from ya_vo_tpu_torch.parallel import mesh as mesh_lib

    _, dprob, _, _, solve = _small_window(cuda)
    local = _solution(solve[4](dprob))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    mesh_lib.init_multihost(f"127.0.0.1:{port}", num_processes=1,
                            process_id=0)
    try:
        assert mesh_lib.is_distributed_initialized()
        grouped = _solution(solve[4](dprob))
    finally:
        dist.destroy_process_group()
    assert not mesh_lib.is_distributed_initialized()
    assert sc.bits_equal(grouped[0], local[0])
    assert sc.bits_equal(grouped[1], local[1])


@pytest.mark.cuda
def test_sharded_backend_stream_solve_equals_default_stream(cuda):
    """`test_backend_stream_solve_equals_default_stream` with the frontend
    built over 4 shards on cuda:0 (`landmark_mesh` as chip_smoke.py phase
    12 gives it): the sharded solve on the backend worker's stream equals
    the one on the calling thread's stream bit for bit."""
    from chip_smoke import shards_on_card

    with shards_on_card():
        (side, _), (default, _), stream = _backend_vs_default_stream(cuda)
    assert stream is not None and stream != torch.cuda.default_stream()
    for a, b in zip(side, default):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
