"""K5 (`ya_vo_tpu_torch/csrc/window_gn.cu`, the window BA's GN loop) on
the card.

These tests need a CUDA device and skip without one. The card's machine has
no JAX, which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -q tests/test_torch_window_gn_card.py

from the repository root. This file imports no JAX. `solve_window` on the
card is one K5 launch a solve; it is held, at `selfcheck`'s tolerances
(tests/test_torch_ba.py's `compare`), to JAX's recorded solve of every
golden (tests/torch_data/window_gn, recorded by
tests/test_torch_window_gn.py) with JAX's iteration count, and to
`solve_window_plain` on the same CUDA problem; two calls give the same
bits; no host read happens between the problem's upload and the result
(sync debug mode "error"); W = 16, W = 2, one pinned pose and zero
iterations run; K5 gives, bit for bit, the outputs the first K5 recorded
on every case of tests/torch_data/window_gn/k5_bits.npz; and a
`VOConfig()` frontend solves its windows through one K5 launch each.
"""

import json

import pytest
import torch

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch import selfcheck as sc
from ya_vo_tpu_torch.ba import window as ba_window
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.parallel import scaling_bench
from ya_vo_tpu_torch.utils import synthetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sc.WINDOW_CASES)
def test_k5_matches_jax_goldens_and_the_plain_version(cuda, name):
    """K5 against JAX's recorded solve (JAX's iterations), one launch a
    solve; then against `solve_window_plain` on the card, two K5 calls bit
    for bit."""
    golden = sc.check_window_gn_goldens(cases=(name,))[name]
    prob, cam, kw, _ = sc.load_window_case(name, cuda)
    parity = sc.window_gn_parity(prob, cam, **kw)
    assert parity["launches_a_call"] == 1
    print(f"window_gn {name}: " + json.dumps(dict(golden=golden,
                                                  plain=parity)))


@pytest.mark.cuda
def test_k5_reads_nothing_back_inside_a_solve(cuda):
    """The layout's sort and search, the workspace and the launch, under
    sync debug mode "error"; the result is read after."""
    prob, cam, kw, ref = sc.load_window_case("full_width", cuda)
    ba_window.solve_window(prob, cam, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ba_window.solve_window(prob, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.n_iters.is_cuda and res.n_iters.dtype == torch.int32
    assert int(res.n_iters) == int(ref["n_iters"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sc.WINDOW_SHAPES)
def test_k5_other_shapes(cuda, name):
    """K5 against the plain version at W = 16 (`scaling_bench`'s window,
    two pinned poses, with and without the prior), with global_refine's
    prior of 10 on a recorded frontend window, and with one pinned pose
    (global_refine's `min(2, n_real)` for a one-keyframe window) and the
    live prior on a recorded frontend window's first two keyframes (W =
    2). With one pinned pose on a whole frontend window the float32
    solves (the plain version's, K5's) scatter along the free scale past
    these tolerances, by landmark units with global_refine's prior of 10
    (the reduced system's condition number reaches 2e7; PERF.md section
    7)."""
    prob, cam, kw = sc.window_shape_problem(name, cuda)
    out = sc.window_gn_parity(prob, cam, **kw)
    print(f"window_gn {name}: " + json.dumps(out))


@pytest.mark.cuda
@pytest.mark.parametrize("key", sc.window_bits_keys())
def test_k5_matches_its_recorded_bits(cuda, key):
    """K5 bit for bit against the first K5's outputs on every recorded
    case of tests/torch_data/window_gn/k5_bits.npz (`port_window_gn.py
    record`), two calls each, one launch a call."""
    out = sc.check_window_gn_bits(keys=(key,))
    assert out == dict(cases=1, differing=0, launches=2)


@pytest.mark.cuda
def test_k5_zero_iterations(cuda):
    """iters = 0: the input back, both costs the initial one."""
    prob, cam, kw, ref = sc.load_window_case("synthetic", cuda)
    res = ba_window.solve_window(prob, cam, **dict(kw, iters=0))
    assert int(res.n_iters) == 0
    assert sc.bits_equal(res.poses, prob.poses)
    assert sc.bits_equal(res.landmarks, prob.landmarks)
    assert sc.bits_equal(res.cost_initial, res.cost_final)
    assert int(res.n_obs) == int(ref["n_obs"])


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take(cuda):
    prob, cam, kw, _ = sc.load_window_case("synthetic", cuda)
    with pytest.raises(ValueError, match="keyframes"):
        wide = scaling_bench.window_problem(64, 17, device=cuda)
        ba_window.solve_window(wide, cam, **kw)
    with pytest.raises(ValueError, match="float32"):
        ba_window.solve_window(sc._as_float64(prob), cam, **kw)


@pytest.mark.cuda
def test_frontend_solves_through_k5(cuda):
    """A `VOConfig()` frontend over 20 frames of the stamps world: one K5
    launch for every window solve (the eager step too)."""
    imgs, _, _, cam = synthetic.render_sequence(
        **dict(synthetic.STAMPS, n_frames=20))
    calls = []
    solve = ba_window.solve_window

    def counted(*args, **kw):
        calls.append(1)
        return solve(*args, **kw)

    for step_graphs in (True, False):
        calls.clear()
        _build.reset_launches()
        ba_window.solve_window = counted
        try:
            fe = create_frontend(VOConfig(), cam, device="cuda",
                                 step_graphs=step_graphs)
            fe.run([torch.as_tensor(i) for i in imgs])
        finally:
            ba_window.solve_window = solve
        assert fe.n_ba_runs >= 1
        assert _build.LAUNCHES["window_gn"] == len(calls) == len(fe.ba_ms)
