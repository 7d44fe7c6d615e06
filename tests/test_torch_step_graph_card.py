"""The fused step's CUDA graphs against the eager step, on the card.

These tests need a CUDA device and skip without one. The card's machine has
no JAX, which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -q tests/test_torch_step_graph_card.py

from the repository root (beside tests/test_torch_kernels.py). This file
imports no JAX. A frontend at `VOConfig()` on the 376x1241 stamps world
captures its fresh and redo graphs at its first tracking dispatch; then,
in the steady state, after `_push_state_to_device` (every chain tensor
copied into the graphs' buffers) and after `_apply_corr_device` (the pose,
keyframe pose and landmarks rebound), a replay of each graph equals the
eager step (`_extract` + `_step_body` on clones of the same arguments) on
all 15 state outputs and 16 record tensors, bit for bit, and adds one
launch of each of its kernels to `_build.LAUNCHES` (fresh: the five; redo:
LK, Hamming and pose GN; no window solve) and one replay to
`_build.REPLAYS`. The window solve, one launch of K5, is held in
tests/test_torch_window_gn_card.py.
"""

import numpy as np
import pytest
import torch

from ya_vo_tpu_torch import _build, create_frontend
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.selfcheck import bits_equal
from ya_vo_tpu_torch.utils import synthetic

FRESH = dict(dict.fromkeys(_build.KERNELS, 1), window_gn=0)
REDO = dict(FRESH, fast_score=0, fast_select=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the docstring)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stamps():
    imgs, _, _, cam = synthetic.render_sequence(
        **dict(synthetic.STAMPS, n_frames=20))
    return [torch.as_tensor(i) for i in imgs], cam


def _replay_matches_eager(fe, img, pre=None, prev=None) -> None:
    """One dispatch of `img` through the graphs against the eager step on
    clones of the same arguments, with each kernel's launches."""
    img = img.to(fe.device)
    args = fe._step_args(img, prev)
    snap = tuple(a.clone() for a in args)
    kp, desc = fe._extract(snap[1]) if pre is None else pre
    state, record = fe._step_body(kp, desc, *snap)
    before = dict(_build.LAUNCHES)
    replays = _build.REPLAYS["graphs"]
    gkp, gdesc, gstate, grecord = fe._graphs.dispatch(args, pre)
    torch.cuda.synchronize()
    assert len(gstate) == len(state) == 15
    assert len(grecord) == len(record) == 16
    for i, (a, b) in enumerate(zip(state, gstate)):
        assert bits_equal(a, b), f"state output {i}"
    for i, (a, b) in enumerate(zip(record, grecord)):
        assert bits_equal(a, b), f"record tensor {i}"
    assert bits_equal(kp.uv, gkp.uv) and bits_equal(kp.mask, gkp.mask)
    assert bits_equal(desc, gdesc)
    got = {k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
    assert got == (FRESH if pre is None else REDO)
    assert _build.REPLAYS["graphs"] == replays + 1


@pytest.mark.cuda
def test_replays_match_the_eager_step(cuda, stamps):
    frames, cam = stamps
    fe = create_frontend(VOConfig(), cam, device="cuda")
    for img in frames[:5]:
        fe.process(img)
    assert fe._graphs.ready and set(fe._graphs.variants) == {"fresh",
                                                             "redo"}
    redo_prev = fe.last_img
    fe.frame_id += 1
    _replay_matches_eager(fe, frames[5])
    kp, desc = fe._extract(frames[5].cuda())
    _replay_matches_eager(fe, frames[5], pre=(kp, desc), prev=redo_prev)
    # every chain tensor rebuilt from the host mirrors, then copied in
    fe._push_state_to_device()
    _replay_matches_eager(fe, frames[6])
    _replay_matches_eager(fe, frames[6], pre=(kp, desc), prev=redo_prev)
    # a BA correction composed into the device chain in place
    a = np.deg2rad(0.5)
    corr = np.eye(4, dtype=np.float32)
    corr[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]
    corr[:3, 3] = (0.05, -0.02, 0.1)
    fe._apply_corr_device(corr)
    _replay_matches_eager(fe, frames[7])
    _replay_matches_eager(fe, frames[7], pre=(kp, desc), prev=redo_prev)


@pytest.mark.cuda
def test_eager_frontend_captures_nothing(cuda, stamps):
    """`step_graphs=False`: every dispatch is the eager step."""
    frames, cam = stamps
    _build.reset_launches()
    fe = create_frontend(VOConfig(), cam, device="cuda", step_graphs=False)
    fe.run(frames[:6])
    assert fe._graphs is None and _build.REPLAYS["graphs"] == 0
    assert _build.LAUNCHES["lk_level"] == 4 + fe.n_redone
