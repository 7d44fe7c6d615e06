"""The fused step's runner (`ya_vo_tpu_torch/tracking/step_graph.py`) on the
CPU, where nothing is captured but the buffers are handled as on the card:
each argument copied into its static buffer, the next state written back
into the buffers, the outputs left in static tensors and the kept
keypoints and descriptors copied out. Any tensor the frontend kept past
the next dispatch without a copy would read the next frame's values here,
as it would on the card.

- the frontend with the runner (`step_graphs=True`, the default) against
  the eager step (`step_graphs=False`), pipelined over the stamps world at
  256x768 with `VOConfig()`'s window BA on (a redo of the in-flight frames
  at each apply) and two black frames (a reset and a PnP relocalization):
  push apply, device apply, and asynchronous BA (its solves run at submit,
  so both runs apply them at the same frames): trajectories bit for bit,
  statuses, keyframes, resets, relocalizations, solves and redone
  dispatches equal;
- `device_throughput_probe` and `precompile` (dispatches on a throwaway
  chain, which overwrite the runner's buffers) leave the chain's contents
  as they were, and the session goes on as one that never ran them;
- `profile_step.graph_step`, the replay row of the tool, equal to the
  eager fused step on the tool's snapshot;
- `_build`'s counts: launches inside a capture go to the capture's counts,
  and each replay adds them to `LAUNCHES`.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from ya_vo_tpu_torch import _build, profile_step
from ya_vo_tpu_torch.config import (FeatureConfig, TrackConfig, VOConfig,
                                    with_option)
from ya_vo_tpu_torch.selfcheck import bits_equal
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.tracking.step_graph import STATE_TO_ARG
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.utils.convert import DEVICE_KEYS

WORLD = dict(synthetic.STAMPS, n_frames=14, height=256, width=768)
BLACK_AT = 8


def make_config(**ba) -> VOConfig:
    """VOConfig() at 256x768, 1024 keypoints and the gates of the small
    worlds' tests, window BA on."""
    cfg = VOConfig(image_height=256, image_width=768,
                   features=FeatureConfig(max_keypoints=1024),
                   tracking=TrackConfig(min_ba_inliers=15,
                                        min_flow_inliers=5))
    return with_option(cfg, "ba", **ba) if ba else cfg


@pytest.fixture(scope="module")
def world():
    imgs, poses, _, cam = synthetic.render_sequence(**WORLD)
    black = np.zeros_like(imgs[0])
    return list(imgs[:BLACK_AT]) + [black] * 2 + list(imgs[BLACK_AT:]), cam


class _Inline(concurrent.futures.Executor):
    """Runs each job at submit: the asynchronous backend's solves finish
    before the next frame polls them, in both runs alike."""

    def submit(self, fn, *args, **kwargs):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except Exception as exc:
            fut.set_exception(exc)
        return fut


def _run(cfg, cam, frames, step_graphs: bool) -> Frontend:
    fe = Frontend(cfg, cam, device="cpu", step_graphs=step_graphs)
    if cfg.ba.asynchronous:
        fe._ba_executor.shutdown(wait=True)
        fe._ba_executor = _Inline()
    fe.run(frames, pipelined=True)
    return fe


@pytest.mark.parametrize("ba", [{}, {"apply_mode": "device"},
                                {"asynchronous": True}],
                         ids=["push", "device", "async"])
def test_runner_matches_eager_step(world, ba):
    frames, cam = world
    cfg = make_config(**ba)
    eager = _run(cfg, cam, frames, False)
    graphs = _run(cfg, cam, frames, True)
    assert eager._graphs is None and graphs._graphs.ready
    # both variants went through the runner (a redo after every push)
    assert set(graphs._graphs.variants) == {"fresh", "redo"}
    np.testing.assert_array_equal(np.stack(graphs.trajectory),
                                  np.stack(eager.trajectory))
    for key in ("status", "is_keyframe", "n_keypoints", "n_matches",
                "n_flow_inliers", "n_ba_inliers", "n_new_landmarks",
                "reset"):
        assert [getattr(r, key) for r in graphs.results] == \
            [getattr(r, key) for r in eager.results], key
    for key in ("n_resets", "n_relocalizations", "n_ba_runs",
                "n_ba_discarded", "n_redone"):
        assert getattr(graphs, key) == getattr(eager, key), key
    assert eager.n_resets == 1 and eager.n_relocalizations == 1
    assert eager.n_ba_runs >= 1
    assert eager.n_redone > 0
    assert _same(_chain(graphs), _chain(eager))


def _chain(fe) -> dict:
    return {k: None if getattr(fe, k) is None else getattr(fe, k).clone()
            for k in DEVICE_KEYS}


def _same(a: dict, b: dict) -> bool:
    return all((a[k] is None and b[k] is None)
               or (a[k] is not None and b[k] is not None
                   and bits_equal(a[k], b[k])) for k in DEVICE_KEYS)


def test_throwaway_chain_keeps_the_chain(world):
    """The probe and `precompile` replay on the buffers that hold the
    chain; the chain's contents come back, and the session tracks on as
    one that never ran them."""
    frames, cam = world
    cfg = make_config(enabled=False)     # no push: the chain stays put
    fe, ref = (Frontend(cfg, cam, device="cpu") for _ in range(2))
    for f in (fe, ref):
        f.run(frames[:5], pipelined=False)
    g = fe._graphs
    assert g.ready
    # the chain is the runner's buffers, as after any replay
    assert fe._d_pose.data_ptr() == g.bufs[STATE_TO_ARG[3]].data_ptr()
    before = _chain(fe)
    fe.device_throughput_probe(frames[5:7], n_steps=3)
    fe.precompile()
    assert _same(before, _chain(fe))
    for f in (fe, ref):
        for img in frames[5:BLACK_AT]:
            f.process(img)
    np.testing.assert_array_equal(np.stack(fe.trajectory),
                                  np.stack(ref.trajectory))
    assert _same(_chain(fe), _chain(ref))


def test_graph_step_matches_fused_step():
    """`profile_step`'s replay row on the tool's snapshot equals its eager
    fused step, output for output, and leaves the chain as it was."""
    fe, img = profile_step.setup("cpu", world=dict(height=256, width=768,
                                                   n_landmarks=500),
                                 max_keypoints=256)
    st = profile_step.snapshot(fe, img)
    kp, desc, state, record = profile_step.fused_step(fe, st)
    before = _chain(fe)
    with fe._throwaway_chain():
        gkp, gdesc, gstate, grecord = profile_step.graph_step(fe, st)
        assert all(bits_equal(a, b) for a, b in zip(kp, gkp))
        assert bits_equal(desc, gdesc)
        assert len(gstate) == len(state) == 15
        assert all(bits_equal(a, b) for a, b in zip(state, gstate))
        assert len(grecord) == len(record) == 16
        assert all(bits_equal(a, b) for a, b in zip(record, grecord))
    assert _same(before, _chain(fe))


def test_launches_count_at_replay(monkeypatch):
    """A wrapper's launch inside a capture goes to the capture's counts,
    not `LAUNCHES`; every replay adds them, and counts itself."""

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "_lib", Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS, 0))
    monkeypatch.setattr(_build, "REPLAYS", {"graphs": 0})
    _build.launch("lk_level")
    with _build.capturing() as counts:
        _build.launch("lk_level")
        _build.launch("pose_gn")
        _build.launch("pose_gn")
    assert _build.LAUNCHES["lk_level"] == 1 and _build.LAUNCHES["pose_gn"] == 0
    assert counts["lk_level"] == 1 and counts["pose_gn"] == 2
    for _ in range(3):
        _build.count_replay(counts)
    assert _build.LAUNCHES["lk_level"] == 4 and _build.LAUNCHES["pose_gn"] == 6
    assert _build.REPLAYS["graphs"] == 3
    _build.launch("hamming")
    assert _build.LAUNCHES["hamming"] == 1
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and _build.REPLAYS["graphs"] == 0
