"""The port's bench hooks and the bench itself, on the CPU.

`Frontend.precompile()` and `device_throughput_probe()` run dispatches
(and `precompile` a window solve) on a throwaway copy of the device chain:
the chain, the map, the host mirrors and the counters stay bit for bit as
they were, and the frames after them track exactly as without them.
`ya_vo_tpu_torch.bench.run_bench` at a tiny size gives one JSON line with
every key of `bench.py`'s (the stamps secondary's included), rounded as
`bench.py` rounds them, and a selfcheck that does not pass zeroes the
headline.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_frontend import SEQ
from tests.test_torch_reset import make_config
from ya_vo_tpu_torch import bench
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.tracking import frontend as tfrontend
from ya_vo_tpu_torch.utils import convert
from ya_vo_tpu_torch.utils import synthetic as tsynthetic

BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "reps", "fps_reps", "fps_min",
    "fps_max", "timed_frames", "render_ms_per_frame", "ate_raw_m",
    "ate_reps", "resets", "resets_reps", "ba_discarded_reps",
    "production_gates", "device_step_ms", "fps_device", "n_steps",
    "ate_refined_m", "selfcheck", "redone_reps", "ba_runs_reps", "card",
    "device", "stamps_fps", "stamps_ate_m"}


@pytest.fixture(scope="module")
def frames():
    imgs, _, _, cam = tsynthetic.render_sequence(**SEQ)
    return imgs, cam


def _state(fe) -> dict:
    """Everything a session carries: the device chain, the host mirrors
    and counters, the previous frame and anchor keyframe, the map."""
    out = {k: getattr(fe, k) for k in convert.DEVICE_KEYS}
    out = {k: None if v is None else v.clone() for k, v in out.items()}
    out.update({k: np.array(getattr(fe, k)) for k in convert.HOST_KEYS})
    out.update(n_redone=fe.n_redone, status=fe.status,
               results=len(fe.results), trajectory=len(fe.trajectory))
    for k in ("last_img", "last_desc", "_kf_img", "_kf_desc"):
        out[k] = getattr(fe, k).clone()
    out["map"] = convert.map_arrays(fe.map)
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        elif k == "map":
            for m in a[k]:
                np.testing.assert_array_equal(a[k][m], b[k][m], err_msg=m)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_hooks_leave_the_session_as_it_was(frames):
    """After six frames (the bootstrap and keyframes, window BA on):
    precompile and a 3-step probe change nothing, and frames 6-9 then give
    the trajectory of a session that never ran them, bit for bit."""
    imgs, cam = frames
    fe, ref = (tfrontend.Frontend(make_config(), cam, device="cpu")
               for _ in range(2))
    for img in imgs[:6]:
        fe.process(img)
        ref.process(img)
    assert fe.map.n_keyframes >= 2
    before = _state(fe)
    fe.precompile()
    _assert_same(before, _state(fe))
    probe = fe.device_throughput_probe(imgs[3:6], n_steps=3)
    _assert_same(before, _state(fe))
    assert probe["n_steps"] == 3
    assert probe["device_step_ms"] > 0 and probe["fps_device"] > 0
    np.testing.assert_array_equal(fe.run(imgs[6:]), ref.run(imgs[6:]))
    assert fe.n_ba_runs == ref.n_ba_runs


def test_finish_resolves_frames_in_flight(frames):
    imgs, cam = frames
    fe = tfrontend.Frontend(make_config(), cam, device="cpu")
    for img in imgs[:5]:
        fe._pipe_step(img)
    assert fe._pending_q
    fe.finish()
    assert not fe._pending_q and len(fe.results) == 5
    fe.finish()
    assert len(fe.trajectory) == 5


def test_probe_needs_a_track_chain(frames):
    fe = tfrontend.Frontend(make_config(), frames[1], device="cpu")
    with pytest.raises(RuntimeError, match="track chain"):
        fe.device_throughput_probe(frames[0][:2], n_steps=2)
    fe.precompile()        # before the bootstrap: nothing to warm


@pytest.fixture(scope="module")
def bench_run():
    """run_bench at 188x620 (the KITTI camera halved), 14 frames, one rep,
    a 512-texel atlas, the stamps secondary over 9 frames (6 warm), on the
    CPU, with a selfcheck that fails."""
    calls = []

    def selfcheck():
        calls.append(1)
        return "fail"

    s = 0.5
    cam = Camera.create(718.856 * s, 718.856 * s, 607.1928 * s,
                        185.2157 * s)
    out = bench.run_bench(n_frames=14, reps=1, height=188, width=620,
                          cam=cam, device="cpu", tex_size=512, probe_steps=2,
                          stamps_frames=9, selfcheck=selfcheck)
    return out, calls


def test_bench_prints_one_line_with_every_key(bench_run):
    out, calls = bench_run
    line = json.dumps(out)
    assert "\n" not in line and set(json.loads(line)) == BENCH_KEYS
    assert calls == [1]
    assert out["reps"] == 1 and len(out["fps_reps"]) == 1
    assert out["timed_frames"] == 14 - bench.WARM
    assert out["fps_reps"][0] > 0 and out["n_steps"] == 2
    assert np.isfinite(out["ate_raw_m"]) and np.isfinite(out["ate_refined_m"])
    assert out["stamps_fps"] > 0 and np.isfinite(out["stamps_ate_m"])
    assert out["device"] == "cpu" and out["card"] == "none (cpu)"


def test_bench_rounds_as_bench_py(bench_run):
    """frames/s to 2 places, ATE to 4, render ms to 1, the headline and
    vs_baseline to 3 (bench.py:313-333, 355-356)."""
    out, _ = bench_run
    places = {"fps_min": 2, "fps_max": 2, "stamps_fps": 2,
              "device_step_ms": 2, "fps_device": 2, "render_ms_per_frame": 1,
              "ate_raw_m": 4, "ate_refined_m": 4, "stamps_ate_m": 4,
              "value": 3, "vs_baseline": 3}
    for k, n in places.items():
        assert out[k] == round(out[k], n), (k, out[k])
    for k, n in (("fps_reps", 2), ("ate_reps", 4)):
        assert out[k] == [round(x, n) for x in out[k]], (k, out[k])


def test_failing_selfcheck_zeroes_the_value(bench_run):
    out, _ = bench_run
    assert out["selfcheck"] == "fail"
    assert out["value"] == 0.0 and out["vs_baseline"] == 0.0


@pytest.mark.parametrize("status,ate,scores", [
    ("pass", 0.2, True), ("fail", 0.2, False), ("timeout", 0.2, False),
    ("error:OSError", 0.2, False), ("pass", 0.5, False)])
def test_score_guards(status, ate, scores):
    value, vs = bench.score(4.0, ate, status)
    assert value == (4.0 if scores else 0.0)
    assert vs == pytest.approx(value / bench.ref_fps())
    assert bench.ref_fps() == pytest.approx(3.216, abs=0.01)


def test_bench_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    assert bench.main() == 2
