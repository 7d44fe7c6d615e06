"""The port's profiling utilities (`ya_vo_tpu_torch/utils/profiling.py`)
against the JAX package's, on the CPU: `span` times a block into a store
(no fence without a card), `trace` writes a Chrome trace of the block, and
`MetricsLog` gives JAX's summary and JSON lines on the same frame results
(the port's and the JAX frontend's `FrameResult`)."""

import json
import os

import numpy as np
import pytest
import torch

from ya_vo_tpu.tracking.frontend import FrameResult as JFrameResult
from ya_vo_tpu.utils import profiling as jprofiling
from ya_vo_tpu_torch.tracking.frontend import FrameResult
from ya_vo_tpu_torch.utils import profiling


def _results(cls, seed=0, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n):
        reset = bool(rng.random() < 0.2)
        out.append(cls(
            f, "RESET" if reset else "TRACKING", np.eye(4, dtype=np.float32),
            n_keypoints=int(rng.integers(500, 2048)),
            n_matches=int(rng.integers(0, 900)),
            n_flow_inliers=int(rng.integers(0, 800)),
            n_ba_inliers=int(rng.integers(0, 700)),
            n_new_landmarks=int(rng.integers(0, 200)),
            is_keyframe=bool(rng.random() < 0.4), reset=reset,
            timings_ms={"step": float(rng.uniform(5, 50)),
                        "ba": float(rng.uniform(0, 80))}))
    return out


@pytest.mark.parametrize("sync", [True, False])
def test_span_accumulates(sync):
    store = {}
    for _ in range(2):
        with profiling.span("work", store, sync=sync):
            torch.ones(64, 64).sum()
    with profiling.span("untimed", sync=sync):
        pass
    assert set(store) == {"work"} and store["work"] > 0
    jstore = {}
    with jprofiling.span("work", jstore, sync=sync):
        pass
    assert set(jstore) == set(store)
    assert not torch.cuda.is_initialized()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        torch.randn(128, 128) @ torch.randn(128, 128)
    assert prof is not None
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as fp:
        events = json.load(fp)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_metrics_log_equals_jax(tmp_path):
    log, jlog = profiling.MetricsLog(), jprofiling.MetricsLog()
    assert log.summary() == jlog.summary() == {}
    for r, q in zip(_results(FrameResult), _results(JFrameResult)):
        log.log_frame_result(r)
        jlog.log_frame_result(q)
    log.log(frame_id=99, status="EXTRA", ms_step=1.5)
    jlog.log(frame_id=99, status="EXTRA", ms_step=1.5)
    summary = log.summary()
    assert summary == jlog.summary()
    assert summary["n_frames"] == 13.0
    assert summary["n_keyframes"] > 0 and summary["n_resets"] > 0
    log.dump_jsonl(str(tmp_path / "port.jsonl"))
    jlog.dump_jsonl(str(tmp_path / "jax.jsonl"))
    with open(tmp_path / "port.jsonl") as a, open(tmp_path / "jax.jsonl") as b:
        assert a.read() == b.read()
