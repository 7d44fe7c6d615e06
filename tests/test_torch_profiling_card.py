"""The span recorder on the card's clock (`ya_vo_tpu_torch/utils/profiling`).

These tests need a CUDA device and skip without one. The card's machine has
no JAX, which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -q tests/test_torch_profiling_card.py

from the repository root. This file imports no JAX. Under a profiler with
CUDA activity only, as the benchmark's traced run profiles, a span around
the synchronize that `torch.cuda.synchronize()` calls
(`torch._C._cuda_synchronize`; the Python wrapper's device switch first
costs 10-80 us under the profiler) holds kineto's `cudaDeviceSynchronize`
event: no side of the span misses the event's by more than 20 us, and the
span's middle lies on the event's within 20 us (the median over the
spans), so the two clocks agree to inside that. The gap on each side is
mostly the Python call around the synchronize, which a busy host
stretches: it is only held below 100 us. And `profiling.trace()`'s Chrome
trace puts a span over the kernels launched inside it.
"""

import json
import os
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ya_vo_tpu_torch.utils import profiling

SLACK_NS = 20_000
CALL_NS = 100_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the docstring)")
    profiling.clear()
    yield torch.device("cuda")
    profiling.clear()


@pytest.mark.cuda
def test_span_encloses_cuda_device_synchronize(cuda):
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(6):
            y = x @ x                  # a few ms for the sync to wait on
            # the first, a warm-up, is left out
            sp = profiling.begin("sync") if i else None
            torch._C._cuda_synchronize()
            profiling.end(sp)
            del y
    spans = profiling.spans()
    syncs = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == "cudaDeviceSynchronize"]
    assert len(spans) == 5
    mids = []
    for s in spans:
        # the warm-up's and the profiler's own syncs lie outside the spans
        (a, b), = [(a, b) for a, b in syncs
                   if a < s.end_ns and b > s.start_ns]
        print(f"event - span: start {a - s.start_ns} ns, "
              f"end {s.end_ns - b} ns")
        assert -SLACK_NS <= a - s.start_ns <= CALL_NS
        assert -SLACK_NS <= s.end_ns - b <= CALL_NS
        mids.append((s.start_ns + s.end_ns - a - b) / 2)
    print(f"span middle - event middle, median: {statistics.median(mids)} ns")
    assert abs(statistics.median(mids)) <= SLACK_NS


@pytest.mark.cuda
def test_trace_puts_spans_on_the_device_timeline(cuda, tmp_path):
    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        with profiling.span("block", frame=1):
            y = x @ x
            torch.cuda.synchronize()
        del y
    (name,) = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "program_span"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels
    slack_us = SLACK_NS * 1e-3
    for k in kernels:
        assert sp["ts"] - slack_us <= k["ts"]
        assert k["ts"] + k["dur"] <= sp["ts"] + sp["dur"] + slack_us
    (idle,) = [f for f in os.listdir(tmp_path) if f.startswith("idle_")]
    with open(tmp_path / idle) as f:
        json.load(f)
