"""Tracing / profiling utilities.

Port of `ya_vo_tpu/utils/profiling.py`:

  * `span()` — wall-clock context manager that fences outstanding card
    work (`torch.cuda.synchronize` once CUDA is initialised; nothing more
    on the CPU) for honest numbers;
  * `trace()` — wraps `torch.profiler.profile` (CPU, and CUDA with a card)
    and writes a Chrome trace (chrome://tracing, Perfetto) into a
    directory;
  * `MetricsLog` — structured per-frame metrics accumulation + summary,
    replacing printf-style status lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile


def _fence() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, store: Optional[dict] = None, sync: bool = True):
    """Time a block; with sync=True, fences outstanding card work so the
    measurement is not async-dispatch fiction."""
    if sync:
        _fence()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _fence()
        dt = (time.perf_counter() - t0) * 1e3
        if store is not None:
            store[name] = store.get(name, 0.0) + dt


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile a block (CPU and, with a card, CUDA activities) and write
    its Chrome trace to `log_dir`/trace_<pid>_<ms>.json. Yields the
    profiler."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class MetricsLog:
    """Per-frame structured metrics with aggregate summaries."""

    def __init__(self):
        self.frames: List[dict] = []

    def log(self, **kv) -> None:
        self.frames.append(kv)

    def log_frame_result(self, r) -> None:
        self.log(
            frame_id=r.frame_id, status=r.status,
            n_keypoints=r.n_keypoints, n_matches=r.n_matches,
            n_flow_inliers=r.n_flow_inliers, n_ba_inliers=r.n_ba_inliers,
            n_new_landmarks=r.n_new_landmarks, is_keyframe=r.is_keyframe,
            reset=r.reset, **{f"ms_{k}": v for k, v in r.timings_ms.items()},
        )

    def summary(self) -> Dict[str, float]:
        if not self.frames:
            return {}
        agg: Dict[str, list] = defaultdict(list)
        for f in self.frames:
            for k, v in f.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k].append(float(v))
        out = {}
        for k, vs in agg.items():
            out[f"{k}_mean"] = sum(vs) / len(vs)
        out["n_frames"] = float(len(self.frames))
        out["n_resets"] = float(sum(1 for f in self.frames if f.get("reset")))
        out["n_keyframes"] = float(
            sum(1 for f in self.frames if f.get("is_keyframe")))
        return out

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.frames:
                f.write(json.dumps(row) + "\n")
