"""Tiny CPU versions of the benchmark's cells, for the tests: the routes at
188x620 (the KITTI camera halved, a 512 atlas), a few frames, a short
window, and as few compared samples."""

from __future__ import annotations

import json
from pathlib import Path

from vo_bench import run as bench_run

CAMERA_HALF = [359.428, 359.428, 303.5964, 92.60785]


def spec(cell: str, root: Path = bench_run.ROOT, bench: dict = None):
    """The cell's spec from `root`'s files, cut to a CPU test's size: two
    routes of 12 frames, every sample drawn from the window's first
    session (a CPU window of a few seconds reaches about one)."""
    bench = bench or json.loads((Path(root) / "BENCHMARK.json").read_text())
    sp = bench_run.Spec(bench, cell, root)
    tr = sp.traffic
    tr["world"].update(height=188, width=620, tex_size=512,
                       camera=CAMERA_HALF)
    tr.update(frames_per_route=12, world_seeds=[5, 6], trace_seconds=4)
    tr["audit"].update(first_frame=3, last_frame=6, frames=3, solves=1,
                       sessions_per_s=0.1, solves_per_s=0.1)
    return sp


def run(cell: str, seconds: float = 6.0, trace: bool = False,
        seed: int = 2 ** 31 + 11, **kw) -> dict:
    """One tiny run of `cell` on the CPU: the result's dict."""
    return bench_run.run_cell(spec(cell, **kw), seed, seconds, trace,
                              device="cpu")
