"""Each cell end to end at a tiny size on the CPU: set-up, the window, the
readings and the comparison, untraced and traced; and the full-size run on
the card, which skips here."""

import json
import subprocess
import sys

import pytest
import torch

from vo_bench import run as bench_run
from vo_bench.tests import tiny
from ya_vo_tpu_torch.utils import profiling

CELLS = tuple(w["name"] for w in json.loads(
    (bench_run.ROOT / "BENCHMARK.json").read_text())["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in tiny.spec(cell).end_to_end}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"]["samples"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics():
    out = tiny.run("kitti_default.drives", trace=True)
    assert out["correct"]
    assert "driver.redone_per_frame.drives" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the idle gaps by the program's spans, which the window recorded
    names = {n for n, _ in out["breakdown"]["idle_gaps"]}
    assert names and names <= {s.name for s in profiling.spans()} | {
        "unspanned"}


def test_no_card_exits_without_a_result(tmp_path):
    """Without a CUDA device the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "vo_bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=bench_run.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_files_fail(tmp_path):
    """In a directory that holds only BENCHMARK.json and vo_bench/, the
    command fails (the program is not there) and prints no result."""
    import shutil
    shutil.copy(bench_run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench_run.HERE, tmp_path / "vo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "vo_bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A full-size run on the card (`python -m pytest vo_bench/tests -m
    cuda` on a machine with an H100): correct, with its metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's measurement runs on "
                    "the card")
    p = subprocess.run([sys.executable, "-m", "vo_bench.run", "--workload",
                        cell, "--seed", "7", "--seconds", "10",
                        "--trace", "0"], cwd=bench_run.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
