"""A later PR adds a cell or a per-layer metric by adding files and
entries: the harness finds them by name, with no file of it edited."""

import json
import shutil

from vo_bench import run as bench_run
from vo_bench.tests import tiny


def test_new_cell_and_metric_are_found(tmp_path):
    root = tmp_path
    shutil.copytree(bench_run.HERE, root / "vo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    here = root / "vo_bench"
    # a new traffic mix: data only
    tr = json.loads((here / "traffic" / "drives.json").read_text())
    tr["world"]["step"] = 1.2
    (here / "traffic" / "drives_fast.json").write_text(json.dumps(tr))
    # a new cell with its limits
    cell = "kitti_default.drives_fast"
    (here / "limits" / f"{cell}.json").write_text(
        (here / "limits" / "kitti_default.drives.json").read_text())
    bench["workloads"].append({"name": cell, "config": "kitti_default",
                               "traffic": "drives_fast", "chips": 1,
                               "why": "faster driving"})
    # a new per-layer metric with its reader
    (here / "metrics" / "driver.sessions.fast.py").write_text(
        "def read(run):\n    return float(len(run.create_ms))\n")
    bench["per_layer"].append({
        "name": "driver.sessions.fast", "unit": "sessions",
        "better": "lower", "source": "program_counter",
        "layer": "pipelined driver", "moves": "frames_per_s",
        "workloads": [cell]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "frames_per_s":
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    sp = tiny.spec(cell, root=root, bench=bench)
    assert sp.traffic["world"]["step"] == 1.2
    assert [m["name"] for m in sp.per_layer] == ["driver.sessions.fast"]
    out = bench_run.run_cell(sp, 5, 4.0, True, device="cpu")
    assert out["metrics"]["driver.sessions.fast"]["value"] >= 1
    out = bench_run.run_cell(sp, 5, 4.0, False, device="cpu")
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
