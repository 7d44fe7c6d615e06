"""A traffic mix's driver is a file of its own, found by name: a later PR
adds a driver, its mix, limits and cell as new files and entries, with no
file of the harness edited; and the traced run's idle gaps are named by
the program's spans."""

import json
import shutil

import pytest

from vo_bench import run as bench_run
from vo_bench.tests import tiny
from ya_vo_tpu_torch.utils.profiling import Span

PROBE = '''
import json
import time
from pathlib import Path


def drive(run, routes, make_frontend, audit, tracer, record_keys, seconds):
    from vo_bench.run import load_driver

    t = time.perf_counter()
    (Path(run.spec.here) / "probe.json").write_text(
        json.dumps({"device": str(run.device)}))
    run.setup["probe_s"] = time.perf_counter() - t
    load_driver(run.spec.here, "drives")(run, routes, make_frontend, audit,
                                         tracer, record_keys, seconds)
'''


@pytest.mark.parametrize("driver", ["probe", "nowhere"])
def test_driver_is_found_by_name(tmp_path, capsys, driver):
    root = tmp_path
    shutil.copytree(bench_run.HERE, root / "vo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    here = root / "vo_bench"
    # a new driver, a mix that names it, its limits and its cell
    (here / "drivers" / "probe.py").write_text(PROBE)
    tr = json.loads((here / "traffic" / "drives.json").read_text())
    tr["driver"] = driver
    (here / "traffic" / "drives_probe.json").write_text(json.dumps(tr))
    cell = "kitti_default.drives_probe"
    (here / "limits" / f"{cell}.json").write_text(
        (here / "limits" / "kitti_default.drives.json").read_text())
    bench["workloads"].append({"name": cell, "config": "kitti_default",
                               "traffic": "drives_probe", "chips": 1,
                               "why": "the drives through a probe"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    sp = tiny.spec(cell, root=root, bench=bench)
    if driver == "nowhere":
        with pytest.raises(SystemExit, match="nowhere.py"):
            bench_run.run_cell(sp, 5, 4.0, False, device="cpu")
        return
    out = bench_run.run_cell(sp, 5, 4.0, False, device="cpu")
    assert json.loads((here / "probe.json").read_text()) == {"device": "cpu"}
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("run: ")][-1]
    setup = json.loads(line[len("run: "):])["setup"]
    assert {"probe_s", "warm_session_s"} <= set(setup)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_idle_gaps_are_named_by_spans():
    """The breakdown's idle gaps over a window: each named by a span or
    `unspanned`, the ten largest listed, and every part together the
    window's idle time."""
    busy = [(100, 200), (150, 260), (400, 410), (900, 1500), (1700, 1800)]
    names = [f"phase.{k}" for k in range(12)]
    spans = [Span("session.run", 50, 1900, 1, 0, 7, 0, None)]
    spans += [Span(n, 270 + 100 * k, 300 + 100 * k + 2 * k, k + 2, 1, 7,
                   0, k) for k, n in enumerate(names)]
    spans.append(Span("ba.window", 1520, 1690, 20, 0, 8, 0, None))
    window = (0, 2000)
    top, parts = bench_run.idle_gaps(busy, spans, window)
    assert len(top) == 10 and [n for n, _ in top] == list(parts)[:10]
    assert set(parts) <= {s.name for s in spans} | {"unspanned"}
    assert {"session.run", "ba.window", "unspanned"} <= set(parts)
    assert [v for _, v in top] == sorted((v for _, v in top), reverse=True)
    busy_ns = (260 - 100) + (410 - 400) + (1500 - 900) + (1800 - 1700)
    assert sum(parts.values()) == pytest.approx((2000 - busy_ns) * 1e-9)
    assert parts["unspanned"] == pytest.approx((50 + 100) * 1e-9)
    assert parts["ba.window"] == pytest.approx((1690 - 1520) * 1e-9)
