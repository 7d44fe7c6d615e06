"""In a fresh interpreter: nothing the harness runs loads JAX or the JAX
package, and the reference loads nothing of the program (top-level module
names compared whole: `ya_vo_tpu_torch` begins with `ya_vo_tpu` and is not
it)."""

import json
import subprocess
import sys

from vo_bench import run as bench_run

HARNESS = """
import json, sys
from vo_bench import audit, compare, control, generator, run
from vo_bench.tests import tiny
out = tiny.run("kitti_default.drives", seconds=4.0)
assert out["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from vo_bench.reference import (bootstrap, extract, host, lie, precision,
                                step, window)
from vo_bench.frozen import evaluation, peaks, scene, trace
from vo_bench import generator
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _modules(HARNESS)
    assert "ya_vo_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ya_vo_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "ya_vo_tpu",
                       "ya_vo_tpu_torch"}


def test_forbidden_names_compared_whole():
    import ya_vo_tpu_torch  # noqa: F401
    assert "ya_vo_tpu" not in sys.modules
    assert bench_run.forbidden_modules() == []
