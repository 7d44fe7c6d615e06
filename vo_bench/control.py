"""The control's readings and the program's, for the limits of a cell.

    python3 -m vo_bench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Runs the cell once a seed in one process (a short window at the cell's
own load and sizes; the samples and the comparison of a benchmark run),
and for each seed prints one JSON line with the program's numbers and the
control's on the same samples: the plain reference one precision below
what the configuration states (the score map, the blur and the LK
pyramids in bfloat16, TF32 on for the geometry's matrix products, the
host's apply, merged positions and pushed state in bfloat16) put in the
program's place. The last line gives each number's lower reading (the
largest the program gave) and upper reading (the smallest the control
gave). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from vo_bench import compare
from vo_bench import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    spec = bench_run.Spec(bench, args.workload)
    lower, upper = {}, {}
    for seed in args.seeds:
        out = bench_run.run_cell(spec, seed, args.seconds, False,
                                 control=True)
        prog = {k: v["value"] for k, v in out["checks"].items()}
        ctrl = out["control"]
        print(json.dumps(dict(seed=seed, correct=out["correct"],
                              program=prog, program_detail=out["detail"],
                              control=ctrl)), flush=True)
        for k in compare.NUMBERS:
            if k in prog:
                lower[k] = max(lower.get(k, -math.inf), prog[k])
            if k in ctrl:
                upper[k] = min(upper.get(k, math.inf), ctrl[k])
    print(json.dumps(dict(workload=args.workload, lower=lower,
                          upper=upper)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
