"""ba.gn_iters_per_solve.drives: the `ba.gn_iters` counter (K5's GN
iterations, read after each solve's read-back) over the `ba.solve` spans,
from the program's span store (`ya_vo_tpu_torch.utils.profiling`, on while
the traced run's profiler runs); None where the program has no such store or
no such span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary()
    iters, solves = s.counters.get("ba.gn_iters"), s.spans.get("ba.solve")
    if iters is None or solves is None or not solves.count:
        return None
    return iters.total / solves.count
