"""driver.inflight_per_resolve.drives: the `driver.inflight` counter (the
frames in flight at each resolve of the pipelined driver, the resolved one
included) over its events, from the program's span store
(`ya_vo_tpu_torch.utils.profiling`, on while the traced run's profiler
runs); None where the program has no such store or no such counter."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    c = summary().counters.get("driver.inflight")
    if c is None or not c.count:
        return None
    return c.total / c.count
