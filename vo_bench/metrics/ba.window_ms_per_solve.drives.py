"""ba.window_ms_per_solve.drives: the `ba.window` spans (`_run_window_ba`'s
build, solve and apply of one window), inclusive ms a solve, from the
program's span store (`ya_vo_tpu_torch.utils.profiling`, on while the traced
run's profiler runs); None where the program has no such store or no such
span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    st = summary().spans.get("ba.window")
    if st is None or not st.count:
        return None
    return st.ms / st.count
