"""graph.capture_ms_per_session.drives: the `graph.capture` spans (both step
graphs' capture) over the `session.run` spans, ms a session, from the
program's span store (`ya_vo_tpu_torch.utils.profiling`, on while the traced
run's profiler runs); None where the program has no such store or no such
span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    spans = summary().spans
    st, runs = spans.get("graph.capture"), spans.get("session.run")
    if st is None or runs is None or not runs.count:
        return None
    return st.ms / runs.count
