"""driver.dispatch_ms_per_frame.drives: the fresh `step.dispatch` spans'
self ms (`_dispatch_track` less the graph's replay and capture; a redo's
dispatches, under `step.redo`, left out), a pose returned, from the
program's span store (`ya_vo_tpu_torch.utils.profiling`, on while the traced
run's profiler runs); None where the program has no such store or no such
span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    st = summary(outside="step.redo").spans.get("step.dispatch")
    if st is None or not run.frames_done:
        return None
    return st.self_ms / run.frames_done
