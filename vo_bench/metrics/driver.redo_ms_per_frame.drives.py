"""driver.redo_ms_per_frame.drives: the `step.redo` spans (`_redo_queue`:
the push and the re-dispatches), inclusive ms a pose returned, from the
program's span store (`ya_vo_tpu_torch.utils.profiling`, on while the traced
run's profiler runs); None where the program has no such store or no such
span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    st = summary().spans.get("step.redo")
    if st is None or not run.frames_done:
        return None
    return st.ms / run.frames_done
