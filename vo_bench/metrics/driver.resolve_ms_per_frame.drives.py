"""driver.resolve_ms_per_frame.drives: the `step.resolve` spans' self ms
(`_resolve_record`'s gates, map replay and mirrors, less the wait, the push
and the window BA), a pose returned, from the program's span store
(`ya_vo_tpu_torch.utils.profiling`, on while the traced run's profiler
runs); None where the program has no such store or no such span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    st = summary().spans.get("step.resolve")
    if st is None or not run.frames_done:
        return None
    return st.self_ms / run.frames_done
