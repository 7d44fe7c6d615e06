"""graph.replay_ms_per_replay.drives: the `graph.replay` spans (the host's
`cudaGraphLaunch` of one step graph), mean ms, from the program's span store
(`ya_vo_tpu_torch.utils.profiling`, on while the traced run's profiler
runs); None where the program has no such store or no such span."""


def read(run):
    try:
        from ya_vo_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    st = summary().spans.get("graph.replay")
    if st is None or not st.count:
        return None
    return st.ms / st.count
