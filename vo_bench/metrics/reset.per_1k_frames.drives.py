"""reset.per_1k_frames.drives: `Frontend.n_resets`, summed over the
window's sessions, per 1,000 poses returned."""


def read(run):
    if not run.frames_done:
        return None
    return 1000.0 * run.counters["resets"] / run.frames_done
