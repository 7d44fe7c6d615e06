"""driver.redone_per_frame.drives: the pipelined driver's redone
dispatches (`Frontend.n_redone`, summed over the window's sessions) over
the poses returned."""


def read(run):
    if not run.frames_done:
        return None
    return run.counters["redone"] / run.frames_done
