"""frames_per_s: the poses the entry returned in the window over the time
from the window's start to the return of the last call (closed loop)."""


def read(run):
    if not run.window_s > 0 or not run.frames_done:
        return None
    return run.frames_done / run.window_s
