"""device.busy_ms_per_frame.drives: the union of the device events'
intervals in the traced window over the poses returned in it."""


def read(run):
    t = run.traced
    if not t or not run.frames_done or not t["busy_s"] > 0:
        return None
    return t["busy_s"] * 1e3 / run.frames_done
