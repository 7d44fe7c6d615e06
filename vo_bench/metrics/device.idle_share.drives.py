"""device.idle_share.drives: 1 - (union of the device events' intervals) /
(the traced window's wall time), in %."""


def read(run):
    t = run.traced
    if not t or not t["window_s"] > 0 or not t["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
