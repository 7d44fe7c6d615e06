"""roofline.fast_score.drives: K2's share of its roofline in the traced
window, in %: the frozen `fast_work` and `bound` summed over the frames
handed over in the traced window (each is extracted once), over the
summed `fast_score_kernel` device time."""

import torch

from vo_bench.frozen import peaks


def read(run):
    t = run.traced
    if not t or not run.traced_frames:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if "fast_score_kernel" in k)
    if not secs > 0:
        return None
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    fc = run.vo["features"]
    ms = sum(peaks.fast_bound_ms(torch.as_tensor(f).to(dev), fc)
             for f in run.traced_frames)
    return 100.0 * ms * 1e-3 / secs
