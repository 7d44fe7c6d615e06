"""roofline.hamming.drives: K3's share of its roofline in the traced
window, in %: the frozen bound of one K x K Hamming matrix (K the
configuration's `max_keypoints`; every call of the path has that shape)
times the `hamming_kernel` device events, over their summed device time."""

from vo_bench.frozen import peaks


def read(run):
    t = run.traced
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items() if "hamming_kernel" in k)
    n = sum(v[1] for k, v in t["kernels"].items() if "hamming_kernel" in k)
    if not n or not secs > 0:
        return None
    fc = run.vo["features"]
    K, n_words = fc["max_keypoints"], fc["brief_n_bits"] // 32
    return 100.0 * n * peaks.hamming_bound_ms(K, K, n_words) * 1e-3 / secs
