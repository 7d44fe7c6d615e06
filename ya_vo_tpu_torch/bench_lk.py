"""K1 (the LK kernel) on one CUDA card: where does the time go, against
the levels and the iteration count?

    python -m ya_vo_tpu_torch.bench_lk [iters ...] [--levels L ...]
                                       [--reps N] [--device cpu]

Port of `tools/bench_lk.py`: two random 376x1241 images (uniform integers
in [0, 255) as float32, numpy seed 0), 2048 keypoints uniform in
[20, W-20) x [20, H-20), seeds within 3 px of them, all live, through
`lk_cuda.track` at levels {1, 3} x iters {1, 5, 10, 30}. Each row: call ms
(the host clock over `--reps` calls ended by `torch.cuda.synchronize()`,
after one warm call), K1's device ms (its own kernel's profiler events,
`lk_pyramid_kernel`, a call), the whole call's device ms (the union of its
device events: the pyramids' too) and the tracked count (the tool's
status).

JAX's `YA_VO_LK_KERNEL=v2/v3` picks one of two bodies of one Pallas kernel;
K1 computes the function of both (tests/test_torch_lk.py), so the port has
one variant. With `--device cpu` (small shapes only) the plain version
runs and only call ms is measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ya_vo_tpu_torch import profile_step, require_device
from ya_vo_tpu_torch.tracking import lk_cuda

H, W, N = 376, 1241, 2048
ITERS = (1, 5, 10, 30)
LEVELS = (1, 3)
REPS = 5
KERNEL = "lk_pyramid_kernel"


def inputs(height: int = H, width: int = W, n: int = N, seed: int = 0):
    """(img0, img1, uv0, seed, mask) as numpy, the tool's draws."""
    rng = np.random.default_rng(seed)
    img0 = rng.integers(0, 255, (height, width)).astype(np.float32)
    img1 = rng.integers(0, 255, (height, width)).astype(np.float32)
    uv0 = rng.uniform([20, 20], [width - 20, height - 20],
                      (n, 2)).astype(np.float32)
    uv_seed = uv0 + rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    return img0, img1, uv0, uv_seed, np.ones(n, bool)


def measure(args, levels: int, iters: int, reps: int = REPS) -> dict:
    """One row on the tensors `args` (on one device): `profile_step`'s
    call ms and device ms, K1's own device ms and the tracked count."""
    def call():
        return lk_cuda.track(*args, levels=levels, iters=iters)

    row = profile_step.measure(call, args[0].device, reps)
    row = dict(levels=levels, iters=iters, call_ms=row["call_ms"],
               kernel_device_ms=None, device_ms=row["device_ms"],
               tracked=int(call().status.sum()))
    if args[0].device.type == "cuda":
        from ya_vo_tpu_torch.selfcheck import device_ms

        row["kernel_device_ms"] = device_ms(call, KERNEL, reps=reps,
                                            launches_per_call=1)
    return row


def run(device="cuda", iters=ITERS, levels=LEVELS, reps: int = REPS,
        **shape) -> list:
    """The rows at each of `levels` x `iters`."""
    device = require_device(device)
    args = tuple(torch.as_tensor(a).to(device) for a in inputs(**shape))
    return [measure(args, lv, it, reps) for lv in levels for it in iters]


def format_row(row: dict) -> str:
    def f(v):
        return "not measured" if v is None else f"{v:.4f} ms"
    return (f"levels={row['levels']} iters={row['iters']:3d}: call "
            f"{row['call_ms']:.4f} ms  K1 device {f(row['kernel_device_ms'])}"
            f"  call device {f(row['device_ms'])}  "
            f"(status={row['tracked']})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="*", default=list(ITERS))
    ap.add_argument("--levels", type=int, nargs="+", default=list(LEVELS))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small shapes only)")
    a = ap.parse_args(argv)
    rows = run(a.device, a.iters, a.levels, a.reps)
    if torch.device(a.device).type == "cuda":
        from ya_vo_tpu_torch.selfcheck import card_line
        print(card_line())
    for row in rows:
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
