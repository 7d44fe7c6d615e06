"""The control comes out not correct: the plain reference one precision
below the configuration's (the score map, the blur and the LK pyramids in
bfloat16; TF32 for the geometry's matrix products) put in the program's
place fails the cell's limits, here at a tiny size on the CPU (on the card
at the cell's size: `python3 -m vo_bench.control`, PERF.md)."""

import torch

from vo_bench import compare
from vo_bench import run as bench_run
from vo_bench.reference.precision import TF32, to_tf32
from vo_bench.tests import tiny


def test_control_fails_the_limits():
    sp = tiny.spec("kitti_default.drives")
    out = bench_run.run_cell(sp, 2 ** 31 + 5, 6.0, False, device="cpu",
                             control=True)
    assert out["correct"]
    ctrl = out["control"]
    ctrl.pop("detail")
    ok, rows = compare.verdict(ctrl, sp.limits)
    assert not ok, rows
    failed = {k for k, v, lim in rows if not v <= lim}
    assert {"kp", "desc", "replay", "push"} <= failed
    # a solve's apply, where the tiny run applied one
    assert "apply" in failed or "apply" not in ctrl


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5e-3])
    y = to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2 ** -9
    assert ((y.view(torch.int32) & 0x1FFF) == 0).all()
    a, b = torch.randn(64, 3), torch.randn(3, 5)
    with TF32():
        c = a @ b
        e = torch.einsum("ij,jk->ik", a, b)
    assert torch.equal(c, to_tf32(a) @ to_tf32(b)) and torch.equal(c, e)
    assert not torch.equal(c, a @ b)
