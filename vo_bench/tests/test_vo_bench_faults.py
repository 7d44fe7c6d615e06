"""A run with the timed path broken underneath comes out not correct, for
each fault the cell can have: a step that returns its state unchanged, a
solve's apply that leaves the state unchanged, a push that leaves the
device's table as it was, half of the batch left out, an answer altered
where it is produced (a descriptor bit, LK's tracked positions all
moved a little or a handful moved a pixel, the host's merge of a step's
new landmarks). (A cell on one chip has no exchange between chips to
leave out.) At a tiny size on the CPU, through the whole run but the look
for a chip."""

import pytest
import torch

from vo_bench.tests import tiny
from ya_vo_tpu_torch.features import brief
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.worldmap.mapstore import MapStore


def _unchanged_pose(orig):
    def solve(T_init, pts_w, uv, mask, cam, **kw):
        res = orig(T_init, pts_w, uv, mask, cam, **kw)
        return res._replace(pose=T_init.clone())
    return solve


def _unapplied(orig):
    def apply(self, *a, **kw):
        return None
    return apply


def _stale_push(orig):
    def push(self):
        old = getattr(self, "_d_lm_pos", None)
        orig(self)
        if old is not None and old.shape == self._d_lm_pos.shape:
            self._d_lm_pos = old
    return push


def _half_tracked(orig):
    def track(*a, **kw):
        flow = orig(*a, **kw)
        half = torch.arange(flow.status.shape[0],
                            device=flow.status.device) % 2 == 0
        return flow._replace(status=flow.status & half)
    return track


def _moved_flow(orig):
    def track(*a, **kw):
        flow = orig(*a, **kw)
        return flow._replace(uv=flow.uv + 0.005)
    return track


def _few_moved(orig):
    def track(*a, **kw):
        flow = orig(*a, **kw)
        # the first five live slots, 1 px off in each coordinate
        few = flow.status & (torch.cumsum(flow.status.long(), 0) <= 5)
        return flow._replace(uv=flow.uv + few[:, None].to(flow.uv.dtype))
    return track


def _flipped_bit(orig):
    def describe(*a, **kw):
        desc, mask = orig(*a, **kw)
        return desc ^ 1, mask
    return describe


def _moved_merge(orig):
    def add(self, positions, mask):
        return orig(self, positions + 0.01, mask)
    return add


FAULTS = {
    "state_unchanged": (pose_solver, "solve_pose", _unchanged_pose),
    "apply_unchanged": (Frontend, "_apply_ba_result", _unapplied),
    "push_stale": (Frontend, "_push_map_state_to_device", _stale_push),
    "half_the_batch": (lk_cuda, "track", _half_tracked),
    "answer_altered": (brief, "describe", _flipped_bit),
    "flow_altered": (lk_cuda, "track", _moved_flow),
    "flow_few_altered": (lk_cuda, "track", _few_moved),
    "merge_altered": (MapStore, "add_landmarks", _moved_merge),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    mod, name, wrap = FAULTS[fault]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    # a window long enough for the first route's 12 frames and its solves
    out = tiny.run("kitti_default.drives", seconds=12.0)
    checks = out["checks"]
    assert not out["correct"], checks
    # the run compared its samples, and a number failed its limit
    assert checks.pop("samples")["value"] > 0
    assert any(not c["value"] <= c["limit"] for c in checks.values())
    if fault == "flow_altered":
        assert checks["flow_moved"]["value"] > checks["flow_moved"]["limit"]
    if fault == "flow_few_altered":
        assert checks["flow_px"]["value"] > checks["flow_px"]["limit"]
