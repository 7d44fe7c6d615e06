"""Copies of what the timed path computes, for the comparison after the
window.

The harness wraps six methods on each frontend instance of the window
(never the program's code):
- `_dispatch_track`, to copy the step's inputs (`Frontend._step_args`:
  the frame, the LK template, the track table, the keyframe context, the
  frame number and the free capacity) on the device, in stream order,
  before the step of a sampled frame runs; and, at the first dispatch
  after a sampled push, the device state that dispatch reads;
- `_finish_track`, to keep the record that the resolved dispatch of a
  sampled frame copied to the host, with its keypoints and descriptors,
  and the host's track table before the record's replay;
- `_run_window_ba`, which the replay of a keyframe calls last, to copy the
  host's table, map entries and keyframe as the replay left them (a
  frame that is no keyframe: after `_finish_track`);
- `_solve`, to keep the problem and the result of the sampled window
  solves;
- `_apply_ba_result`, to copy the host state (map, track table, live
  chain and the gates' inputs) before and after the apply of a sampled
  solve;
- `_push_state_to_device`, to copy the host state that a sampled push
  copies to the device: the first push of a session whose bootstrap is
  sampled, and the first after each sampled apply.
For the window it also wraps the program's
`geometry.ransac.estimate_two_view`, through which the frontend
bootstraps, to keep the first bootstrap of each sampled session. A redone
frame is copied at each dispatch and the dispatch that resolves it is
kept. The samples are drawn from the seed before the window opens, over
the whole window.
"""

from __future__ import annotations

import threading

import numpy as np


def host_state(fe) -> dict:
    """The host state an apply reads and writes (copies)."""
    m = fe.map
    n_kf, n_lm = m.n_keyframes, m.n_landmarks
    return dict(
        kf_pose=m.kf_pose[:n_kf].copy(), kf_stamp=m.kf_stamp[:n_kf].copy(),
        kf_stamp_counter=m.kf_stamp_counter,
        landmark_pos=m.landmark_pos[:n_lm].copy(),
        landmark_stamp=m.landmark_stamp[:n_lm].copy(),
        landmark_alive=m.landmark_alive[:n_lm].copy(),
        track_lm=fe.track_lm.copy(), track_valid=fe.track_valid.copy(),
        last_pose=fe.last_pose.copy(), kf_pose_live=fe._kf_pose.copy(),
        rel_motion=fe.rel_motion.copy(),
        recent_steps=list(fe._recent_steps), peak_step=fe._peak_step,
        stale_relax=fe._stale_relax, n_ba_runs=fe.n_ba_runs)


def table_state(fe, old_lm=None) -> dict:
    """The host's track table with its landmarks' positions and liveness
    (copies); with `old_lm`, also the liveness of those landmarks."""
    m = fe.map
    tl = np.maximum(fe.track_lm, 0)
    out = dict(track_lm=fe.track_lm.copy(),
               track_valid=fe.track_valid.copy(),
               track_uv=fe.track_uv.copy(), lm_pos=m.landmark_pos[tl].copy(),
               lm_alive=m.landmark_alive[tl] & (fe.track_lm >= 0),
               n_keyframes=m.n_keyframes, last_pose=fe.last_pose.copy())
    if old_lm is not None:
        out["old_alive"] = m.landmark_alive[np.maximum(old_lm, 0)].copy()
        k, n = m.n_keyframes - 1, min(len(fe.track_lm), m.max_obs_per_kf)
        out.update(kf_pose_new=m.kf_pose[k].copy(),
                   kf_frame_id=int(m.kf_frame_id[k]),
                   kf_obs_lm=m.kf_obs_lm[k, :n].copy(),
                   kf_obs_uv=m.kf_obs_uv[k, :n].copy(),
                   kf_obs_valid=m.kf_obs_valid[k, :n].copy())
    return out


class Audit:
    """The samples of one run: `frames` a set of (session, frame id),
    `solve_ids` a set of indices among the window's solves."""

    def __init__(self, frames, solve_ids, boot_sessions=()):
        self.frames = set(frames)
        self.solve_ids = set(solve_ids)
        self.boot_sessions = set(boot_sessions)
        self.steps = {}        # (session, frame id) -> copies
        self.solves = []       # (problem, (poses, landmarks) numpy)
        self.applies = []      # the sampled solves' applies
        self.pushes = []       # the sampled pushes
        self.boots = {}        # session -> the first bootstrap's copies
        self.n_solves = 0
        self.session = None
        self._sampled = {}     # id(poses) -> index in self.solves
        self._lock = threading.Lock()

    def watch_bootstraps(self, ransac):
        """Wrap the program's `ransac.estimate_two_view` (the module the
        frontend calls it through) to keep the first bootstrap of each
        sampled session: its inputs, the generator's state before its
        draw, and its result. Returns the function it replaced."""
        orig = ransac.estimate_two_view

        def two_view(uv1, uv2, mask, K, generator=None, **kw):
            take = (self.session in self.boot_sessions
                    and self.session not in self.boots
                    and generator is not None
                    and kw.get("sample_idx") is None)
            state = generator.get_state() if take else None
            res = orig(uv1, uv2, mask, K, generator, **kw)
            if take:
                self.boots[self.session] = dict(
                    uv1=uv1.clone(), uv2=uv2.clone(), mask=mask.clone(),
                    K=K.clone(), state=state, R=res.R.clone(),
                    t=res.t.clone(), inlier=res.inlier_mask.clone())
            return res

        ransac.estimate_two_view = two_view
        return orig

    def attach(self, fe, session: int, record_keys) -> None:
        self.session = session
        dispatch, finish, solve, apply, run_ba, push = (
            fe._dispatch_track, fe._finish_track, fe._solve,
            fe._apply_ba_result, fe._run_window_ba, fe._push_state_to_device)
        watch = dict(arm=session in self.boot_sessions, push=None,
                     replay=None)

        def _push():
            push()
            if watch["arm"]:
                watch["arm"] = False
                watch["push"] = dict(host=dict(
                    pose=fe.last_pose.copy(), kf_pose=fe._kf_pose.copy(),
                    lm_pos=fe.map.landmark_pos[np.maximum(fe.track_lm, 0)]
                    .copy(), valid=fe.track_valid.copy()))

        def _dispatch(img, pre=None, prev_override=None):
            entry = watch["push"]
            if entry is not None:
                watch["push"] = None
                entry["device"] = dict(
                    pose=fe._d_pose.clone(), kf_pose=fe._d_kf_pose.clone(),
                    lm_pos=fe._d_lm_pos.clone(),
                    valid=fe._d_track_valid.clone())
                self.pushes.append(entry)
            snap = None
            if (session, fe.frame_id) in self.frames:
                snap = [a.clone() for a in fe._step_args(img, prev_override)]
            rec = dispatch(img, pre, prev_override)
            if snap is not None:
                rec["audit"] = snap
            return rec

        def _finish(rec):
            snap = rec.get("audit")
            if snap is None:
                return finish(rec)
            replay = dict(pre=table_state(fe), post=None,
                          frame_id=rec["frame_id"])
            watch["replay"] = replay
            res = finish(rec)
            watch["replay"] = None
            if replay["post"] is None and not res.reset:
                replay["post"] = dict(table_state(fe), kf=False)
            self.steps[(session, rec["frame_id"])] = dict(
                inputs=snap, kp_uv=rec["kp"].uv, kp_mask=rec["kp"].mask,
                desc=rec["desc"], replay=replay,
                record=dict(zip(record_keys, rec["pull"][0])))
            return res

        def _run_ba(force=False):
            replay = watch["replay"]
            if replay is not None and not force:
                watch["replay"] = None
                replay["post"] = dict(
                    table_state(fe, replay["pre"]["track_lm"]), kf=True,
                    frame_id=replay["frame_id"])
            return run_ba(force)

        def _solve(prob):
            out = solve(prob)
            with self._lock:
                i = self.n_solves
                self.n_solves += 1
                if i in self.solve_ids:
                    self._sampled[id(out[0][0])] = len(self.solves)
                    self.solves.append((prob, out[0]))
            return out

        def _apply(new_poses, new_lms, slots, used, n_real, anchor_old, ms,
                   kf_stamp_snap=None, lm_stamp_snap=None, stale_floor=0):
            with self._lock:
                i = self._sampled.pop(id(new_poses), None)
            entry = None
            if i is not None:
                entry = dict(solve=i, pre=host_state(fe), args=dict(
                    new_poses=new_poses, new_lms=new_lms,
                    slots=np.array(slots), used=np.array(used),
                    n_real=n_real, anchor_old=np.array(anchor_old),
                    kf_stamp_snap=kf_stamp_snap,
                    lm_stamp_snap=lm_stamp_snap, stale_floor=stale_floor))
            out = apply(new_poses, new_lms, slots, used, n_real, anchor_old,
                        ms, kf_stamp_snap=kf_stamp_snap,
                        lm_stamp_snap=lm_stamp_snap, stale_floor=stale_floor)
            if entry is not None:
                entry["post"] = host_state(fe)
                self.applies.append(entry)
                watch["arm"] = True
            return out

        (fe._dispatch_track, fe._finish_track, fe._solve,
         fe._apply_ba_result, fe._run_window_ba,
         fe._push_state_to_device) = (
            _dispatch, _finish, _solve, _apply, _run_ba, _push)


def draw(spec: dict, seed: int, seconds: float, lo: int, hi: int):
    """The run's samples from its seed, over the whole window: the sessions
    a window of `seconds` reaches are taken as `seconds *
    spec["sessions_per_s"]`, its solves as `seconds * spec["solves_per_s"]`.
    Returns `spec["frames"]` (session, frame id) pairs, frame ids in [lo,
    hi), each in another session where there are enough;
    `spec["solves"]` indices among the window's solves; and
    `spec["bootstraps"]` sessions whose first bootstrap is kept."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    n_sessions = max(1, int(seconds * spec["sessions_per_s"]))
    n_frames = spec["frames"]
    sessions = np.sort(rng.choice(n_sessions, n_frames,
                                  replace=n_sessions < n_frames))
    frames = sorted({(int(s), int(f)) for s, f in
                     zip(sessions, rng.integers(lo, hi, n_frames))})
    n_solves = max(spec["solves"], int(seconds * spec["solves_per_s"]))
    solves = rng.choice(n_solves, spec["solves"], replace=False)
    boots = rng.choice(n_sessions, min(spec["bootstraps"], n_sessions),
                       replace=False)
    return frames, [int(x) for x in solves], [int(x) for x in boots]
