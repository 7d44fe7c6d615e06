"""The plain reference of the host's side of the timed path, in NumPy: the
apply of a window solve to the map and the live chain, and the replay of
a step's record into the host's map and track table. Frozen copies of
the port's `_apply_ba_result` and of the replay in `_finish_track`
(synchronous and asynchronous forms, `apply_mode="push"`), importing
nothing of the program.

Both follow the program from its own host state before the stage (a copy
the harness took) and its own inputs to the stage (the solve's output,
the step's record), as the step comparison does. `q` rounds what the
apply computes; the reference keeps float32, the control passes bfloat16.
The retirement archive (`MapStore.transform_archive`) is not followed.
"""

from __future__ import annotations

import numpy as np
import torch


def same(x):
    return x


def bf16(x):
    """An array rounded to bfloat16 (kept as float32)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _center(T):
    return -T[:3, :3].T @ T[:3, 3]


def apply(pre: dict, a: dict, bc: dict, q=same) -> dict:
    """The state after the apply of one solve: {"applied", "kf_pose",
    "landmark_pos", "last_pose", "kf_pose_live"}. `pre` is the host state
    before it (see `vo_bench.audit.host_state`), `a` the apply's arguments
    (new_poses, new_lms, slots, used, n_real, anchor_old, kf_stamp_snap,
    lm_stamp_snap, stale_floor), `bc` the configuration's `ba`."""
    out = dict(applied=False, kf_pose=pre["kf_pose"].copy(),
               landmark_pos=pre["landmark_pos"].copy(),
               last_pose=pre["last_pose"].copy(),
               kf_pose_live=pre["kf_pose_live"].copy())
    new_poses = a["new_poses"][: a["n_real"]]
    new_lms = a["new_lms"]
    if not (np.all(np.isfinite(new_poses)) and np.all(np.isfinite(new_lms))):
        return out
    kf_snap, lm_snap = a["kf_stamp_snap"], a["lm_stamp_snap"]
    if kf_snap is not None:
        n_stale = pre["kf_stamp_counter"] - kf_snap
        if n_stale > max(bc["max_stale_keyframes"] + pre["stale_relax"],
                         a["stale_floor"]):
            return out
    # the divergence gate
    anchor_old = a["anchor_old"]
    inst = float(np.linalg.norm(pre["rel_motion"][:3, 3]))
    steps = pre["recent_steps"]
    step = float(np.median(steps)) if steps else inst
    step = max(step, inst * 0.25, 0.1 * pre["peak_step"])
    corr_try = np.linalg.inv(anchor_old) @ new_poses[-1]
    t_corr = float(np.linalg.norm(_center(new_poses[-1])
                                  - _center(anchor_old)))
    cosang = (np.trace(corr_try[:3, :3]) - 1.0) / 2.0
    r_corr = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    if (t_corr > bc["max_correction_steps"] * max(step, 1e-3)
            or r_corr > bc["max_correction_rot_deg"]):
        return out
    out["applied"] = True
    kf, lm = out["kf_pose"], out["landmark_pos"]
    used = a["used"]
    stamp, alive = pre["landmark_stamp"], pre["landmark_alive"]
    kf[a["slots"]] = q(new_poses)
    if lm_snap is not None:
        keep = (stamp[used] < lm_snap) & alive[used]
        lm[used[keep]] = q(new_lms[: len(used)][keep])
    else:
        lm[used] = q(new_lms[: len(used)])
    corr = q((np.linalg.inv(q(anchor_old)) @ q(new_poses[-1]))
             .astype(np.float32))
    inv_c = q(np.linalg.inv(corr))
    if kf_snap is not None:
        sl = np.nonzero(pre["kf_stamp"] >= kf_snap)[0]
        if sl.size:
            kf[sl] = q(kf[sl] @ corr)
    if lm_snap is not None:
        fresh = np.nonzero((stamp >= lm_snap) & alive)[0]
        if fresh.size:
            lm[fresh] = q(lm[fresh] @ inv_c[:3, :3].T + inv_c[:3, 3])
    # the live table's landmarks outside the solve move with the anchor
    upd = np.zeros(len(lm), bool)
    upd[used] = True
    track_lm = pre["track_lm"]
    tl = np.maximum(track_lm, 0)
    bound = lm_snap if lm_snap is not None else np.inf
    stranded = (pre["track_valid"] & (track_lm >= 0) & ~upd[tl]
                & (stamp[tl] < bound))
    if stranded.any():
        idx = track_lm[stranded]
        lm[idx] = q(lm[idx] @ inv_c[:3, :3].T + inv_c[:3, 3])
    out["last_pose"] = q((pre["last_pose"] @ corr).astype(np.float32))
    out["kf_pose_live"] = q((pre["kf_pose_live"] @ corr).astype(np.float32))
    return out


APPLIED = ("kf_pose", "landmark_pos", "last_pose", "kf_pose_live")


def widest(a: dict, b: dict, keys=APPLIED) -> float:
    """The widest elementwise gap between two states over `keys`."""
    return max((float(np.abs(np.asarray(a[k], np.float64)
                             - np.asarray(b[k], np.float64)).max())
                if np.size(a[k]) else 0.0) for k in keys)


def replay_mismatch(pre: dict, post: dict, r: dict, q=same) -> float:
    """The share of the track table's slots whose host entry after a
    step's replay differs from the plain replay of its record `r`, plus 1
    where the keyframe it inserts differs (landmarks refused for capacity
    count as differing). A keyframe (`post["kf"]`): the rejected tracks'
    landmarks killed, the kept slots' landmarks and positions unchanged,
    the merged slots on new live landmarks at the record's positions
    (`r_pts[src]`), the track table rebuilt from the record's anchors and
    valid flags, and a keyframe at the record's pose holding that table;
    else the kept slots' positions taken from the record and the others'
    dropped. `q` rounds the merged positions (the control)."""
    keep = np.asarray(r["keep"], bool)
    K = len(keep)
    old_lm = pre["track_lm"]
    if not post["kf"]:
        valid = pre["track_valid"] & keep
        uv = np.where(keep[:, None], r["track_uv"], pre["track_uv"])
        bad = ((post["track_valid"] != valid)
               | (post["track_lm"] != old_lm)
               | (post["track_uv"] != uv).any(-1))
        return float(bad.sum()) / K
    n = int(r["n_new"])
    d, s = np.asarray(r["dest"][:n]), np.asarray(r["src"][:n])
    merged = np.zeros(K, bool)
    merged[d] = True
    new_lm = post["track_lm"]
    kept = keep & ~merged
    bad = np.zeros(K, bool)
    bad |= kept & ((new_lm != old_lm)
                   | (post["lm_pos"] != pre["lm_pos"]).any(-1))
    bad |= ~keep & ~merged & (new_lm != -1)
    ids = new_lm[d]
    ok_new = (ids >= 0) & post["lm_alive"][d] \
        & ~np.isin(ids, old_lm[kept])
    ok_new &= (post["lm_pos"][d] == q(np.asarray(r["r_pts"])[s])).all(-1)
    if len(np.unique(ids)) != len(ids):
        ok_new[:] = False
    bad[d] |= ~ok_new
    lm = np.where(keep, old_lm, -1)
    lm[d] = ids
    valid = np.asarray(r["valid"], bool) & (lm >= 0)
    bad |= post["track_valid"] != valid
    bad |= (post["track_uv"] != r["anchor_uv"]).any(-1)
    # the rejected tracks' landmarks are dead, unless a merge reused the
    # slot
    rej = np.asarray(r["flow_ok"], bool) & ~np.asarray(r["inlier"], bool) \
        & (old_lm >= 0)
    bad |= rej & post["old_alive"] & ~np.isin(old_lm, ids)
    share = float(bad.sum()) / K
    m = post["kf_obs_lm"].shape[0]
    kf_ok = (post["n_keyframes"] == pre["n_keyframes"] + 1
             and post["kf_frame_id"] == post["frame_id"]
             and np.array_equal(post["kf_pose_new"], post["last_pose"])
             and np.array_equal(post["last_pose"],
                                np.asarray(r["pose"], np.float32))
             and np.array_equal(post["kf_obs_lm"], new_lm[:m])
             and np.array_equal(post["kf_obs_uv"], post["track_uv"][:m])
             and np.array_equal(post["kf_obs_valid"],
                                post["track_valid"][:m] & (new_lm[:m] >= 0)))
    return share + (0.0 if kf_ok else 1.0)
