"""Offline global refinement: full-session bundle adjustment sweeps.

Port of `ya_vo_tpu/ba/global_refine.py` onto the port's
`ba/window.solve_window`: overlapping windowed Schur-GN sweeps over ALL
keyframes (each window pinned to its first two poses so refinements chain
consistently), then the per-frame trajectory is re-expressed against the
refined keyframes (each frame keeps its original motion relative to the
latest keyframe at or before it).

The live map retires landmarks out of the sliding window and recycles
their slots, which scrubs their observations. The map archives every
retired landmark's last refined position keyed by its CREATION STAMP
(`MapStore.archive`), and each keyframe observation records the stamp of
the landmark it saw (`kf_obs_stamp`), so each window here resolves scrubbed
links through the archive and solves against its complete original
observation set. Refined archived positions are written back to the
archive so later windows and passes chain on them. Outlier-killed
landmarks were never archived and stay excluded.

Sweeps alternate direction across passes (forward, then backward) and
never straddle `window_barrier` (a monocular scale break: solving across
one would reconcile incompatible scales). Each window problem is assembled
on the host and solved on the frontend's device; its result comes back in
one host read.

Usage:
    refined_traj = global_refine(frontend)       # after a sequence run
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ya_vo_tpu_torch.ba import window as ba_window


def _archive_arrays(m):
    """Sorted (stamps, positions) snapshot of the retirement archive."""
    if not m.archive:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.float32)
    stamps, pos = m.archive.arrays()
    return stamps.copy(), pos.astype(np.float32).copy()


def _solve_window_span(fe, k0: int, k1: int, iters: int,
                       arch_stamps, arch_pos) -> None:
    """Refine keyframes [k0, k1) in place (map arrays + archive updated)."""
    m = fe.map
    bc = fe.cfg.ba
    W = fe.cfg.map.window_size
    n_real = k1 - k0
    O = m.kf_obs_uv.shape[1]

    poses_p = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    poses_p[:n_real] = m.kf_pose[k0:k1]
    uv_p = np.zeros((W, O, 2), np.float32)
    uv_p[:n_real] = m.kf_obs_uv[k0:k1]
    lm_p = np.full((W, O), -1, np.int32)
    lm_p[:n_real] = m.kf_obs_lm[k0:k1]
    st_p = np.full((W, O), -1, np.int64)
    st_p[:n_real] = m.kf_obs_stamp[k0:k1]
    ok_live = np.zeros((W, O), bool)
    ok_live[:n_real] = m.kf_obs_valid[k0:k1]
    pv = np.zeros(W, bool)
    pv[:n_real] = True

    # a live link is usable iff the slot still holds the SAME landmark
    # (stamps match — recycling reuses slot ids) and it is alive
    lm_c = np.maximum(lm_p, 0)
    ok_live = ok_live & (lm_p >= 0) \
        & m.landmark_alive[lm_c] \
        & (m.landmark_stamp[lm_c] == st_p)
    # a scrubbed link is restored through the retirement archive
    if len(arch_stamps):
        ins = np.searchsorted(arch_stamps, np.maximum(st_p, 0))
        ins = np.minimum(ins, len(arch_stamps) - 1)
        in_arch = (st_p >= 0) & (arch_stamps[ins] == st_p)
    else:
        in_arch = np.zeros_like(ok_live)
    ok_arch = (~ok_live) & (lm_p >= 0) & in_arch
    usable = ok_live | ok_arch
    if not usable.any():
        return

    # landmark universe keyed by CREATION STAMP (unique across recycling)
    keys = st_p[usable]
    uniq, counts = np.unique(keys, return_counts=True)
    L_cap = bc.max_window_landmarks
    if len(uniq) > L_cap:
        # same policy as the live backend: keep the best-constrained
        order = np.argsort(-counts, kind="stable")[:L_cap]
        uniq = np.sort(uniq[order])

    # per-key position + live-slot resolution
    live_s = st_p[ok_live]
    live_l = lm_p[ok_live]
    ls_order = np.argsort(live_s)
    live_s_sorted = live_s[ls_order]
    live_l_sorted = live_l[ls_order]
    li = np.searchsorted(live_s_sorted, uniq)
    li_c = np.minimum(li, max(len(live_s_sorted) - 1, 0))
    is_live = np.zeros(len(uniq), bool)
    slot_of = np.full(len(uniq), -1, np.int64)
    if len(live_s_sorted):
        is_live = live_s_sorted[li_c] == uniq
        slot_of[is_live] = live_l_sorted[li_c[is_live]]
    pos_of = np.zeros((len(uniq), 3), np.float32)
    pos_of[is_live] = m.landmark_pos[slot_of[is_live]]
    if len(arch_stamps):
        ai = np.searchsorted(arch_stamps, uniq)
        ai_c = np.minimum(ai, len(arch_stamps) - 1)
        from_arch = (~is_live) & (arch_stamps[ai_c] == uniq)
        pos_of[from_arch] = arch_pos[ai_c[from_arch]]

    # compact obs -> [0, len(uniq)) indices
    ci = np.searchsorted(uniq, np.maximum(st_p, 0))
    ci_c = np.minimum(ci, len(uniq) - 1)
    hit = usable & (uniq[ci_c] == st_p)
    lm_compact = np.where(hit, ci_c, -1)
    ok_p = hit
    if len(uniq) < 8:
        return
    lms_local = np.zeros((L_cap, 3), np.float32)
    lms_local[: len(uniq)] = pos_of
    lm_valid = np.zeros(L_cap, bool)
    lm_valid[: len(uniq)] = True

    dev = fe.device
    prob = ba_window.BAProblem(
        poses=torch.tensor(poses_p, device=dev),
        pose_valid=torch.tensor(pv, device=dev),
        landmarks=torch.tensor(lms_local, device=dev),
        lm_valid=torch.tensor(lm_valid, device=dev),
        obs_uv=torch.tensor(uv_p, device=dev),
        obs_lm=torch.tensor(lm_compact.astype(np.int64), device=dev),
        obs_valid=torch.tensor(ok_p, device=dev))
    # Trust-region prior on every window pose (BAConfig.
    # offline_pose_prior_weight): forward-motion monocular windows have a
    # near-null scale mode, and over 2 x passes of overlapping sweeps an
    # unconstrained ratchet compounds. The online poses being refined are
    # already BA-refined estimates, trustworthy anchors for the prior.
    res = ba_window.solve_window(
        prob, fe.cam, iters=iters, huber_delta=bc.huber_delta,
        damping=bc.damping, n_fixed_poses=min(2, n_real),
        pose_prior_weight=bc.offline_pose_prior_weight)
    out = torch.cat([res.poses.reshape(-1),
                     res.landmarks.reshape(-1)]).cpu().numpy()
    new_poses = out[:W * 16].reshape(W, 4, 4)[:n_real]
    new_lms = out[W * 16:].reshape(L_cap, 3)
    if not (np.all(np.isfinite(new_poses)) and np.all(np.isfinite(new_lms))):
        return
    m.kf_pose[k0:k1] = new_poses
    new_pos = new_lms[: len(uniq)]
    m.landmark_pos[slot_of[is_live]] = new_pos[is_live]
    if (~is_live).any():
        m.archive.update_bulk(uniq[~is_live], new_pos[~is_live])


def global_refine(fe, passes: int = 2, iters: Optional[int] = None
                  ) -> np.ndarray:
    """Run full-session BA sweeps, then return the refined trajectory
    [F, 4, 4].

    The frontend's recorded (online) trajectory is re-anchored: each frame's
    pose keeps its original motion relative to the most recent keyframe at
    or before it, while that keyframe moves to its refined pose.
    """
    m = fe.map
    iters = iters or fe.cfg.ba.iters
    W = fe.cfg.map.window_size
    n_kf = m.n_keyframes
    traj = np.stack(fe.trajectory) if fe.trajectory else np.zeros((0, 4, 4))
    if n_kf < 2 or len(traj) == 0:
        return traj

    kf_before = m.kf_pose[:n_kf].copy()
    arch_stamps, arch_pos = _archive_arrays(m)

    def refresh_arch():
        # positions were written back into m.archive; re-snapshot values
        # (keys are stable) so the next pass chains on refined geometry
        nonlocal arch_pos
        if len(arch_stamps):
            s2, p2 = m.archive.arrays()
            # archive keys are stable across passes; rows may have been
            # appended (none are removed), so realign by searchsorted
            rows = np.searchsorted(s2, arch_stamps)
            arch_pos = p2[rows].astype(np.float32)

    # never straddle a monocular scale break
    barrier = int(m.window_barrier)
    segments = [(0, barrier), (barrier, n_kf)] if 0 < barrier < n_kf \
        else [(0, n_kf)]

    stride = max(1, W // 2)
    for p in range(passes):
        for s0, s1 in segments:
            if s1 - s0 < 2:
                continue
            starts = list(range(s0, max(s1 - 1, s0 + 1), stride))
            # alternate direction: odd passes sweep backward so corrections
            # propagate both ways along the route
            if p % 2 == 1:
                starts = starts[::-1]
            for k0 in starts:
                k1 = min(k0 + W, s1)
                if k1 - k0 >= 2:
                    _solve_window_span(fe, k0, k1, iters,
                                       arch_stamps, arch_pos)
        refresh_arch()

    kf_after = m.kf_pose[:n_kf].copy()

    # re-anchor every frame against its governing keyframe
    kf_fids = m.kf_frame_id[:n_kf]
    refined = traj.copy()
    order = np.argsort(kf_fids)
    fids_sorted = kf_fids[order]
    for f in range(len(traj)):
        idx = np.searchsorted(fids_sorted, f, side="right") - 1
        if idx < 0:
            continue
        k = order[idx]
        corr = np.linalg.inv(kf_before[k]) @ kf_after[k]
        refined[f] = traj[f] @ corr
    return refined
