"""Checkpoint / resume for the VO session.

Port of `ya_vo_tpu/utils/checkpoint.py` with the same npz schema, key for
key and dtype for dtype, so a checkpoint written by either package loads
into the other: the trajectory, the map store's arrays, the track table,
the state machine's status, the previous frame and the anchor keyframe's
image, keypoints and descriptors. Descriptors are stored as uint32 [K, 8]
as the JAX package stores them; the port keeps them as int32 on the device,
so they cross as a bit-for-bit view.
"""

from __future__ import annotations

import numpy as np

from ya_vo_tpu_torch.features.fast import Keypoints
from ya_vo_tpu_torch.utils.convert import tensor_from_numpy
from ya_vo_tpu_torch.worldmap.mapstore import ArchiveStore


def _np(t) -> np.ndarray:
    """A host copy of a tensor."""
    return t.detach().cpu().numpy().copy()


def _desc_np(t) -> np.ndarray:
    """Packed int32 descriptors as the uint32 [K, 8] the schema holds."""
    return _np(t).view(np.uint32)


def save_frontend(fe, path: str) -> None:
    """Write the session to `path` (npz). Resolves the frames in flight,
    drains the backend solve and copies the device track table into the
    host mirrors first, so the snapshot is consistent."""
    fe._pipe_flush()
    fe.finish()
    fe.sync_host_state()
    m = fe.map
    kp, kf_kp = fe.last_kp, fe._kf_kp
    np.savez_compressed(
        path,
        status=np.int32(fe.status.value),
        frame_id=np.int64(fe.frame_id),
        last_pose=fe.last_pose,
        rel_motion=fe.rel_motion,
        trajectory=np.stack(fe.trajectory) if fe.trajectory else
        np.zeros((0, 4, 4), np.float32),
        track_uv=fe.track_uv,
        track_lm=fe.track_lm,
        track_valid=fe.track_valid,
        n_resets=np.int32(fe.n_resets),
        # map store
        landmark_pos=m.landmark_pos[: m.n_landmarks],
        landmark_alive=m.landmark_alive[: m.n_landmarks],
        landmark_obs_count=m.landmark_obs_count[: m.n_landmarks],
        landmark_stamp=m.landmark_stamp[: m.n_landmarks],
        lm_free=np.asarray(m._free, np.int64),
        lm_stamp_counter=np.int64(m.lm_stamp_counter),
        kf_stamp_counter=np.int64(m.kf_stamp_counter),
        window_barrier=np.int64(m.window_barrier),
        kf_pose=m.kf_pose[: m.n_keyframes],
        kf_frame_id=m.kf_frame_id[: m.n_keyframes],
        kf_stamp=m.kf_stamp[: m.n_keyframes],
        kf_obs_uv=m.kf_obs_uv[: m.n_keyframes],
        kf_obs_lm=m.kf_obs_lm[: m.n_keyframes],
        kf_obs_valid=m.kf_obs_valid[: m.n_keyframes],
        kf_obs_stamp=m.kf_obs_stamp[: m.n_keyframes],
        # retirement archive (offline full-session refinement geometry)
        archive_stamps=(m.archive.arrays()[0] if m.archive
                        else np.zeros(0, np.int64)),
        archive_pos=(m.archive.arrays()[1].astype(np.float32) if m.archive
                     else np.zeros((0, 3), np.float32)),
        # last-frame context so LK and matching continue on resume
        last_img=_np(fe.last_img) if fe.last_img is not None
        else np.zeros((0, 0), np.uint8),
        # anchor keyframe context
        track_anchor_uv=fe.track_anchor_uv,
        kf_ref_inliers=np.int32(fe._kf_ref_inliers),
        anchor_kf_pose=fe._kf_pose,
        anchor_kf_img=_np(fe._kf_img) if fe._kf_img is not None
        else np.zeros((0, 0), np.uint8),
        anchor_kf_kp_uv=_np(kf_kp.uv) if kf_kp is not None
        else np.zeros((0, 2), np.float32),
        anchor_kf_kp_score=_np(kf_kp.score) if kf_kp is not None
        else np.zeros((0,), np.float32),
        anchor_kf_kp_mask=_np(kf_kp.mask) if kf_kp is not None
        else np.zeros((0,), bool),
        anchor_kf_desc=_desc_np(fe._kf_desc) if fe._kf_desc is not None
        else np.zeros((0, 8), np.uint32),
        last_kp_uv=_np(kp.uv) if kp is not None
        else np.zeros((0, 2), np.float32),
        last_kp_score=_np(kp.score) if kp is not None
        else np.zeros((0,), np.float32),
        last_kp_mask=_np(kp.mask) if kp is not None
        else np.zeros((0,), bool),
        last_desc=_desc_np(fe.last_desc) if fe.last_desc is not None
        else np.zeros((0, 8), np.uint32),
    )


def load_frontend(fe, path: str) -> None:
    """Restore a checkpoint (written by either package) into a freshly
    constructed port Frontend of the same config; images, keypoints and
    descriptors become tensors on `fe.device`, then the device tracking
    state is rebuilt from the restored host mirrors.

    Older files load with the JAX loader's fallbacks: without
    `kf_obs_stamp` the observation stamps and the archive keep the fresh
    frontend's; without `landmark_stamp` the stamps count up from 0 in
    slot order and nothing is free; without `window_barrier` the barrier
    is 0; without `track_anchor_uv` the anchor positions are the track
    table's and the rest of the anchor keyframe context keeps the fresh
    frontend's."""
    from ya_vo_tpu_torch.tracking.frontend import VOStatus

    z = np.load(path)
    dev = fe.device
    fe.status = VOStatus(int(z["status"]))
    fe.frame_id = int(z["frame_id"])
    fe.last_pose = z["last_pose"].astype(np.float32)
    fe.rel_motion = z["rel_motion"].astype(np.float32)
    fe.trajectory = [p for p in z["trajectory"]]
    fe.track_uv[:] = z["track_uv"]
    fe.track_lm[:] = z["track_lm"]
    fe.track_valid[:] = z["track_valid"]
    fe.n_resets = int(z["n_resets"])

    m = fe.map
    nl = len(z["landmark_pos"])
    nk = len(z["kf_pose"])
    m.n_landmarks = nl
    m.landmark_pos[:nl] = z["landmark_pos"]
    m.landmark_alive[:] = False
    m.landmark_alive[:nl] = z["landmark_alive"]
    m.landmark_obs_count[:nl] = z["landmark_obs_count"]
    m.n_keyframes = nk
    m.kf_pose[:nk] = z["kf_pose"]
    m.kf_frame_id[:nk] = z["kf_frame_id"]
    m.kf_valid[:] = False
    m.kf_valid[:nk] = True
    m.kf_obs_uv[:nk] = z["kf_obs_uv"]
    m.kf_obs_lm[:nk] = z["kf_obs_lm"]
    m.kf_obs_valid[:nk] = z["kf_obs_valid"]
    if "kf_obs_stamp" in z:
        m.kf_obs_stamp[:nk] = z["kf_obs_stamp"]
        arch = ArchiveStore(max(len(z["archive_stamps"]), 4) * 2)
        if len(z["archive_stamps"]):
            arch.update_bulk(z["archive_stamps"], z["archive_pos"])
        m.archive = arch
    if "landmark_stamp" in z:
        m.landmark_stamp[:nl] = z["landmark_stamp"]
        m._free = [int(i) for i in z["lm_free"]]
        m.lm_stamp_counter = int(z["lm_stamp_counter"])
        m.kf_stamp_counter = int(z["kf_stamp_counter"])
        m.kf_stamp[:nk] = z["kf_stamp"]
    else:
        m.landmark_stamp[:nl] = np.arange(nl)
        m._free = []
        m.lm_stamp_counter = nl
        m.kf_stamp_counter = nk
        m.kf_stamp[:nk] = np.arange(nk)
    m.window_barrier = (int(z["window_barrier"]) if "window_barrier" in z
                        else 0)

    def keypoints(prefix: str) -> Keypoints:
        return Keypoints(*(tensor_from_numpy(z[f"{prefix}_{k}"], dev)
                           for k in Keypoints._fields))

    if z["last_img"].size:
        fe.last_img = tensor_from_numpy(z["last_img"], dev)
        fe.last_kp = keypoints("last_kp")
        fe.last_desc = tensor_from_numpy(z["last_desc"], dev)

    if "track_anchor_uv" in z:
        fe.track_anchor_uv = z["track_anchor_uv"].copy()
        fe._kf_ref_inliers = int(z["kf_ref_inliers"])
        fe._kf_pose = z["anchor_kf_pose"].astype(np.float32)
        if z["anchor_kf_img"].size:
            fe._kf_img = tensor_from_numpy(z["anchor_kf_img"], dev)
        if z["anchor_kf_desc"].size:
            fe._kf_kp = keypoints("anchor_kf_kp")
            fe._kf_desc = tensor_from_numpy(z["anchor_kf_desc"], dev)
    else:
        fe.track_anchor_uv = fe.track_uv.copy()

    # rebuild the device-resident tracking state from the restored mirrors
    fe._push_state_to_device()
