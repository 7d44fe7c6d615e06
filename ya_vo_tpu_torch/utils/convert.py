"""Carry reference state across: numpy arrays taken from the JAX package
(`np.asarray` on its side) into the port's tensors and stores.

`frontend_state_from_numpy` loads a JAX frontend's complete tracking state
into a port `Frontend`, so one fused step can be compared on identical
state: the VO counterpart of loading a model's weights. The map comes
across as arrays (`map_arrays`) and is rebuilt as the port's own
`MapStore` (`mapstore_from_numpy`).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.features.fast import Keypoints
from ya_vo_tpu_torch.worldmap.mapstore import MapStore

# the device chain of the fused step (None allowed for the two images)
DEVICE_KEYS = ("_d_anchor_uv", "_d_track_uv", "_d_track_valid", "_d_lm_pos",
               "_d_pose", "_d_rel", "_d_kf_desc", "_d_kf_uv", "_d_kf_mask",
               "_d_kf_pose", "_d_kf_img", "_d_prev_img", "_d_kf_ref",
               "_d_fsk", "_d_slot_stamp")
# host mirrors and counters copied as numpy arrays or Python scalars
# (`_recent_steps` becomes the frontend's bounded deque again)
HOST_KEYS = ("track_uv", "track_lm", "track_valid", "track_anchor_uv",
             "last_pose", "rel_motion", "_kf_pose", "_kf_ref_inliers",
             "_frames_since_kf", "frame_id", "n_resets", "n_relocalizations",
             "n_ba_runs", "n_ba_discarded", "n_ba_lm_dropped",
             "_kf_since_ba", "_last_ba_ms", "_recent_steps", "_peak_step",
             "_session_epoch", "_last_good_frame", "_resolved_fid")
# tensors of the previous frame and the anchor keyframe; *_kp entries are
# (uv, score, mask) tuples
TENSOR_KEYS = ("last_img", "last_kp", "last_desc", "_kf_img", "_kf_kp",
               "_kf_desc")
# a MapStore's state: its capacities, its arrays and counters, and the
# retirement archive as (stamps, positions)
MAP_SIZES = ("max_landmarks", "max_keyframes", "max_obs_per_kf")
MAP_KEYS = ("landmark_pos", "landmark_alive", "landmark_obs_count",
            "landmark_stamp", "n_landmarks", "_free", "lm_stamp_counter",
            "n_recycled", "n_retired", "n_evicted_keyframes",
            "n_dropped_landmarks", "kf_pose", "kf_frame_id", "kf_valid",
            "kf_stamp", "n_keyframes", "kf_stamp_counter", "window_barrier",
            "kf_obs_uv", "kf_obs_lm", "kf_obs_valid", "kf_obs_stamp")


def offsets_from_numpy(offsets: np.ndarray, device=None) -> torch.Tensor:
    """BRIEF test table [B, 4] -> int64 tensor for `brief.describe`."""
    return torch.as_tensor(np.asarray(offsets), dtype=torch.int64,
                           device=device)


def camera_from_numpy(cam) -> Camera:
    """Any (fx, fy, cx, cy) camera, e.g. the JAX package's, -> port Camera."""
    return Camera.create(*(float(np.asarray(c)) for c in cam[:4]))


def tensor_from_numpy(x, device) -> torch.Tensor:
    """A numpy array as the port keeps it on `device`: packed uint32
    descriptors as their int32 bits, int32 counters and slot stamps as
    int64."""
    a = np.array(x)
    if a.dtype == np.uint32:           # packed descriptors: same bits
        a = a.view(np.int32)
    if a.dtype == np.int32 and a.ndim <= 1:
        a = a.astype(np.int64)          # counters and slot stamps
    return torch.as_tensor(a, device=device)


def map_arrays(store) -> dict:
    """Numpy copies of a map store's state (MAP_SIZES, MAP_KEYS and the
    archive), read from its attributes; works on the JAX package's store."""
    out = {k: int(getattr(store, k)) for k in MAP_SIZES}
    out.update({k: np.array(getattr(store, k)) for k in MAP_KEYS})
    out["archive_stamps"], out["archive_pos"] = (
        np.array(a) for a in store.archive.arrays())
    return out


def mapstore_from_numpy(arrays: dict) -> MapStore:
    """A port MapStore holding the state in `arrays` (see `map_arrays`)."""
    m = MapStore(**{k: int(arrays[k]) for k in MAP_SIZES})
    for k in MAP_KEYS:
        v = np.array(arrays[k])
        if k == "_free":                 # the recycled-slot stack, in order
            v = [int(x) for x in v]
        elif v.ndim == 0:
            v = int(v)
        else:
            v = v.astype(getattr(m, k).dtype)
        setattr(m, k, v)
    if len(arrays["archive_stamps"]):
        m.archive.update_bulk(arrays["archive_stamps"], arrays["archive_pos"])
    return m


def frontend_state_from_numpy(fe, arrays: dict) -> None:
    """Load `arrays` into the port frontend `fe`, in place: DEVICE_KEYS,
    HOST_KEYS, TENSOR_KEYS, "status" (the VOStatus name) and "map" (the
    map's arrays, `map_arrays`)."""
    from ya_vo_tpu_torch.tracking.frontend import VOStatus

    dev = fe.device
    for k in DEVICE_KEYS:
        setattr(fe, k, None if arrays[k] is None
                else tensor_from_numpy(arrays[k], dev))
    for k in HOST_KEYS:
        v = np.array(arrays[k])
        if k == "_recent_steps":
            v = deque(v.tolist(), maxlen=fe._recent_steps.maxlen)
        elif v.ndim == 0:
            v = v.item()
        setattr(fe, k, v)
    for k in TENSOR_KEYS:
        v = arrays[k]
        if k.endswith("_kp"):
            v = Keypoints(*(tensor_from_numpy(x, dev) for x in v))
        elif v is not None:
            v = tensor_from_numpy(v, dev)
        setattr(fe, k, v)
    fe.status = VOStatus[arrays["status"]]
    fe.map = mapstore_from_numpy(arrays["map"])
    fe._state_dirty = False
