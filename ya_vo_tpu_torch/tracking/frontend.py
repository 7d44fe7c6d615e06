"""Pipeline runtime: the INIT / TRACKING / RESET state machine over a fused
step.

Port of `ya_vo_tpu/tracking/frontend.py`: the two-view bootstrap, the fused
per-frame tracking step (FAST + BRIEF extraction, then the state-dependent
body: projection-seeded LK from the previous frame, robust pose GN,
speculative replenishment against the anchor keyframe and the on-device
keyframe decision and track-table merge), the host replay of each frame's
record into the numpy `MapStore`, the synchronous sliding-window BA with
its divergence gate and push apply, the reset path (PnP relocalization
against the surviving map, else the unit-scale two-view bootstrap chained
on the last pose), and the pipelined driver with its redo of in-flight
frames after a state push.

Tracking state lives as tensors on `device`. Each frame's record is copied
with `non_blocking` copies into pinned host memory behind a CUDA event, so
the host resolves a frame `pipeline_depth - 1` frames after dispatching it
without stalling the card. When a resolve rebuilds host state (bootstrap,
reset, relocalization, BA apply), the state is pushed and every in-flight
frame is re-dispatched against it, reusing its extraction: the pipelined
driver's results are the synchronous driver's, bit for bit. Options
outside the port raise `NotImplementedError` instead of running a partial
version.
"""

from __future__ import annotations

import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ya_vo_tpu_torch.ba import window as ba_window
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.features import brief, fast, matching
from ya_vo_tpu_torch.geometry import ransac
from ya_vo_tpu_torch.geometry.triangulation import triangulate_fast
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver
from ya_vo_tpu_torch.utils.convert import offsets_from_numpy
from ya_vo_tpu_torch.worldmap.mapstore import MapStore

_log = logging.getLogger("ya_vo_tpu_torch.frontend")


def _not_yet(item: int) -> str:
    return f"not ported yet; queued in ROADMAP.md (Queue 1, item {item})"


# names of the per-frame record the host pulls, in the step's output order
RECORD_KEYS = ("n_flow", "n_ba", "n_kp", "n_matches", "is_kf", "n_new",
               "pose", "keep", "flow_ok", "inlier", "dest", "src",
               "anchor_uv", "valid", "r_pts", "track_uv")


class VOStatus(enum.Enum):
    INIT = 0
    TRACKING = 1
    RESET = 2


@dataclass
class FrameResult:
    frame_id: int
    status: str
    pose_wc: np.ndarray
    n_keypoints: int = 0
    n_matches: int = 0
    n_flow_inliers: int = 0
    n_ba_inliers: int = 0
    n_new_landmarks: int = 0
    is_keyframe: bool = False
    reset: bool = False
    timings_ms: dict = field(default_factory=dict)


def _check_supported(config: VOConfig) -> None:
    if config.camera_type != "mono":
        raise ValueError(f"camera_type={config.camera_type!r} unsupported: "
                         f"this pipeline is monocular")
    ba = config.ba
    if ba.enabled:
        if ba.asynchronous:
            raise NotImplementedError(
                f"asynchronous window BA (ba.asynchronous=True) is "
                f"{_not_yet(8)}")
        if ba.apply_mode != "push":
            raise NotImplementedError(
                f"ba.apply_mode={ba.apply_mode!r} is {_not_yet(9)}")
        if ba.distributed != "off" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                f"ba.distributed={ba.distributed!r} with "
                f"{torch.cuda.device_count()} CUDA devices visible (the "
                f"landmark-sharded solver) is {_not_yet(7)}; set "
                f"ba.distributed='off' or expose one device")
    if config.tracking.lk_template != "prev":
        raise NotImplementedError(
            f"lk_template={config.tracking.lk_template!r} is {_not_yet(11)}")
    if config.features.photometric_norm:
        raise NotImplementedError(
            f"photometric_norm=True is {_not_yet(11)}")


def detect_kwargs(fc) -> dict:
    """`fast.detect`'s parameters from a `FeatureConfig`; the border keeps
    the blurred BRIEF patch inside the image."""
    return dict(max_keypoints=fc.max_keypoints, threshold=fc.fast_threshold,
                arc_length=fc.fast_arc_length, nms_radius=fc.nms_radius,
                border=fc.brief_patch_radius + fc.blur_ksize // 2 + 4,
                harris_k=fc.harris_k)


def _center(T: np.ndarray) -> np.ndarray:
    """Camera centre of a world->camera pose."""
    return -T[:3, :3].T @ T[:3, 3]


class Frontend:
    def __init__(self, config: VOConfig, cam: Camera, device=None):
        _check_supported(config)
        # geometry runs in true float32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
        self.cam = cam
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the frontend runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        self.K = cam.K(self.device)
        fc = config.features
        self._offsets = offsets_from_numpy(
            brief.make_offsets(fc.brief_n_bits, fc.brief_patch_radius,
                               fc.brief_seed), self.device)
        self._generator = torch.Generator().manual_seed(config.ransac.seed)
        self.map = MapStore(max_landmarks=config.map.max_landmarks,
                            max_keyframes=config.map.max_keyframes,
                            max_obs_per_kf=fc.max_keypoints)
        self.status = VOStatus.INIT
        self.frame_id = -1
        self.n_resets = 0
        self.n_relocalizations = 0
        self._last_good_frame = -1   # newest frame that tracked/bootstrapped

        # host mirrors of the previous frame and the track table
        self.last_img: Optional[torch.Tensor] = None
        self.last_kp: Optional[fast.Keypoints] = None
        self.last_desc: Optional[torch.Tensor] = None
        self.last_pose = np.eye(4, dtype=np.float32)    # world->camera
        self.rel_motion = np.eye(4, dtype=np.float32)   # T_curr = rel @ T_last
        K_cap = fc.max_keypoints
        self.track_uv = np.zeros((K_cap, 2), np.float32)
        self.track_lm = np.full(K_cap, -1, np.int32)
        self.track_valid = np.zeros(K_cap, bool)
        self.track_anchor_uv = np.zeros((K_cap, 2), np.float32)
        # last-keyframe context
        self._kf_desc: Optional[torch.Tensor] = None
        self._kf_kp: Optional[fast.Keypoints] = None
        self._kf_pose = np.eye(4, dtype=np.float32)
        self._kf_img: Optional[torch.Tensor] = None
        self._kf_ref_inliers = 0
        self._frames_since_kf = 0
        self.trajectory: List[np.ndarray] = []
        self.results: List[FrameResult] = []

        # window BA state
        self.n_ba_runs = 0
        self.n_ba_discarded = 0
        self.n_ba_lm_dropped = 0      # capacity-cap landmark drops
        self._kf_since_ba = 0
        self._last_ba_ms = 0.0
        self.ba_ms: List[float] = []  # wall time of every solve, read included
        self._last_ba_prob = None     # the newest window problem solved
        # recent moving step lengths (their median scales the divergence
        # gate) and a slowly decaying speed peak (its floor)
        self._recent_steps = deque(maxlen=20)
        self._peak_step = 0.0
        self._session_epoch = 0       # bumped when keyframe slots shift
        self._resolved_fid = 0        # newest frame id resolved on the host
        self.n_redone = 0             # in-flight dispatches redone

        # device-resident tracking state (see _push_state_to_device)
        dev = self.device
        self._d_anchor_uv = torch.zeros((K_cap, 2), device=dev)
        self._d_track_uv = torch.zeros((K_cap, 2), device=dev)
        self._d_track_valid = torch.zeros(K_cap, dtype=torch.bool, device=dev)
        self._d_lm_pos = torch.zeros((K_cap, 3), device=dev)
        self._d_pose = torch.eye(4, device=dev)
        self._d_rel = torch.eye(4, device=dev)
        self._d_kf_desc = torch.zeros((K_cap, fc.brief_n_bits // 32),
                                      dtype=torch.int32, device=dev)
        self._d_kf_uv = torch.zeros((K_cap, 2), device=dev)
        self._d_kf_mask = torch.zeros(K_cap, dtype=torch.bool, device=dev)
        self._d_kf_pose = torch.eye(4, device=dev)
        self._d_kf_img: Optional[torch.Tensor] = None
        self._d_prev_img: Optional[torch.Tensor] = None
        self._d_kf_ref = torch.zeros((), device=dev)
        self._d_fsk = torch.zeros((), dtype=torch.int64, device=dev)
        self._d_slot_stamp = torch.zeros(K_cap, dtype=torch.int64, device=dev)
        # set by bootstrap, reset, relocalization and BA apply: the device
        # state must be rebuilt from the host mirrors before the next
        # dispatch
        self._state_dirty = False
        self._pending_q: deque = deque()

    # ------------------------------------------------------------------ #
    def _to_device(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device, non_blocking=True)
        t = torch.as_tensor(np.asarray(img))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _np(self, t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _extract(self, img: torch.Tensor):
        """FAST + BRIEF: the state-independent half of a frame."""
        fc = self.cfg.features
        kp = fast.detect(img, **detect_kwargs(fc))
        blurred = brief.gaussian_blur(img.to(torch.float32), fc.blur_ksize,
                                      fc.blur_sigma)
        desc, _ = brief.describe(blurred, kp.uv, kp.mask, self._offsets)
        return kp, desc

    def _step_body(self, kp, desc, kf_img, img_curr, prev_img, track_uv,
                   anchor_uv, track_mask, lm_pos, pose, rel, kf_desc, kf_uv,
                   kf_mask, kf_pose, kf_ref, fsk, slot_stamp, frame_no: int,
                   cap_left: int):
        """The state-dependent rest of the fused frame on extraction
        (kp, desc): LK + pose GN, speculative replenishment and the
        keyframe decision and merge. Returns (state_out, record) with no
        host sync."""
        tc = self.cfg.tracking
        mc = self.cfg.matching
        cam = self.cam
        K_cap = self.cfg.features.max_keypoints

        T_prior = rel @ pose
        seed, z = cam.project(lie.transform_points(T_prior, lm_pos))
        # frame-to-frame template: seed = last tracked position plus the
        # projected motion delta
        seed_prev, z_prev = cam.project(lie.transform_points(pose, lm_pos))
        use = track_mask & (z > 0.25) & (z_prev > 0.25)
        seed = torch.where(use[:, None], track_uv + (seed - seed_prev),
                           track_uv)
        flow = lk_cuda.track(
            prev_img, img_curr, track_uv, seed, use, levels=tc.lk_levels,
            half=tc.lk_window // 2, iters=tc.lk_iters, eps=tc.lk_eps,
            max_residual=tc.lk_max_residual, rel_residual=tc.lk_rel_residual)
        n_flow = flow.status.sum()

        solve = pose_solver.solve_pose(
            T_prior, lm_pos, flow.uv, flow.status, cam,
            iters=tc.gn_rounds * tc.gn_iters_per_round,
            huber_delta=tc.huber_delta, chi2_threshold=tc.chi2_threshold)
        n_ba = solve.n_inliers
        keep = flow.status & solve.inlier_mask
        new_track_uv = torch.where(keep[:, None], flow.uv, anchor_uv)
        new_rel = solve.pose @ torch.linalg.inv_ex(pose)[0]

        # speculative replenishment against the anchor keyframe
        m = matching.match(kf_desc, desc, kf_mask, kp.mask,
                           abs_threshold=mc.abs_threshold,
                           cross_check=mc.cross_check)
        r_uv2 = kp.uv[m.idx2]
        d2 = ((r_uv2[:, None, :] - new_track_uv[None, :, :]) ** 2).sum(-1)
        near = ((d2 < 144.0) & keep[None, :]).any(1)
        P1 = self.K @ kf_pose[:3, :4]
        P2 = self.K @ solve.pose[:3, :4]
        r_pts, r_valid = triangulate_fast(P1, P2, kf_uv, r_uv2,
                                          m.mask & ~near)
        c_kf = -kf_pose[:3, :3].T @ kf_pose[:3, 3]
        c_now = -solve.pose[:3, :3].T @ solve.pose[:3, 3]
        if tc.max_depth_baseline_ratio > 0:
            baseline = torch.linalg.norm(c_now - c_kf)
            z_cur = lie.transform_points(solve.pose, r_pts)[:, 2]
            r_valid = r_valid & (z_cur < tc.max_depth_baseline_ratio
                                 * baseline)
        n_matches = m.mask.sum()
        n_kp = kp.mask.sum()

        # keyframe decision
        n_valid_new = r_valid.sum()
        n_free = K_cap - keep.sum()
        n_new = torch.minimum(n_valid_new, n_free).clamp(max=cap_left)
        decay_floor = tc.min_ba_inliers + max(20, tc.min_ba_inliers // 5)
        want_kf = n_ba < torch.clamp(
            (tc.keyframe_min_inlier_ratio * kf_ref).to(torch.int64),
            min=decay_floor)
        if tc.keyframe_max_translation > 0:
            want_kf = want_kf | (torch.linalg.norm(c_now - c_kf)
                                 > tc.keyframe_max_translation)
        if tc.keyframe_max_rotation_deg > 0:
            R_rel = solve.pose[:3, :3] @ kf_pose[:3, :3].T
            cos_r = torch.clamp((torch.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0)
            want_kf = want_kf | (torch.rad2deg(torch.arccos(cos_r))
                                 > tc.keyframe_max_rotation_deg)
        urgent = n_ba < decay_floor
        want_kf = want_kf & (urgent | (fsk + 1 >= tc.min_keyframe_gap))
        gates_ok = (n_flow >= tc.min_flow_inliers) & (n_ba >= tc.min_ba_inliers)
        is_kf = (want_kf & gates_ok & (n_matches >= 8) & (n_valid_new >= 4)
                 & (n_new > 0))

        # merged post-keyframe table: kept slots stay, new features fill
        # free slots in ascending order (stable argsorts; the host replays
        # this assignment from dest/src/n_new)
        dest = torch.argsort(keep.to(torch.int32), stable=True)
        src = torch.argsort((~r_valid).to(torch.int32), stable=True)
        write_ok = torch.arange(K_cap, device=keep.device) < n_new
        anchor_kf = new_track_uv.index_put((dest,), torch.where(
            write_ok[:, None], r_uv2[src], new_track_uv[dest]))
        lm_kf = lm_pos.index_put((dest,), torch.where(
            write_ok[:, None], r_pts[src], lm_pos[dest]))
        valid_kf = keep.index_put((dest,), keep[dest] | write_ok)
        stamp_kf = slot_stamp.index_put((dest,), torch.where(
            write_ok, frame_no, slot_stamp[dest]))

        anchor_o = torch.where(is_kf, anchor_kf, anchor_uv)
        valid_o = torch.where(is_kf, valid_kf, keep)
        lm_o = torch.where(is_kf, lm_kf, lm_pos)
        track_uv_o = torch.where(is_kf, anchor_kf, new_track_uv)
        state_out = (
            anchor_o, valid_o, lm_o, solve.pose, new_rel,
            torch.where(is_kf, desc, kf_desc),
            torch.where(is_kf, kp.uv, kf_uv),
            torch.where(is_kf, kp.mask, kf_mask),
            torch.where(is_kf, solve.pose, kf_pose),
            torch.where(is_kf, img_curr, kf_img),
            torch.where(is_kf, (n_ba + n_new).to(kf_ref.dtype), kf_ref),
            torch.where(is_kf, 0, fsk + 1),
            track_uv_o,
            torch.where(is_kf, stamp_kf, slot_stamp),
            img_curr)
        record = (n_flow, n_ba, n_kp, n_matches, is_kf, n_new, solve.pose,
                  keep, flow.status, solve.inlier_mask, dest, src, anchor_o,
                  valid_o, r_pts, track_uv_o)
        return state_out, record

    def _pull(self, record):
        """Start the record's device->host copies; returns (host tensors,
        event). On the card the copies land in pinned memory behind the
        event; on the CPU they are plain copies."""
        if self.device.type != "cuda":
            return list(record), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in record]
        for h, t in zip(host, record):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ------------------------------------------------------------------ #
    def _push_map_state_to_device(self) -> None:
        """Rebuild the device track table and keyframe context from copies
        of the host mirrors (everything except the pose chain)."""
        tl = np.maximum(self.track_lm, 0)
        alive = self.track_valid & (self.track_lm >= 0) \
            & self.map.landmark_alive[tl]
        self.track_valid = alive
        dev = self.device
        self._d_anchor_uv = torch.tensor(self.track_anchor_uv, device=dev)
        self._d_track_uv = torch.tensor(self.track_uv, device=dev)
        self._d_track_valid = torch.tensor(alive, device=dev)
        self._d_lm_pos = torch.tensor(self.map.landmark_pos[tl], device=dev)
        if self._kf_desc is not None:
            self._d_kf_desc = self._kf_desc
            self._d_kf_uv = self._kf_kp.uv
            self._d_kf_mask = self._kf_kp.mask
            self._d_kf_pose = torch.tensor(self._kf_pose, device=dev)

    def _push_state_to_device(self) -> None:
        """Rebuild ALL device tracking state from the host mirrors."""
        self._push_map_state_to_device()
        dev = self.device
        self._d_pose = torch.tensor(self.last_pose, device=dev)
        self._d_rel = torch.tensor(self.rel_motion, device=dev)
        if self._kf_img is not None:
            self._d_kf_img = self._kf_img
        # the next dispatch takes self.last_img as its LK template; redone
        # in-flight frames take the one their first dispatch used
        self._d_prev_img = None
        self._d_kf_ref = torch.tensor(float(self._kf_ref_inliers),
                                      device=dev)
        self._d_fsk = torch.tensor(self._frames_since_kf, device=dev)
        self._d_slot_stamp = torch.zeros_like(self._d_slot_stamp)
        self._state_dirty = False

    # ------------------------------------------------------------------ #
    def process(self, img) -> FrameResult:
        """Feed one grayscale frame, fully synchronously."""
        self.frame_id += 1
        return self._process_sync(self._to_device(img))

    def _process_sync(self, img_dev: torch.Tensor) -> FrameResult:
        t0 = time.perf_counter()
        if self.status == VOStatus.INIT or self.last_img is None:
            kp, desc = self._extract(img_dev)
            res = self._handle_init(img_dev, kp, desc)
            res.n_keypoints = int(kp.count())
            if res.is_keyframe:         # bootstrap succeeded
                self._kf_img = img_dev
                self.track_anchor_uv = self.track_uv.copy()
        else:
            if self._state_dirty:
                self._push_state_to_device()
            rec = self._dispatch_track(img_dev)
            kp, desc = rec["kp"], rec["desc"]
            res = self._finish_track(rec)
        res.timings_ms["frame"] = (time.perf_counter() - t0) * 1e3
        if res.reset and res.is_keyframe:
            # reset bootstrap: record the new anchor keyframe image
            self._kf_img = img_dev
            self.track_anchor_uv = self.track_uv.copy()
        if self._state_dirty:
            self._push_state_to_device()
        self.last_img = img_dev
        self.last_kp, self.last_desc = kp, desc
        self.trajectory.append(self.last_pose.copy())
        self.results.append(res)
        return res

    def _handle_init(self, img, kp, desc) -> FrameResult:
        if self.last_img is None:
            # first frame: identity pose, wait for a second view
            self.last_pose = np.eye(4, dtype=np.float32)
            return FrameResult(self.frame_id, "INIT", self.last_pose.copy())
        if self.map.n_keyframes > 0:
            # re-initializing after an outage: prefer scale-consistent PnP
            # against the existing map over a unit-scale bootstrap
            reloc = self._relocalize(kp, desc)
            if reloc is not None:
                n_inl = self._apply_relocalization(kp, desc, reloc)
                return FrameResult(self.frame_id, "TRACKING",
                                   self.last_pose.copy(), n_ba_inliers=n_inl,
                                   is_keyframe=True)
        ok, info = self._two_view_bootstrap(kp, desc, chain_on_last=False)
        if ok:
            self.status = VOStatus.TRACKING
            self._kf_desc, self._kf_kp = desc, kp
            self._kf_pose = self.last_pose.copy()
        return FrameResult(self.frame_id, "TRACKING" if ok else "INIT",
                           self.last_pose.copy(), **info)

    def _two_view_bootstrap(self, kp, desc, chain_on_last: bool):
        """Match last <-> current descriptors, robust E, triangulate and
        populate the map at unit baseline. `chain_on_last` names the reset
        form (the new motion chained on the last pose); the maths is the
        same either way."""
        mc = self.cfg.matching
        m = matching.match(self.last_desc, desc, self.last_kp.mask, kp.mask,
                           abs_threshold=mc.abs_threshold,
                           cross_check=mc.cross_check)
        n_matches = int(m.count())
        info = dict(n_matches=n_matches)
        if n_matches < 8:
            return False, info
        uv1 = self.last_kp.uv
        uv2 = kp.uv[m.idx2]
        rc = self.cfg.ransac
        tv = ransac.estimate_two_view(
            uv1, uv2, m.mask, self.K, self._generator,
            n_hypotheses=rc.n_hypotheses, sample_size=rc.sample_size,
            inlier_threshold_px=rc.inlier_threshold_px)
        n_inl = int(tv.n_inliers)
        info["n_ba_inliers"] = n_inl
        if n_inl < max(8, self.cfg.tracking.min_flow_inliers):
            return False, info

        # camera1 = last frame; x2 = R x1 + t (unit baseline)
        T_rel = self._np(lie.rt_to_mat(tv.R, tv.t))
        T1 = self.last_pose
        T2 = (T_rel @ T1).astype(np.float32)
        T1_inv = lie.se3_inverse(torch.as_tensor(T1)).numpy()
        pts_w = self._np(tv.points) @ T1_inv[:3, :3].T + T1_inv[:3, 3]
        valid = self._np(tv.points_valid)

        # lifecycle: a bootstrap deep into a long run must find room
        if self.map.free_landmark_capacity < int(valid.sum()):
            self.map.retire_out_of_window(self.cfg.map.window_size)
            self.map.recycle_dead()
        if self.map.n_keyframes + 2 > self.map.max_keyframes:
            self.map.evict_oldest_keyframes(
                max(2, self.map.max_keyframes // 4))
        lm_idx = self.map.add_landmarks(pts_w, valid)
        n_new = int((lm_idx >= 0).sum())
        info["n_new_landmarks"] = n_new
        if n_new < self.cfg.tracking.min_flow_inliers:
            return False, info
        # the map's metric scale breaks here: fence the BA window so no
        # solve mixes keyframes of both scales (a no-op on an empty map)
        if self.map.n_keyframes > 0:
            self.map.mark_scale_break()

        uv2_np = self._np(uv2)
        self.map.insert_keyframe(self.frame_id - 1, T1, self._np(uv1),
                                 lm_idx, lm_idx >= 0)
        self.map.insert_keyframe(self.frame_id, T2, uv2_np, lm_idx,
                                 lm_idx >= 0)
        self._session_epoch += 1
        self._state_dirty = True
        # track table for the CURRENT frame (becomes "last" after process())
        self.track_uv.fill(0)
        self.track_lm.fill(-1)
        self.track_valid.fill(False)
        n = min(len(uv2_np), len(self.track_uv))
        self.track_uv[:n] = uv2_np[:n]
        self.track_lm[:n] = lm_idx[:n]
        self.track_valid[:n] = lm_idx[:n] >= 0
        self.rel_motion = (T2 @ np.linalg.inv(T1)).astype(np.float32)
        self.last_pose = T2
        self._kf_ref_inliers = n_new
        self._frames_since_kf = 0
        self._last_good_frame = self.frame_id
        info["is_keyframe"] = True
        return True, info

    # ------------------------------------------------------------------ #
    def _dispatch_track(self, img, pre=None, prev_override=None) -> dict:
        """Launch the fused step on the device-resident state and commit the
        state chain; the record's copies to the host start here and are
        read in _finish_track. `pre` = (kp, desc) reuses an earlier
        extraction of `img` (a redo); `prev_override` is the LK template
        image that dispatch used."""
        t0 = time.perf_counter()
        if prev_override is not None:
            prev_img = prev_override
        elif self._d_prev_img is not None:
            prev_img = self._d_prev_img
        else:
            prev_img = self.last_img if self.last_img is not None else img
        kp, desc = self._extract(img) if pre is None else pre
        state_out, record = self._step_body(
            kp, desc, self._d_kf_img, img, prev_img, self._d_track_uv,
            self._d_anchor_uv, self._d_track_valid, self._d_lm_pos,
            self._d_pose, self._d_rel, self._d_kf_desc, self._d_kf_uv,
            self._d_kf_mask, self._d_kf_pose, self._d_kf_ref, self._d_fsk,
            self._d_slot_stamp, self.frame_id,
            self.map.free_landmark_capacity)
        (self._d_anchor_uv, self._d_track_valid, self._d_lm_pos,
         self._d_pose, self._d_rel, self._d_kf_desc, self._d_kf_uv,
         self._d_kf_mask, self._d_kf_pose, self._d_kf_img, self._d_kf_ref,
         self._d_fsk, self._d_track_uv, self._d_slot_stamp,
         self._d_prev_img) = state_out
        return dict(frame_id=self.frame_id, img=img, prev_img=prev_img,
                    kp=kp, desc=desc, prev_kp=self.last_kp,
                    prev_desc=self.last_desc, pull=self._pull(record), t0=t0)

    def _finish_track(self, rec: dict) -> FrameResult:
        """Evaluate the state-machine gates and replay the device-made
        keyframe decision into the host map store; a failed gate resets."""
        tc = self.cfg.tracking
        host, event = rec["pull"]
        if event is not None:
            event.synchronize()
        r = dict(zip(RECORD_KEYS, (h.numpy() for h in host)))
        kp, desc = rec["kp"], rec["desc"]
        n_flow, n_ba, n_kp = int(r["n_flow"]), int(r["n_ba"]), int(r["n_kp"])
        t_step = (time.perf_counter() - rec["t0"]) * 1e3
        if n_flow < tc.min_flow_inliers or n_ba < tc.min_ba_inliers:
            # tracking failed: bootstrap from rec's PREDECESSOR frame pair
            # (self.last_* may already hold a newer dispatched frame)
            self.last_kp, self.last_desc = rec["prev_kp"], rec["prev_desc"]
            res = self._reset(kp, desc, n_matches=0, n_flow=n_flow,
                              n_ba=n_ba)
            self.last_kp, self.last_desc = kp, desc
            self.last_img = rec["img"]
            res.n_keypoints = n_kp
            res.timings_ms["step"] = t_step
            return res

        prev_pose = self.last_pose
        self.last_pose = r["pose"].astype(np.float32)
        self.rel_motion = (self.last_pose @ np.linalg.inv(prev_pose)) \
            .astype(np.float32)
        # the divergence gate's scale: only MOVING steps enter the median
        # (more than 5% of it, or any while it is empty), and a speed peak
        # that halves in ~700 frames
        step = float(np.linalg.norm(self.rel_motion[:3, 3]))
        if (not self._recent_steps
                or step > 0.05 * float(np.median(self._recent_steps))):
            self._recent_steps.append(step)
        self._peak_step = max(self._peak_step * 0.999, step)

        is_kf = bool(r["is_kf"])
        n_new = int(r["n_new"]) if is_kf else 0
        self._frames_since_kf += 1
        self._last_good_frame = rec["frame_id"]
        self._resolved_fid = max(self._resolved_fid, rec["frame_id"])
        if is_kf:
            keep = r["keep"]
            old_lm = self.track_lm
            # demote landmarks tracked by LK but rejected by the pose solve
            self.map.kill_landmarks(old_lm[r["flow_ok"] & ~r["inlier"]])
            if self.map.free_landmark_capacity < max(
                    2 * n_new, self.map.max_landmarks // 8):
                self.map.retire_out_of_window(self.cfg.map.window_size,
                                              protected=old_lm[keep])
                self.map.recycle_dead(protected=old_lm[keep])
            # replay the device merge: new landmarks enter the map in the
            # slot order the device assigned
            d, s = r["dest"][:n_new], r["src"][:n_new]
            lm_ids = self.map.add_landmarks(r["r_pts"][s],
                                            np.ones(n_new, bool))
            new_lm = np.where(keep, old_lm, -1).astype(np.int32)
            new_lm[d] = lm_ids
            self.track_lm = new_lm
            self.track_uv = r["anchor_uv"].copy()
            self.track_valid = r["valid"] & (new_lm >= 0)
            self.track_anchor_uv = self.track_uv.copy()
            if self.map.n_keyframes >= self.map.max_keyframes:
                self.map.evict_oldest_keyframes(
                    max(1, self.map.max_keyframes // 4),
                    protected_landmarks=new_lm[self.track_valid])
                self._session_epoch += 1
            self.map.insert_keyframe(rec["frame_id"], self.last_pose,
                                     self.track_uv, self.track_lm,
                                     self.track_valid)
            self._kf_desc, self._kf_kp = desc, kp
            self._kf_pose = self.last_pose.copy()
            self._kf_img = rec["img"]
            self._kf_ref_inliers = n_ba + n_new
            self._frames_since_kf = 0
            self._run_window_ba()
        else:
            # keep the host mirrors at the resolved frontier: a push
            # rebuilds the device table from them
            keep = r["keep"]
            self.track_valid = self.track_valid & keep
            self.track_uv = np.where(keep[:, None], r["track_uv"],
                                     self.track_uv)
        return FrameResult(
            rec["frame_id"], "TRACKING", self.last_pose.copy(),
            n_keypoints=n_kp, n_matches=int(r["n_matches"]),
            n_flow_inliers=n_flow, n_ba_inliers=n_ba, n_new_landmarks=n_new,
            is_keyframe=is_kf,
            timings_ms={"step": t_step,
                        "ba": self._last_ba_ms if is_kf else 0.0})

    # ------------------------------------------------------------------ #
    def _run_window_ba(self) -> None:
        """Synchronous sliding-window BA over the active keyframe window
        every `every_n_keyframes` keyframes; the result is applied through
        `_apply_ba_result`."""
        bc = self.cfg.ba
        if not bc.enabled or self.map.n_keyframes < bc.min_keyframes:
            return
        self._kf_since_ba += 1
        if self._kf_since_ba < bc.every_n_keyframes:
            return
        self._kf_since_ba = 0
        job = self._build_window_problem()
        if job is None:
            return
        prob, slots, used, n_real = job
        self._last_ba_prob = prob
        anchor_old = self.map.kf_pose[slots[-1]].copy()
        t0 = time.perf_counter()
        res = ba_window.solve_window(
            prob, self.cam, iters=bc.iters, huber_delta=bc.huber_delta,
            damping=bc.damping, n_fixed_poses=2,
            pose_prior_weight=bc.pose_prior_weight)
        new_poses, new_lms = self._np(res.poses), self._np(res.landmarks)
        ms = (time.perf_counter() - t0) * 1e3
        self.ba_ms.append(ms)
        self._apply_ba_result(new_poses, new_lms, slots, used, n_real,
                              anchor_old, ms)

    def _build_window_problem(self):
        """Snapshot the active window into a fixed-shape, landmark-compacted
        BAProblem on the device. Returns (prob, slots, used, n_real) or
        None."""
        bc = self.cfg.ba
        W = self.cfg.map.window_size
        slots, poses, obs_uv, obs_lm, obs_valid = self.map.active_window(W)
        n_real = len(slots)
        if n_real < bc.min_keyframes:
            return None
        # pad the window to the static shape [W, O]
        O = obs_uv.shape[1]
        poses_p = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        poses_p[:n_real] = poses
        uv_p = np.zeros((W, O, 2), np.float32)
        uv_p[:n_real] = obs_uv
        lm_p = np.full((W, O), -1, np.int32)
        lm_p[:n_real] = obs_lm
        ok_p = np.zeros((W, O), bool)
        ok_p[:n_real] = obs_valid
        pv = np.zeros(W, bool)
        pv[:n_real] = True

        # compact: only the window's landmarks enter the problem
        L_cap = bc.max_window_landmarks
        used, n_drop, n_drop_obs = ba_window.select_window_landmarks(
            lm_p, ok_p, self.map.landmark_alive, L_cap)
        if n_drop:
            self.n_ba_lm_dropped += n_drop
            _log.warning(
                "window BA landmark cap: dropping the %d least-observed of "
                "%d window landmarks (%d observations, "
                "max_window_landmarks=%d)", n_drop, len(used) + n_drop,
                n_drop_obs, L_cap)
        remap = np.full(self.map.max_landmarks, -1, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        lm_compact = np.where(lm_p >= 0, remap[np.maximum(lm_p, 0)], -1)
        ok_p = ok_p & (lm_compact >= 0)
        lms_local = np.zeros((L_cap, 3), np.float32)
        lms_local[: len(used)] = self.map.landmark_pos[used]
        lm_valid = np.zeros(L_cap, bool)
        lm_valid[: len(used)] = True

        dev = self.device
        prob = ba_window.BAProblem(
            poses=torch.tensor(poses_p, device=dev),
            pose_valid=torch.tensor(pv, device=dev),
            landmarks=torch.tensor(lms_local, device=dev),
            lm_valid=torch.tensor(lm_valid, device=dev),
            obs_uv=torch.tensor(uv_p, device=dev),
            obs_lm=torch.tensor(lm_compact.astype(np.int64), device=dev),
            obs_valid=torch.tensor(ok_p, device=dev))
        return prob, slots, used, n_real

    def _apply_ba_result(self, new_poses, new_lms, slots, used, n_real,
                         anchor_old, ms) -> None:
        """Apply a synchronous solve: the finite check and the divergence
        gate, then write back the window's poses and landmarks, re-anchor
        the live chain and the landmarks outside the window by the anchor
        keyframe's correction, and mark the device state dirty (push)."""
        new_poses = new_poses[:n_real]
        if not (np.all(np.isfinite(new_poses))
                and np.all(np.isfinite(new_lms))):
            return
        # divergence gate: a correction of the anchor keyframe's camera
        # CENTRE by more than max_correction_steps (median) step lengths,
        # or a rotation past max_correction_rot_deg, means the solve
        # diverged
        inst = float(np.linalg.norm(self.rel_motion[:3, 3]))
        step = float(np.median(self._recent_steps)) \
            if self._recent_steps else inst
        step = max(step, inst * 0.25, 0.1 * self._peak_step)
        corr_try = np.linalg.inv(anchor_old) @ new_poses[-1]
        t_corr = float(np.linalg.norm(_center(new_poses[-1])
                                      - _center(anchor_old)))
        cosang = (np.trace(corr_try[:3, :3]) - 1.0) / 2.0
        r_corr = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        bc = self.cfg.ba
        if (t_corr > bc.max_correction_steps * max(step, 1e-3)
                or r_corr > bc.max_correction_rot_deg):
            self.n_ba_discarded += 1
            _log.warning(
                "discarding sync BA result: correction too large to apply "
                "(|t|=%.3f vs step %.3f, rot=%.2f deg)", t_corr, step,
                r_corr)
            return
        self._last_ba_ms = ms
        self.n_ba_runs += 1

        # write back, then re-anchor: T_live' = T_live anchor_old^-1 anchor_new
        self.map.update_keyframe_poses(slots, new_poses)
        self.map.landmark_pos[used] = new_lms[: len(used)]
        corr = (np.linalg.inv(anchor_old) @ new_poses[-1]).astype(np.float32)
        inv_c = np.linalg.inv(corr)
        # live-table landmarks outside the solve stay consistent with the
        # corrected live pose by the same rigid move (X' = corr^-1 X)
        upd = np.zeros(self.map.max_landmarks, bool)
        upd[used] = True
        tl = np.maximum(self.track_lm, 0)
        stranded = self.track_valid & (self.track_lm >= 0) & ~upd[tl]
        if stranded.any():
            idx = self.track_lm[stranded]
            pts = self.map.landmark_pos[idx]
            self.map.landmark_pos[idx] = pts @ inv_c[:3, :3].T + inv_c[:3, 3]
        # the retirement archive rides the same re-anchor
        self.map.transform_archive(inv_c)
        # rel_motion is invariant under the right-multiplied correction
        self.last_pose = (self.last_pose @ corr).astype(np.float32)
        self._kf_pose = (self._kf_pose @ corr).astype(np.float32)
        self._state_dirty = True

    # ------------------------------------------------------------------ #
    def _relocalize(self, kp, desc):
        """Scale-consistent recovery: PnP of the current frame against the
        surviving map. The frame's descriptors are matched against the
        anchor keyframe's (K3), each match is lifted to 3-D through the
        track table by the nearest anchor position, and the robust pose GN
        runs from up to four priors (the last motion extrapolated over the
        gap, one step, none, and one step more).

        Returns (pose, uv, lm_idx, inlier_mask, n_inliers, (kf_uv, uv) of
        all matches) or None."""
        if self._kf_desc is None or self._kf_kp is None:
            return None
        mc = self.cfg.matching
        tc = self.cfg.tracking
        m = matching.match(self._kf_desc, desc, self._kf_kp.mask, kp.mask,
                           abs_threshold=mc.abs_threshold,
                           cross_check=mc.cross_check)
        mmask = self._np(m.mask)
        idx2 = self._np(m.idx2)
        if mmask.sum() < 12:
            return None

        # anchor-keyframe keypoint -> track-table slot by the nearest
        # anchor position, over every slot that had a landmark at the
        # anchor keyframe
        kf_uv = self._np(self._kf_kp.uv)
        live = self.track_lm >= 0
        live &= self.map.landmark_alive[np.maximum(self.track_lm, 0)]
        r_assoc = 4.0
        K_cap = self.cfg.features.max_keypoints
        pts_w = np.zeros((K_cap, 3), np.float32)
        uv_cur = np.zeros((K_cap, 2), np.float32)
        lm_sel = np.full(K_cap, -1, np.int32)
        uv2 = self._np(kp.uv)
        live_idx = np.nonzero(live)[0]
        mi_all = np.nonzero(mmask)[0]
        n = 0
        if live_idx.size and mi_all.size:
            q = kf_uv[mi_all]                           # [M, 2]
            anchors = self.track_anchor_uv[live_idx]    # [L, 2]
            d2 = ((q[:, None, :] - anchors[None, :, :]) ** 2).sum(-1)
            jbest = np.argmin(d2, axis=1)
            ok = d2[np.arange(len(mi_all)), jbest] < r_assoc * r_assoc
            sel = live_idx[jbest[ok]]                   # track-table slots
            n = int(ok.sum())
            lm_hit = self.track_lm[sel]
            pts_w[:n] = self.map.landmark_pos[lm_hit]
            uv_cur[:n] = uv2[idx2[mi_all[ok]]]
            lm_sel[:n] = lm_hit
        # acceptance: a quarter of the tracking gate (the chi2 gate inside
        # the robust GN rejects false poses)
        min_inl = max(15, tc.min_ba_inliers // 6)
        if n < min_inl:
            return None

        gap = max(1, self.frame_id - self._last_good_frame)
        dev = self.device
        obs_mask = torch.as_tensor(np.arange(K_cap) < n, device=dev)
        pts_t = torch.as_tensor(pts_w, device=dev)
        uv_t = torch.as_tensor(uv_cur, device=dev)
        best = None
        for k in dict.fromkeys([gap, 1, 0, gap + 1]):
            T_prior = np.linalg.matrix_power(
                self.rel_motion, k).astype(np.float32) @ self.last_pose
            solve = pose_solver.solve_pose(
                torch.as_tensor(T_prior, device=dev), pts_t, uv_t, obs_mask,
                self.cam, iters=tc.gn_rounds * tc.gn_iters_per_round,
                huber_delta=tc.huber_delta, chi2_threshold=tc.chi2_threshold)
            n_inl = int(solve.n_inliers)
            if best is None or n_inl > best[0]:
                best = (n_inl, solve)
            if n_inl >= max(2 * min_inl, int(0.6 * n)):
                break  # confidently relocalized; stop probing priors
        n_inl, solve = best
        if n_inl < min_inl:
            return None
        mi = np.nonzero(mmask)[0]
        return (self._np(solve.pose).astype(np.float32), uv_cur, lm_sel,
                self._np(solve.inlier_mask), n_inl,
                (kf_uv[mi], uv2[idx2[mi]]))

    def _apply_relocalization(self, kp, desc, reloc) -> int:
        """Commit a PnP relocalization: pose, track table, a refill of the
        remaining matches triangulated at the recovered metric pose, anchor
        keyframe context and keyframe insertion. Returns the inliers."""
        pose, uv_cur, lm_sel, inl, n_inl, (kf_uv_m, uv2_m) = reloc
        self.n_relocalizations += 1
        _log.info("frame %d: PnP relocalization with %d inliers",
                  self.frame_id, n_inl)
        old_kf_pose = self._kf_pose.copy()
        prev_pose = self.trajectory[-1] if self.trajectory \
            else self.last_pose
        self.last_pose = pose
        self.rel_motion = (pose @ np.linalg.inv(prev_pose)).astype(np.float32)
        self.track_uv = uv_cur.copy()
        self.track_lm = lm_sel.copy()
        self.track_valid = inl & (lm_sel >= 0)
        self.track_anchor_uv = uv_cur.copy()

        # refill: triangulate the remaining matches at metric scale
        K_np = self._np(self.K)
        dev = self.device
        P1 = torch.as_tensor(K_np @ old_kf_pose[:3, :4], device=dev)
        P2 = torch.as_tensor(K_np @ pose[:3, :4], device=dev)
        ok_m = np.ones(len(kf_uv_m), bool)
        # skip matches that duplicate an accepted PnP correspondence
        acc = uv_cur[self.track_valid]
        if len(acc):
            d2 = ((uv2_m[:, None, :] - acc[None, :, :]) ** 2).sum(-1)
            ok_m &= d2.min(axis=1) > 144.0
        pts, valid = triangulate_fast(
            P1, P2, torch.as_tensor(kf_uv_m, device=dev),
            torch.as_tensor(uv2_m, device=dev),
            torch.as_tensor(ok_m, device=dev))
        pts, valid = self._np(pts), self._np(valid) & ok_m
        tc = self.cfg.tracking
        if tc.max_depth_baseline_ratio > 0:
            baseline = float(np.linalg.norm(_center(pose)
                                            - _center(old_kf_pose)))
            z_cur = (pts @ pose[:3, :3].T + pose[:3, 3])[:, 2]
            valid &= z_cur < tc.max_depth_baseline_ratio * max(baseline, 1e-6)
        free = np.nonzero(~self.track_valid)[0]
        take = np.nonzero(valid)[0][: len(free)]
        if take.size:
            if self.map.free_landmark_capacity < take.size:
                self.map.retire_out_of_window(
                    self.cfg.map.window_size,
                    protected=self.track_lm[self.track_valid])
                self.map.recycle_dead(
                    protected=self.track_lm[self.track_valid])
            ids = self.map.add_landmarks(pts[take], np.ones(take.size, bool))
            dst = free[: take.size][ids >= 0]
            src = take[ids >= 0]
            self.track_uv[dst] = uv2_m[src]
            self.track_anchor_uv[dst] = uv2_m[src]
            self.track_lm[dst] = ids[ids >= 0]
            self.track_valid[dst] = True
        if self.map.n_keyframes >= self.map.max_keyframes:
            self.map.evict_oldest_keyframes(
                max(1, self.map.max_keyframes // 4),
                protected_landmarks=self.track_lm[self.track_valid])
        # fence the BA window at the relocalization: the PnP pose is only
        # loosely consistent with the keyframes before the outage
        self.map.mark_scale_break()
        self.map.insert_keyframe(self.frame_id, self.last_pose,
                                 self.track_uv, self.track_lm,
                                 self.track_valid)
        self._session_epoch += 1
        self._state_dirty = True
        self.status = VOStatus.TRACKING
        self._kf_desc, self._kf_kp = desc, kp
        self._kf_pose = self.last_pose.copy()
        self._kf_ref_inliers = int(self.track_valid.sum())
        self._frames_since_kf = 0
        self._last_good_frame = self.frame_id
        return n_inl

    def _reset(self, kp, desc, n_matches=0, n_flow=0, n_ba=0) -> FrameResult:
        """Tracking failed: PnP relocalization against the surviving map,
        else a two-view bootstrap chained (at unit scale) on the last good
        pose, else INIT (the pose is held until a bootstrap succeeds)."""
        self.n_resets += 1
        self._state_dirty = True  # the device chain holds the failed frame
        reloc = self._relocalize(kp, desc)
        if reloc is not None:
            n_inl = self._apply_relocalization(kp, desc, reloc)
            return FrameResult(
                self.frame_id, "RESET", self.last_pose.copy(),
                n_matches=n_matches, n_flow_inliers=n_flow,
                n_ba_inliers=n_inl, reset=True, is_keyframe=True)
        ok, info = self._two_view_bootstrap(kp, desc, chain_on_last=True)
        if not ok:
            self.status = VOStatus.INIT
        else:
            self.status = VOStatus.TRACKING
            self._kf_desc, self._kf_kp = desc, kp
            self._kf_pose = self.last_pose.copy()
        return FrameResult(
            self.frame_id, "RESET", self.last_pose.copy(),
            n_flow_inliers=n_flow, n_ba_inliers=n_ba, reset=True,
            **{k: v for k, v in info.items()
               if k in ("n_matches", "n_new_landmarks", "is_keyframe")})

    # ------------------------------------------------------------------ #
    def run(self, frames, pipelined: bool = True) -> np.ndarray:
        """Drive a whole sequence; returns [F, 4, 4] world->camera poses.
        The next frame's upload is issued before the current one is
        processed; with `pipelined`, gates resolve pipeline_depth - 1
        frames after dispatch."""
        it = iter(frames)
        nxt = next(it, None)
        pending = self._to_device(nxt) if nxt is not None else None
        while pending is not None:
            current = pending
            nxt = next(it, None)
            pending = self._to_device(nxt) if nxt is not None else None
            if pipelined:
                self._pipe_step(current)
            else:
                self.process(current)
        self._pipe_flush()
        if not self.trajectory:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.trajectory)

    def _pipe_step(self, img_dev: torch.Tensor) -> None:
        """Dispatch this frame's step, then resolve the oldest in-flight
        frame once pipeline_depth frames are queued. Bootstrap frames drain
        the queue and run synchronously."""
        self.frame_id += 1
        img_dev = self._to_device(img_dev)
        if (self.status != VOStatus.TRACKING or self.last_img is None
                or self._kf_img is None):
            self._pipe_flush()
            self._process_sync(img_dev)
            return
        if self._state_dirty:
            self._redo_queue()
        rec = self._dispatch_track(img_dev)
        self._pending_q.append(rec)
        self.last_img = img_dev
        self.last_kp, self.last_desc = rec["kp"], rec["desc"]
        depth = max(1, self.cfg.tracking.pipeline_depth)
        while len(self._pending_q) >= depth:
            self._resolve_record(self._pending_q.popleft())

    def _pipe_flush(self) -> None:
        """Resolve all in-flight frames."""
        while self._pending_q:
            self._resolve_record(self._pending_q.popleft())

    def _resolve_record(self, rec: dict) -> None:
        """Finish a dispatched frame. When its resolve rebuilt host state
        (reset, relocalization, BA apply), the state is pushed and the
        frames dispatched after it are redone against it."""
        fid = self.frame_id
        self.frame_id = rec["frame_id"]
        try:
            res = self._finish_track(rec)
            res.timings_ms["frame"] = (time.perf_counter() - rec["t0"]) * 1e3
            if res.reset and res.is_keyframe:
                # reset bootstrap: record the new anchor keyframe image
                self._kf_img = rec["img"]
                self.track_anchor_uv = self.track_uv.copy()
            dirty = self._state_dirty
            if dirty:
                self._push_state_to_device()
            self.trajectory.append(self.last_pose.copy())
            self.results.append(res)
        finally:
            self.frame_id = fid
        if dirty and self._pending_q:
            self._redo_queue()

    def _redo_queue(self) -> None:
        """Re-dispatch every queued in-flight frame against freshly pushed
        device state, reusing each frame's extraction. In TRACKING each is
        dispatched under its own frame id with its original LK template
        image and keeps its original predecessor pair for a reset; in INIT
        each is handled synchronously by `_handle_init`."""
        if self._state_dirty:
            self._push_state_to_device()
        if not self._pending_q:
            return
        redos = list(self._pending_q)
        self._pending_q.clear()
        fid = self.frame_id
        for redo in redos:
            if self.status == VOStatus.TRACKING:
                self.frame_id = redo["frame_id"]
                try:
                    rec2 = self._dispatch_track(
                        redo["img"], pre=(redo["kp"], redo["desc"]),
                        prev_override=redo["prev_img"])
                finally:
                    self.frame_id = fid
                self.n_redone += 1
                rec2["prev_kp"] = redo["prev_kp"]
                rec2["prev_desc"] = redo["prev_desc"]
                self._pending_q.append(rec2)
                self.last_img = redo["img"]
                self.last_kp, self.last_desc = rec2["kp"], rec2["desc"]
            else:
                self.frame_id = redo["frame_id"]
                try:
                    res2 = self._handle_init(redo["img"], redo["kp"],
                                             redo["desc"])
                    if res2.is_keyframe:
                        self._kf_img = redo["img"]
                        self.track_anchor_uv = self.track_uv.copy()
                    if self._state_dirty:
                        self._push_state_to_device()
                    self.last_img = redo["img"]
                    self.last_kp = redo["kp"]
                    self.last_desc = redo["desc"]
                    self.trajectory.append(self.last_pose.copy())
                    self.results.append(res2)
                finally:
                    self.frame_id = fid
