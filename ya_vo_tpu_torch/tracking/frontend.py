"""Pipeline runtime: the INIT / TRACKING state machine over a fused step.

Port of the steady-state slice of `ya_vo_tpu/tracking/frontend.py`: the
empty-map two-view bootstrap, the fused per-frame tracking step (FAST +
BRIEF, projection-seeded LK from the previous frame, robust pose GN,
speculative replenishment against the anchor keyframe and the on-device
keyframe decision and track-table merge), the host replay of each frame's
record into the numpy `MapStore`, and the pipelined driver.

Tracking state lives as tensors on `device`. Each frame's record is copied
with `non_blocking` copies into pinned host memory behind a CUDA event, so
the host resolves a frame `pipeline_depth - 1` frames after dispatching it
without stalling the card. Paths outside this slice raise
`NotImplementedError` instead of running a partial version.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.features import brief, fast, matching
from ya_vo_tpu_torch.geometry import ransac
from ya_vo_tpu_torch.geometry.triangulation import triangulate_fast
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver
from ya_vo_tpu_torch.utils.convert import offsets_from_numpy
from ya_vo_tpu_torch.worldmap.mapstore import MapStore

_NOT_YET = "not ported yet; queued in ROADMAP.md (Queue 1)"

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
    if config.ba.enabled:
        raise NotImplementedError(f"window BA (ba.enabled=True) is {_NOT_YET}")
    if config.tracking.lk_template != "prev":
        raise NotImplementedError(
            f"lk_template={config.tracking.lk_template!r} is {_NOT_YET}")
    if config.features.photometric_norm:
        raise NotImplementedError(f"photometric_norm=True is {_NOT_YET}")


def detect_kwargs(fc) -> dict:
    """`fast.detect`'s parameters from a `FeatureConfig`; the border keeps
    the blurred BRIEF patch inside the image."""
    return dict(max_keypoints=fc.max_keypoints, threshold=fc.fast_threshold,
                arc_length=fc.fast_arc_length, nms_radius=fc.nms_radius,
                border=fc.brief_patch_radius + fc.blur_ksize // 2 + 4,
                harris_k=fc.harris_k)


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

    def _extract(self, img: torch.Tensor):
        fc = self.cfg.features
        kp = fast.detect(img, **detect_kwargs(fc))
        blurred = brief.gaussian_blur(img.to(torch.float32), fc.blur_ksize,
                                      fc.blur_sigma)
        desc, _ = brief.describe(blurred, kp.uv, kp.mask, self._offsets)
        return kp, desc

    def _step(self, kf_img, img_curr, prev_img, track_uv, anchor_uv,
              track_mask, lm_pos, pose, rel, kf_desc, kf_uv, kf_mask,
              kf_pose, kf_ref, fsk, slot_stamp, frame_no: int,
              cap_left: int):
        """The fused steady-state frame: extraction, LK + pose GN,
        speculative replenishment and the keyframe decision and merge.
        Returns (kp, desc, state_out, record) with no host sync."""
        tc = self.cfg.tracking
        mc = self.cfg.matching
        cam = self.cam
        K_cap = self.cfg.features.max_keypoints
        kp, desc = self._extract(img_curr)

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
        return kp, desc, state_out, record

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
        self._d_prev_img = None     # the next dispatch uses self.last_img
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
            raise NotImplementedError(
                f"re-initialization against an existing map (relocalization)"
                f" is {_NOT_YET}")
        ok, info = self._two_view_bootstrap(kp, desc)
        if ok:
            self.status = VOStatus.TRACKING
            self._kf_desc, self._kf_kp = desc, kp
            self._kf_pose = self.last_pose.copy()
        return FrameResult(self.frame_id, "TRACKING" if ok else "INIT",
                           self.last_pose.copy(), **info)

    def _two_view_bootstrap(self, kp, desc):
        """Match last <-> current descriptors, robust E, triangulate and
        populate the empty map at unit baseline."""
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
        T_rel = lie.rt_to_mat(tv.R, tv.t).cpu().numpy()
        T1 = self.last_pose
        T2 = (T_rel @ T1).astype(np.float32)
        T1_inv = lie.se3_inverse(torch.as_tensor(T1)).numpy()
        pts_w = tv.points.cpu().numpy() @ T1_inv[:3, :3].T + T1_inv[:3, 3]
        lm_idx = self.map.add_landmarks(pts_w, tv.points_valid.cpu().numpy())
        n_new = int((lm_idx >= 0).sum())
        info["n_new_landmarks"] = n_new
        if n_new < self.cfg.tracking.min_flow_inliers:
            return False, info

        uv2_np = uv2.cpu().numpy()
        self.map.insert_keyframe(self.frame_id - 1, T1, uv1.cpu().numpy(),
                                 lm_idx, lm_idx >= 0)
        self.map.insert_keyframe(self.frame_id, T2, uv2_np, lm_idx,
                                 lm_idx >= 0)
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
        info["is_keyframe"] = True
        return True, info

    # ------------------------------------------------------------------ #
    def _dispatch_track(self, img) -> dict:
        """Launch the fused step on the device-resident state and commit the
        state chain; the record's copies to the host start here and are
        read in _finish_track."""
        t0 = time.perf_counter()
        if self._d_prev_img is not None:
            prev_img = self._d_prev_img
        else:
            prev_img = self.last_img if self.last_img is not None else img
        kp, desc, state_out, record = self._step(
            self._d_kf_img, img, prev_img, self._d_track_uv,
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
        return dict(frame_id=self.frame_id, img=img, kp=kp, desc=desc,
                    pull=self._pull(record), t0=t0)

    def _finish_track(self, rec: dict) -> FrameResult:
        """Evaluate the state-machine gates and replay the device-made
        keyframe decision into the host map store."""
        tc = self.cfg.tracking
        host, event = rec["pull"]
        if event is not None:
            event.synchronize()
        r = dict(zip(RECORD_KEYS, (h.numpy() for h in host)))
        n_flow, n_ba, n_kp = int(r["n_flow"]), int(r["n_ba"]), int(r["n_kp"])
        t_step = (time.perf_counter() - rec["t0"]) * 1e3
        if n_flow < tc.min_flow_inliers or n_ba < tc.min_ba_inliers:
            raise NotImplementedError(
                f"frame {rec['frame_id']} failed the tracking gates "
                f"(n_flow={n_flow}, n_ba={n_ba}); the reset path is "
                f"{_NOT_YET}")

        prev_pose = self.last_pose
        self.last_pose = r["pose"].astype(np.float32)
        self.rel_motion = (self.last_pose @ np.linalg.inv(prev_pose)) \
            .astype(np.float32)
        is_kf = bool(r["is_kf"])
        n_new = int(r["n_new"]) if is_kf else 0
        self._frames_since_kf += 1
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
            self.map.insert_keyframe(rec["frame_id"], self.last_pose,
                                     self.track_uv, self.track_lm,
                                     self.track_valid)
            self._kf_desc, self._kf_kp = rec["desc"], rec["kp"]
            self._kf_pose = self.last_pose.copy()
            self._kf_img = rec["img"]
            self._kf_ref_inliers = n_ba + n_new
            self._frames_since_kf = 0
        else:
            keep = r["keep"]
            self.track_valid = self.track_valid & keep
            self.track_uv = np.where(keep[:, None], r["track_uv"],
                                     self.track_uv)
        return FrameResult(
            rec["frame_id"], "TRACKING", self.last_pose.copy(),
            n_keypoints=n_kp, n_matches=int(r["n_matches"]),
            n_flow_inliers=n_flow, n_ba_inliers=n_ba, n_new_landmarks=n_new,
            is_keyframe=is_kf, timings_ms={"step": t_step})

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
        fid = self.frame_id
        self.frame_id = rec["frame_id"]
        try:
            res = self._finish_track(rec)
            res.timings_ms["frame"] = (time.perf_counter() - rec["t0"]) * 1e3
            self.trajectory.append(self.last_pose.copy())
            self.results.append(res)
        finally:
            self.frame_id = fid

    def _redo_queue(self) -> None:
        """Push rebuilt host state to the device; re-dispatching in-flight
        frames against it is not part of this slice."""
        self._push_state_to_device()
        if self._pending_q:
            raise NotImplementedError(
                f"re-dispatch of in-flight frames after a state push is "
                f"{_NOT_YET}")
