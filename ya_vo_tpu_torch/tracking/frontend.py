"""Pipeline runtime: the INIT / TRACKING / RESET state machine over a fused
step.

Port of `ya_vo_tpu/tracking/frontend.py`: the two-view bootstrap, the fused
per-frame tracking step (FAST + BRIEF extraction, then the state-dependent
body: projection-seeded LK from the previous frame, or from the anchor
keyframe under `lk_template="anchor"`, robust pose GN, speculative
replenishment against the anchor keyframe and the on-device keyframe
decision and track-table merge), the host replay of each frame's record
into the numpy `MapStore` with its lifecycle (landmark retirement and
recycling, keyframe eviction), the sliding-window BA with its divergence
gate and its two apply modes (synchronous, or asynchronous on a backend
thread with the staleness gate and its slow-host backoff), the reset path
(PnP relocalization against the surviving map, else the unit-scale
two-view bootstrap chained on the last pose), the pipelined driver with
its redo of in-flight frames after a state push, the optional photometric
normalization on ingest, the per-frame observers (`observers`, e.g.
`viz.live.attach`) and the reset and rejected-solve dumps
(`YA_VO_DUMP_RESET_DIR`, `YA_VO_DUMP_BA_DIR`).

On the card the fused step is the JAX frontend's two compiled programs,
`step` and `step_pre`, as two CUDA graphs (`step_graph.StepGraphs`, fresh
and redo), captured at the first tracking dispatch and replayed on every
later one, bit-equal to the eager step; the frame number and the free
landmark capacity reach the step as device scalars. A window solve on
the card is one launch of K5 (`ba_window.solve_window`), its loop's exit
taken on the device. `Frontend(..., step_graphs=False)` runs the eager
step instead, for comparisons. On the CPU the runner handles its buffers
as on the card, with the body run in place of a replay.

Tracking state lives as tensors on `device`. Each frame's record is copied
with `non_blocking` copies into pinned host memory behind a CUDA event.
When a resolve rebuilds host state (bootstrap, reset, relocalization, a BA
apply under `apply_mode="push"`), the state is pushed and every in-flight
frame is re-dispatched against it, reusing its extraction: the pipelined
driver's results are the synchronous driver's, bit for bit, however many
frames are in flight. So under push the driver resolves each frame as soon
as its record has landed (the event's `query()`, which never blocks),
before and after each dispatch, and `pipeline_depth` only caps the frames
in flight: the fewer in flight at a dirty resolve, the fewer redone. On the
CPU a record has no event and counts as not landed, so frames resolve at
the cap. Under `apply_mode="device"` a BA apply is composed into the
device chain in place instead, and the frames in flight are rotated into
the corrected frame when they resolve: no push, no redo, but which frames
are rotated depends on which are in flight, so that mode keeps resolving a
frame `pipeline_depth - 1` frames after its dispatch, whatever has landed.

Asynchronous window BA (`ba.asynchronous`) solves on one worker thread.
On the card that thread issues the solve on a CUDA stream of its own,
after waiting on an event recorded on the frontend's stream where the
window problem was built; the result reaches the host (numpy) inside the
worker, so the frontend thread never waits on the backend stream. The
problem's tensors stay referenced by the pending job until its result has
been read. A solve that raises is logged and dropped when `_poll_ba` finds
it done; `finish()` and the staleness wait, which block on it, re-raise
its error in the caller's thread. A result from before a keyframe-slot
shift is dropped without being read.

With `ba.distributed != "off"` and a `parallel.mesh.landmark_mesh` of two
or more shards (several visible cards), every window solve runs on the
landmark-sharded solver (`parallel/dist_ba.make_dist_solver`), the
reference's `_maybe_build_dist_ba`: the problem is converted to the
landmark-major layout on the host, after the backend stream has waited on
its `ready` event, so each shard's upload follows the problem's, and the
landmark shards are gathered on the frontend's device, on the current
stream, before the result is read.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import enum
import itertools
import logging
import os
import pickle
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.ba import window as ba_window
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.core import lie
from ya_vo_tpu_torch.core.camera import Camera
from ya_vo_tpu_torch.features import brief, fast, matching
from ya_vo_tpu_torch.geometry import ransac
from ya_vo_tpu_torch.geometry.triangulation import triangulate_fast
from ya_vo_tpu_torch.parallel import dist_ba
from ya_vo_tpu_torch.parallel import mesh as mesh_lib
from ya_vo_tpu_torch.tracking import lk_cuda, pose_solver, step_graph
from ya_vo_tpu_torch.utils import profiling
from ya_vo_tpu_torch.utils.convert import DEVICE_KEYS, offsets_from_numpy
from ya_vo_tpu_torch.worldmap.mapstore import MapStore

_log = logging.getLogger("ya_vo_tpu_torch.frontend")


# names of the per-frame record the host pulls, in the step's output order
RECORD_KEYS = ("n_flow", "n_ba", "n_kp", "n_matches", "is_kf", "n_new",
               "pose", "keep", "flow_ok", "inlier", "dest", "src",
               "anchor_uv", "valid", "r_pts", "track_uv")

# each frontend's serial, the session id of its spans (utils/profiling)
_SESSIONS = itertools.count(1)


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


def photometric_normalize(img: torch.Tensor) -> torch.Tensor:
    """`FeatureConfig.photometric_norm` on ingest: remap the frame affinely
    to mean 128 and standard deviation 48 (float32 mean and population
    std), then clip to [0, 255] and truncate to uint8. A frame whose std is
    below 1 (a blackout) passes through at its own mean, so real signal
    loss still fails the gates. No host sync."""
    f = img.to(torch.float32)
    mu = f.mean()
    sd = f.std(correction=0)
    ok = sd >= 1.0
    g = torch.where(ok, 48.0 / torch.clamp(sd, min=1e-3),
                    torch.ones_like(sd))
    out = (f - mu) * g + torch.where(ok, torch.full_like(mu, 128.0), mu)
    return out.clamp(0.0, 255.0).to(torch.uint8)


def lk_inputs(template: str, cam: Camera, pose, rel, lm_pos, track_uv,
              anchor_uv, track_mask, prev_img, kf_img):
    """LK's (template image, template uv, seed, live mask) under the LK
    template `template` at the constant-velocity prior `rel @ pose`."""
    seed, z = cam.project(lie.transform_points(rel @ pose, lm_pos))
    if template == "prev":
        # frame-to-frame template: seed = last tracked position plus the
        # projected motion delta
        seed_prev, z_prev = cam.project(lie.transform_points(pose, lm_pos))
        use = track_mask & (z > 0.25) & (z_prev > 0.25)
        seed = torch.where(use[:, None], track_uv + (seed - seed_prev),
                           track_uv)
        return prev_img, track_uv, seed, use
    # anchor-keyframe template: the absolute projection seeds LK from the
    # keyframe image at the anchor positions
    use = track_mask & (z > 0.25)
    return kf_img, anchor_uv, torch.where(use[:, None], seed, anchor_uv), use


def detect_kwargs(fc) -> dict:
    """`fast.detect`'s parameters from a `FeatureConfig`; the border keeps
    the blurred BRIEF patch inside the image."""
    return dict(max_keypoints=fc.max_keypoints, threshold=fc.fast_threshold,
                arc_length=fc.fast_arc_length, nms_radius=fc.nms_radius,
                border=fc.brief_patch_radius + fc.blur_ksize // 2 + 4,
                harris_k=fc.harris_k)


def lk_kwargs(tc) -> dict:
    """`lk_cuda.track`'s parameters from a `TrackConfig`."""
    return dict(levels=tc.lk_levels, half=tc.lk_window // 2,
                iters=tc.lk_iters, eps=tc.lk_eps,
                max_residual=tc.lk_max_residual,
                rel_residual=tc.lk_rel_residual)


def gn_kwargs(tc) -> dict:
    """`pose_solver.solve_pose`'s parameters from a `TrackConfig`."""
    return dict(iters=tc.gn_rounds * tc.gn_iters_per_round,
                huber_delta=tc.huber_delta, chi2_threshold=tc.chi2_threshold)


def near_tracks(r_uv2, track_uv, keep):
    """The proximity test: a fresh match within 12 px of a kept track."""
    d2 = ((r_uv2[:, None, :] - track_uv[None, :, :]) ** 2).sum(-1)
    return ((d2 < 144.0) & keep[None, :]).any(1)


def depth_gate(ratio: float, r_valid, r_pts, pose, c_now, c_kf):
    """`r_valid` less the fresh points `r_pts` deeper in `pose` than
    `ratio` times the baseline between the camera centres `c_now` and
    `c_kf` (`ratio` 0: no gate)."""
    if ratio <= 0:
        return r_valid
    baseline = torch.linalg.norm(c_now - c_kf)
    z_cur = lie.transform_points(pose, r_pts)[:, 2]
    return r_valid & (z_cur < ratio * baseline)


def merge_order(keep, r_valid):
    """The keyframe merge's two stable argsorts: (dest, the kept slots
    last; src, the valid fresh points first)."""
    return (torch.argsort(keep.to(torch.int32), stable=True),
            torch.argsort((~r_valid).to(torch.int32), stable=True))


def step_scalars(frame_no: int, cap_left: int, device):
    """The step's per-frame arguments, the frame number and the map's free
    landmark capacity, as 0-d int64 tensors on `device` (JAX traces them as
    scalars): one non-blocking copy from pinned memory on the card."""
    t = torch.tensor([frame_no, cap_left], dtype=torch.int64,
                     pin_memory=torch.device(device).type == "cuda")
    t = t.to(device, non_blocking=True)
    return t[0], t[1]


def camera_center(T):
    """Camera centre of a world->camera pose (numpy or torch)."""
    return -T[:3, :3].T @ T[:3, 3]


class Frontend:
    def __init__(self, config: VOConfig, cam: Camera, device=None,
                 step_graphs: bool = True):
        """`step_graphs=False` runs every tracking dispatch as the eager
        step (on the card, for comparisons with the graphs' replays)."""
        self.serial = next(_SESSIONS)
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
        sp = profiling.begin("session.create", session=self.serial)
        self.K = cam.K(self.device)
        fc = config.features
        self._offsets = offsets_from_numpy(
            brief.make_offsets(fc.brief_n_bits, fc.brief_patch_radius,
                               fc.brief_seed), self.device)
        self._generator = torch.Generator().manual_seed(config.ransac.seed)
        # photometric normalization on ingest (`photometric_normalize`):
        # applied once a frame, so a redo, `last_img` and a checkpoint hold
        # the normalized frame
        self._norm = fc.photometric_norm
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
        # per-frame callbacks (result) -> None, fired by _emit on the sync
        # and pipelined drivers (e.g. viz.live.attach)
        self.observers: List = []

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
        # asynchronous BA: one backend worker, at most one solve in flight
        # (`_ba_pending`), a window deferred while it runs, and the
        # staleness backoff (consecutive staleness discards widen the
        # gate by `_stale_relax`)
        self._ba_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ba-backend")
        self._ba_stream = (torch.cuda.Stream(self.device)
                           if self.device.type == "cuda" else None)
        self._ba_pending: Optional[dict] = None
        self._ba_deferred = False
        self.n_ba_deferred = 0        # windows deferred behind a solve
        self._consec_stale_discards = 0
        self._stale_relax = 0

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
        # the fused step's fresh and redo graphs (captured at the first
        # tracking dispatch), or None: the eager step
        self._graphs = step_graph.StepGraphs(self) if step_graphs else None
        bc = config.ba
        self._window_kw = dict(iters=bc.iters, huber_delta=bc.huber_delta,
                               damping=bc.damping, n_fixed_poses=2,
                               pose_prior_weight=bc.pose_prior_weight)
        # distributed backend: the window's landmark axis sharded over the
        # mesh (BAConfig.distributed); (solve_fn, mesh) or None
        self._dist_ba = None
        if config.ba.enabled and config.ba.distributed != "off":
            self._maybe_build_dist_ba()
        if config.ba.enabled and config.ba.asynchronous:
            # warm the solver's first launches on the backend stream
            self._ba_executor.submit(self._precompile_window_ba)
        profiling.end(sp)

    # ------------------------------------------------------------------ #
    def _ingest(self, img) -> torch.Tensor:
        """A frame on the device, normalized when `photometric_norm`."""
        img = self._to_device(img)
        return photometric_normalize(img) if self._norm else img

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
                   kf_mask, kf_pose, kf_ref, fsk, slot_stamp, frame_no,
                   cap_left):
        """The state-dependent rest of the fused frame on extraction
        (kp, desc): LK + pose GN, speculative replenishment and the
        keyframe decision and merge. `frame_no` and `cap_left` are 0-d
        int64 tensors (`step_scalars`). Returns (state_out, record) with no
        host sync."""
        tc = self.cfg.tracking
        mc = self.cfg.matching
        cam = self.cam
        K_cap = self.cfg.features.max_keypoints

        T_prior = rel @ pose
        tmpl_img, tmpl_uv, seed, use = lk_inputs(
            tc.lk_template, cam, pose, rel, lm_pos, track_uv, anchor_uv,
            track_mask, prev_img, kf_img)
        flow = lk_cuda.track(tmpl_img, img_curr, tmpl_uv, seed, use,
                             **lk_kwargs(tc))
        n_flow = flow.status.sum()

        solve = pose_solver.solve_pose(T_prior, lm_pos, flow.uv, flow.status,
                                       cam, **gn_kwargs(tc))
        n_ba = solve.n_inliers
        keep = flow.status & solve.inlier_mask
        new_track_uv = torch.where(keep[:, None], flow.uv, anchor_uv)
        new_rel = solve.pose @ torch.linalg.inv_ex(pose)[0]

        # speculative replenishment against the anchor keyframe
        m = matching.match(kf_desc, desc, kf_mask, kp.mask,
                           abs_threshold=mc.abs_threshold,
                           cross_check=mc.cross_check)
        r_uv2 = kp.uv[m.idx2]
        near = near_tracks(r_uv2, new_track_uv, keep)
        P1 = self.K @ kf_pose[:3, :4]
        P2 = self.K @ solve.pose[:3, :4]
        r_pts, r_valid = triangulate_fast(P1, P2, kf_uv, r_uv2,
                                          m.mask & ~near)
        c_kf = camera_center(kf_pose)
        c_now = camera_center(solve.pose)
        r_valid = depth_gate(tc.max_depth_baseline_ratio, r_valid, r_pts,
                             solve.pose, c_now, c_kf)
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
        dest, src = merge_order(keep, r_valid)
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
        event, queued before any later replay of the graph that owns the
        record; on the CPU they are plain copies."""
        if self.device.type != "cuda":
            return [t.clone() for t in record], None
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
        sp = profiling.begin("state.push")
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
        profiling.end(sp)

    def sync_host_state(self) -> None:
        """Copy the device track table into the host mirrors (before a
        checkpoint)."""
        self.track_uv = self._np(self._d_track_uv).copy()
        self.track_valid = self._np(self._d_track_valid).copy()

    def _emit(self, res: FrameResult) -> None:
        """Record a finished frame and notify the observers; an observer's
        exception is logged and never stops tracking."""
        self.results.append(res)
        for cb in self.observers:
            try:
                cb(res)
            except Exception:
                _log.exception("frame observer failed")

    # ------------------------------------------------------------------ #
    def process(self, img) -> FrameResult:
        """Feed one grayscale frame, fully synchronously."""
        self.frame_id += 1
        self._poll_ba()
        return self._process_sync(self._ingest(img))

    def _process_sync(self, img_dev: torch.Tensor) -> FrameResult:
        t0 = time.perf_counter()
        if self.status == VOStatus.INIT or self.last_img is None:
            sp = profiling.begin("session.bootstrap", frame=self.frame_id)
            kp, desc = self._extract(img_dev)
            res = self._handle_init(img_dev, kp, desc)
            res.n_keypoints = int(kp.count())
            if res.is_keyframe:         # bootstrap succeeded
                self._kf_img = img_dev
                self.track_anchor_uv = self.track_uv.copy()
            profiling.end(sp)
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
        self._emit(res)
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
    def _step_args(self, img, prev_override=None) -> tuple:
        """`_step_body`'s arguments after (kp, desc) for a dispatch of
        `img` as frame `frame_id`: the device state, with the LK template
        image `prev_override`, else the last dispatch's, else the last
        frame's, then the frame number and the free landmark capacity
        (`step_scalars`)."""
        if prev_override is not None:
            prev_img = prev_override
        elif self._d_prev_img is not None:
            prev_img = self._d_prev_img
        else:
            prev_img = self.last_img if self.last_img is not None else img
        return (self._d_kf_img, img, prev_img, self._d_track_uv,
                self._d_anchor_uv, self._d_track_valid, self._d_lm_pos,
                self._d_pose, self._d_rel, self._d_kf_desc, self._d_kf_uv,
                self._d_kf_mask, self._d_kf_pose, self._d_kf_ref,
                self._d_fsk, self._d_slot_stamp,
                *step_scalars(self.frame_id, self.map.free_landmark_capacity,
                              self.device))

    def _dispatch_track(self, img, pre=None, prev_override=None) -> dict:
        """Launch the fused step on the device-resident state and commit the
        state chain; the record's copies to the host start here and are
        read in _finish_track. `pre` = (kp, desc) reuses an earlier
        extraction of `img` (a redo); `prev_override` is the LK template
        image that dispatch used. Once the step graphs are captured, a
        replay of the fresh or the redo graph; else the eager step, which
        the frontend's first dispatch runs as the graphs' warm-up before
        their capture."""
        sp = profiling.begin("step.dispatch", frame=self.frame_id)
        t0 = time.perf_counter()
        args = self._step_args(img, prev_override)
        g = self._graphs
        if g is not None and g.ready:
            prev_img = g.source(args[2])
            kp, desc, state_out, record = g.dispatch(args, pre)
        else:
            prev_img = args[2]
            with (contextlib.nullcontext() if g is None
                  else g.warm_stream()):
                kp, desc = self._extract(img) if pre is None else pre
                state_out, record = self._step_body(kp, desc, *args)
            if g is not None:
                g.capture(args, kp, desc)
        (self._d_anchor_uv, self._d_track_valid, self._d_lm_pos,
         self._d_pose, self._d_rel, self._d_kf_desc, self._d_kf_uv,
         self._d_kf_mask, self._d_kf_pose, self._d_kf_img, self._d_kf_ref,
         self._d_fsk, self._d_track_uv, self._d_slot_stamp,
         self._d_prev_img) = state_out
        rec = dict(frame_id=self.frame_id, img=img, prev_img=prev_img,
                   kp=kp, desc=desc, prev_kp=self.last_kp,
                   prev_desc=self.last_desc, pull=self._pull(record), t0=t0,
                   post_corr=None)
        profiling.end(sp)
        return rec

    def _finish_track(self, rec: dict) -> FrameResult:
        """Evaluate the state-machine gates and replay the device-made
        keyframe decision into the host map store; a failed gate resets."""
        tc = self.cfg.tracking
        host, event = rec["pull"]
        if event is not None:
            sp = profiling.begin("step.wait")
            event.synchronize()
            profiling.end(sp)
        r = dict(zip(RECORD_KEYS, (h.numpy() for h in host)))
        kp, desc = rec["kp"], rec["desc"]
        n_flow, n_ba, n_kp = int(r["n_flow"]), int(r["n_ba"]), int(r["n_kp"])
        t_step = (time.perf_counter() - rec["t0"]) * 1e3
        if n_flow < tc.min_flow_inliers or n_ba < tc.min_ba_inliers:
            # tracking failed: bootstrap from rec's PREDECESSOR frame pair
            # (self.last_* may already hold a newer dispatched frame)
            self._maybe_dump_reset(rec, r)
            self.last_kp, self.last_desc = rec["prev_kp"], rec["prev_desc"]
            res = self._reset(kp, desc, n_matches=0, n_flow=n_flow,
                              n_ba=n_ba)
            self.last_kp, self.last_desc = kp, desc
            self.last_img = rec["img"]
            res.n_keypoints = n_kp
            res.timings_ms["step"] = t_step
            return res

        prev_pose = self.last_pose
        pc_corr = rec["post_corr"]
        if pc_corr is None:
            self.last_pose = r["pose"].astype(np.float32)
        else:
            # dispatched before a BA apply was composed into the device
            # chain (_apply_corr_device): rotate its pose into the
            # corrected frame; rel_motion against the unrotated prev_pose
            self.last_pose = (r["pose"] @ pc_corr).astype(np.float32)
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
            r_pts = r["r_pts"]
            if pc_corr is not None:
                # fresh triangulations are in pre-correction coordinates
                ic = np.linalg.inv(pc_corr)
                r_pts = r_pts @ ic[:3, :3].T + ic[:3, 3]
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
            lm_ids = self.map.add_landmarks(r_pts[s],
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
    def _run_window_ba(self, force: bool = False) -> None:
        """Sliding-window BA over the active keyframe window every
        `every_n_keyframes` keyframes, applied through `_apply_ba_result`:
        at once when synchronous; asynchronously, submitted to the backend
        worker and applied by `_poll_ba`. `force` (the deferred re-launch)
        skips the keyframe cadence."""
        bc = self.cfg.ba
        if not bc.enabled or self.map.n_keyframes < bc.min_keyframes:
            return
        if not force:
            self._kf_since_ba += 1
            if self._kf_since_ba < bc.every_n_keyframes:
                return
            self._kf_since_ba = 0
        if bc.asynchronous and self._ba_pending is not None:
            n_behind = self.map.kf_stamp_counter - self._ba_pending["kf_stamp"]
            if n_behind >= bc.max_stale_keyframes and not force:
                # the backend is a whole staleness window behind: wait for
                # the solve in flight and apply it now, its staleness
                # discard lifted up to this distance
                _log.info(
                    "async BA %d keyframes behind: blocking for the "
                    "in-flight solve (sync-degraded cadence)", n_behind)
                self._ba_pending["stale_floor"] = n_behind
                self._ba_pending["fut"].result()   # a failed solve raises
                self._poll_ba()
            if self._ba_pending is not None:
                # one solve in flight at a time: re-launch on its
                # completion with a fresh snapshot
                self._ba_deferred = True
                self.n_ba_deferred += 1
                return
        # an asynchronous solve's `ba.window` is the worker's
        # (`_solve_on_backend`)
        sp = None if bc.asynchronous else profiling.begin("ba.window")
        job = self._build_window_problem()
        if job is None:
            profiling.end(sp)
            return
        prob, slots, used, n_real = job
        self._last_ba_prob = prob
        anchor_old = self.map.kf_pose[slots[-1]].copy()
        if bc.asynchronous:
            ready = None
            if self._ba_stream is not None:
                ready = torch.cuda.Event()
                ready.record()
            self._ba_pending = dict(
                fut=self._ba_executor.submit(self._solve_on_backend, prob,
                                             ready, self.frame_id),
                prob=prob, slots=slots, used=used, n_real=n_real,
                anchor_old=anchor_old, epoch=self._session_epoch,
                kf_stamp=self.map.kf_stamp_counter,
                lm_stamp=self.map.lm_stamp_counter)
            return
        (new_poses, new_lms), ms = self._solve(prob)
        self.ba_ms.append(ms)
        self._apply_ba_result(new_poses, new_lms, slots, used, n_real,
                              anchor_old, ms)
        profiling.end(sp)

    def _solve(self, prob):
        """One window solve on the current stream (sharded over the mesh
        when `_dist_ba` is built; else `solve_window`: K5 on the card),
        read back to numpy: ((poses, landmarks), wall ms)."""
        sp = profiling.begin("ba.solve")
        t0 = time.perf_counter()
        res = None
        if self._dist_ba is not None:
            poses, lms = self._solve_window_distributed(prob)
        else:
            res = ba_window.solve_window(prob, self.cam, **self._window_kw)
            poses, lms = res.poses, res.landmarks
        out = (self._np(poses), self._np(lms))
        ms = (time.perf_counter() - t0) * 1e3
        if res is not None and profiling.on():
            # K5's device count, after the read-back above has waited
            profiling.count("ba.gn_iters", int(res.n_iters))
        profiling.end(sp)
        return out, ms

    def _maybe_build_dist_ba(self) -> None:
        """Build the landmark-sharded window solver when the mesh
        (`parallel.mesh.landmark_mesh` of the frontend's device type: the
        visible cards) holds at least two shards and
        `max_window_landmarks` divides evenly over them
        (BAConfig.distributed="auto"). Per GN iteration only the reduced
        camera system (O((6W)^2) floats) and the costs cross devices.
        Falls back silently to the single-device solver otherwise."""
        bc = self.cfg.ba
        m = mesh_lib.landmark_mesh(device_type=self.device.type)
        n_shards = m.size * mesh_lib.process_count()
        if m.size < 2 or bc.max_window_landmarks % n_shards:
            return
        solve = dist_ba.make_dist_solver(
            m, self.cam, iters=bc.iters, huber_delta=bc.huber_delta,
            damping=bc.damping, n_fixed_poses=2,
            pose_prior_weight=bc.pose_prior_weight)
        self._dist_ba = (solve, m)
        _log.info("backend BA: window landmark axis sharded over %d "
                  "shards (BAConfig.distributed=%s)", n_shards,
                  bc.distributed)

    def _solve_window_distributed(self, prob):
        """One window solve on the mesh: the keyframe-major snapshot in the
        landmark-major layout, solved, the landmark shards gathered on the
        frontend's device. Returns (poses, landmarks) tensors."""
        solve, _ = self._dist_ba
        poses, lms, _c0, _c1 = solve(dist_ba.from_window_problem(prob))
        return poses, lms.gather(self.device)

    def _backend_stream(self):
        """The worker's launch context: the backend stream on the card (the
        current stream is per thread, so the worker enters it itself)."""
        if self._ba_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._ba_stream)

    def _solve_on_backend(self, prob, ready, frame=None):
        """The worker's solve, on the backend stream once the frontend
        stream has reached `ready` (the problem's uploads); its `ba.window`
        span carries the keyframe `frame` that launched it."""
        sp = profiling.begin("ba.window", session=self.serial, frame=frame)
        try:
            with self._backend_stream():
                if ready is not None:
                    self._ba_stream.wait_event(ready)
                return self._solve(prob)
        finally:
            profiling.end(sp)

    def _precompile_window_ba(self) -> None:
        """Warm the solver (the sharded one when built) on the backend (on
        the card the kernel library's load and K5's first launch on the
        backend stream) with an all-invalid problem of the session's window
        shapes; runs on the worker at construction."""
        try:
            bc = self.cfg.ba
            W, L = self.cfg.map.window_size, bc.max_window_landmarks
            O = self.map.max_obs_per_kf
            with self._backend_stream():
                dev = self.device
                prob = ba_window.BAProblem(
                    poses=torch.eye(4, device=dev).repeat(W, 1, 1),
                    pose_valid=torch.ones(W, dtype=torch.bool, device=dev),
                    landmarks=torch.zeros((L, 3), device=dev),
                    lm_valid=torch.zeros(L, dtype=torch.bool, device=dev),
                    obs_uv=torch.zeros((W, O, 2), device=dev),
                    obs_lm=torch.full((W, O), -1, dtype=torch.int64,
                                      device=dev),
                    obs_valid=torch.zeros((W, O), dtype=torch.bool,
                                          device=dev))
                self._solve(prob)
        except Exception:
            _log.exception("window-BA warm-up on the backend failed")

    def _poll_ba(self) -> None:
        """Apply a finished backend solve (frontend thread), then re-launch
        a deferred window. A result from before a keyframe-slot shift
        (`_session_epoch`) is dropped unread; a current solve that raised
        is logged and dropped."""
        p = self._ba_pending
        if p is None or not p["fut"].done():
            return
        self._ba_pending = None
        if p["epoch"] == self._session_epoch:
            try:
                (new_poses, new_lms), ms = p["fut"].result()
            except Exception:
                _log.exception("backend BA solve failed")
            else:
                self.ba_ms.append(ms)
                self._apply_ba_result(
                    new_poses, new_lms, p["slots"], p["used"], p["n_real"],
                    p["anchor_old"], ms, kf_stamp_snap=p["kf_stamp"],
                    lm_stamp_snap=p["lm_stamp"],
                    stale_floor=p.get("stale_floor", 0))
        if self._ba_deferred:
            self._ba_deferred = False
            self._run_window_ba(force=True)

    def _build_window_problem(self, min_keyframes: Optional[int] = None):
        """Snapshot the active window into a fixed-shape, landmark-compacted
        BAProblem on the device. Returns (prob, slots, used, n_real) or
        None when the window holds fewer than `min_keyframes` (default
        `ba.min_keyframes`) keyframes."""
        sp = profiling.begin("ba.build")
        bc = self.cfg.ba
        W = self.cfg.map.window_size
        slots, poses, obs_uv, obs_lm, obs_valid = self.map.active_window(W)
        n_real = len(slots)
        if n_real < (bc.min_keyframes if min_keyframes is None
                     else min_keyframes):
            profiling.end(sp)
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
        profiling.end(sp)
        return prob, slots, used, n_real

    def _apply_ba_result(self, new_poses, new_lms, slots, used, n_real,
                         anchor_old, ms, kf_stamp_snap=None,
                         lm_stamp_snap=None, stale_floor=0) -> None:
        """Apply a solve: the finite check; for an asynchronous one
        (`kf_stamp_snap` given) the staleness gate with its slow-host
        backoff; the divergence gate; then write back the window's poses
        and landmarks, move what was created after the snapshot and the
        live landmarks outside the window by the anchor keyframe's
        correction, re-anchor the live chain and mark the device state
        dirty (push)."""
        sp = profiling.begin("ba.apply")
        new_poses = new_poses[:n_real]
        if not (np.all(np.isfinite(new_poses))
                and np.all(np.isfinite(new_lms))):
            profiling.end(sp)
            return
        bc = self.cfg.ba
        if kf_stamp_snap is not None:
            n_stale = self.map.kf_stamp_counter - kf_stamp_snap
            stale_limit = max(bc.max_stale_keyframes + self._stale_relax,
                              stale_floor)
            if n_stale > stale_limit:
                self.n_ba_discarded += 1
                self._consec_stale_discards += 1
                _log.warning(
                    "discarding async BA result: %d keyframes created since "
                    "its snapshot (limit=%d)", n_stale, stale_limit)
                if self._consec_stale_discards >= 3:
                    # slow-host backoff: every solve outlives the window
                    self._stale_relax += bc.max_stale_keyframes
                    self._consec_stale_discards = 0
                    _log.warning(
                        "async BA: 3 consecutive staleness discards; "
                        "widening the staleness window to %d",
                        bc.max_stale_keyframes + self._stale_relax)
                profiling.end(sp)
                return
            self._consec_stale_discards = 0
            self._stale_relax = max(0, self._stale_relax - 1)
        # divergence gate: a correction of the anchor keyframe's camera
        # CENTRE by more than max_correction_steps (median) step lengths,
        # or a rotation past max_correction_rot_deg, means the solve
        # diverged
        inst = float(np.linalg.norm(self.rel_motion[:3, 3]))
        step = float(np.median(self._recent_steps)) \
            if self._recent_steps else inst
        step = max(step, inst * 0.25, 0.1 * self._peak_step)
        corr_try = np.linalg.inv(anchor_old) @ new_poses[-1]
        t_corr = float(np.linalg.norm(camera_center(new_poses[-1])
                                      - camera_center(anchor_old)))
        cosang = (np.trace(corr_try[:3, :3]) - 1.0) / 2.0
        r_corr = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        if (t_corr > bc.max_correction_steps * max(step, 1e-3)
                or r_corr > bc.max_correction_rot_deg):
            self.n_ba_discarded += 1
            _log.warning(
                "discarding %s BA result: correction too large to apply "
                "(|t|=%.3f vs step %.3f, rot=%.2f deg)",
                "sync" if kf_stamp_snap is None else "async", t_corr, step,
                r_corr)
            self._maybe_dump_rejected_solve(new_poses, t_corr, r_corr)
            profiling.end(sp)
            return
        self._last_ba_ms = ms
        self.n_ba_runs += 1

        # write back, then re-anchor: T_live' = T_live anchor_old^-1 anchor_new
        self.map.update_keyframe_poses(slots, new_poses)
        if lm_stamp_snap is not None:
            # a slot killed and recycled since the snapshot holds another
            # landmark now: leave it
            same = (self.map.landmark_stamp[used] < lm_stamp_snap) \
                & self.map.landmark_alive[used]
            self.map.landmark_pos[used[same]] = new_lms[: len(used)][same]
        else:
            self.map.landmark_pos[used] = new_lms[: len(used)]
        corr = (np.linalg.inv(anchor_old) @ new_poses[-1]).astype(np.float32)
        inv_c = np.linalg.inv(corr)
        # keyframes and landmarks created after the snapshot (by creation
        # stamp) are still in the frame before the correction: move them
        if kf_stamp_snap is not None:
            sl = np.nonzero(
                self.map.kf_stamp[: self.map.n_keyframes] >= kf_stamp_snap)[0]
            if sl.size:
                self.map.kf_pose[sl] = self.map.kf_pose[sl] @ corr
        if lm_stamp_snap is not None:
            hwm = self.map.n_landmarks
            fresh = np.nonzero(
                (self.map.landmark_stamp[:hwm] >= lm_stamp_snap)
                & self.map.landmark_alive[:hwm])[0]
            if fresh.size:
                pts = self.map.landmark_pos[fresh]
                self.map.landmark_pos[fresh] = (pts @ inv_c[:3, :3].T
                                                + inv_c[:3, 3])
        # live-table landmarks neither solved nor created after the
        # snapshot stay consistent with the corrected live pose by the
        # same rigid move (X' = corr^-1 X)
        upd = np.zeros(self.map.max_landmarks, bool)
        upd[used] = True
        tl = np.maximum(self.track_lm, 0)
        snap_bound = lm_stamp_snap if lm_stamp_snap is not None else np.inf
        stranded = (self.track_valid & (self.track_lm >= 0) & ~upd[tl]
                    & (self.map.landmark_stamp[tl] < snap_bound))
        if stranded.any():
            idx = self.track_lm[stranded]
            pts = self.map.landmark_pos[idx]
            self.map.landmark_pos[idx] = pts @ inv_c[:3, :3].T + inv_c[:3, 3]
        # the retirement archive rides the same re-anchor
        self.map.transform_archive(inv_c)
        # rel_motion is invariant under the right-multiplied correction
        self.last_pose = (self.last_pose @ corr).astype(np.float32)
        self._kf_pose = (self._kf_pose @ corr).astype(np.float32)
        if bc.apply_mode == "device" and self.status is VOStatus.TRACKING:
            # compose the correction into the device chain in place: no
            # push, no redo of the frames in flight
            self._apply_corr_device(corr)
        else:
            self._state_dirty = True
        profiling.end(sp)

    def _apply_corr_device(self, corr: np.ndarray) -> None:
        """`apply_mode="device"`: compose a BA apply into the device chain.
        The pose and keyframe pose are right-multiplied by `corr`; a track
        slot whose merge the host has resolved (slot stamp <= the newest
        resolved frame id) takes the host map's refined position, and a
        slot merged by a keyframe still in flight keeps its fresh
        triangulation, moved rigidly by corr^-1. Every record in flight was
        dispatched before the correction: its `post_corr` composes it, and
        `_finish_track` rotates its outputs when it resolves."""
        dev = self.device
        inv_c = np.linalg.inv(corr)
        corr_d = torch.tensor(corr, device=dev)
        inv_d = torch.tensor(inv_c, device=dev)
        self._d_pose = self._d_pose @ corr_d
        self._d_kf_pose = self._d_kf_pose @ corr_d
        tl = np.maximum(self.track_lm, 0)
        upd_mask = (self.track_valid & (self.track_lm >= 0)
                    & self.map.landmark_alive[tl])
        rigid = self._d_lm_pos @ inv_d[:3, :3].T + inv_d[:3, 3]
        safe = torch.tensor(upd_mask, device=dev) & (
            self._d_slot_stamp <= self._resolved_fid)
        self._d_lm_pos = torch.where(
            safe[:, None], torch.tensor(self.map.landmark_pos[tl],
                                        device=dev), rigid)
        for rec in self._pending_q:
            rec["post_corr"] = corr if rec["post_corr"] is None \
                else (rec["post_corr"] @ corr).astype(np.float32)

    def _maybe_dump_reset(self, rec: dict, r: dict) -> None:
        """With `YA_VO_DUMP_RESET_DIR` set, write the failing frame's slot
        state (`reset_f<frame>.npz`: the gate counts, poses, LK and GN
        masks, the device track table, landmark links, stamps and
        positions) so a reset can be read slot by slot. A failed dump is
        logged, never raised."""
        d = os.environ.get("YA_VO_DUMP_RESET_DIR")
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            tl = np.maximum(self.track_lm, 0)
            np.savez(
                os.path.join(d, f"reset_f{rec['frame_id']}.npz"),
                frame_id=rec["frame_id"],
                n_flow=r["n_flow"].astype(np.int32),
                n_ba=r["n_ba"].astype(np.int32),
                pose=r["pose"], last_pose=self.last_pose,
                rel_motion=self.rel_motion, flow_ok=r["flow_ok"],
                gn_inlier=r["inlier"], keep=r["keep"],
                track_uv=self._np(self._d_track_uv),
                track_lm=self.track_lm,
                track_valid=self._np(self._d_track_valid),
                anchor_uv=self._np(self._d_anchor_uv),
                lm_pos_dev=self._np(self._d_lm_pos),
                lm_stamp=self.map.landmark_stamp[tl],
                lm_alive=self.map.landmark_alive[tl],
                slot_stamp=self._np(self._d_slot_stamp).astype(np.int32))
            _log.warning("reset dump written to %s (frame %d)", d,
                         rec["frame_id"])
        except Exception:
            _log.exception("reset dump failed")

    def _maybe_dump_rejected_solve(self, new_poses, t_corr: float,
                                   r_corr: float) -> None:
        """With `YA_VO_DUMP_BA_DIR` set, pickle the window problem whose
        solve the divergence gate rejected
        (`rejected_f<frame>_<discards>.pkl`: {"prob", "new_poses",
        "t_corr", "r_corr"}, `prob` a `BAProblem` of numpy arrays, obs_lm
        as int32). A failed dump is logged, never raised."""
        d = os.environ.get("YA_VO_DUMP_BA_DIR")
        if not d or self._last_ba_prob is None:
            return
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"rejected_f{self.frame_id}_{self.n_ba_discarded}.pkl")
            prob = self._last_ba_prob._replace(
                obs_lm=self._last_ba_prob.obs_lm.to(torch.int32))
            prob = ba_window.BAProblem(*(self._np(x) for x in prob))
            with open(path, "wb") as f:
                pickle.dump({"prob": prob, "new_poses": new_poses,
                             "t_corr": t_corr, "r_corr": r_corr}, f)
            _log.info("dumped gate-rejected BA problem to %s", path)
        except Exception:
            _log.exception("BA problem dump failed")

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
            baseline = float(np.linalg.norm(camera_center(pose)
                                            - camera_center(old_kf_pose)))
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
        processed; with `pipelined`, gates resolve once a frame's record
        has landed, at most pipeline_depth - 1 frames after its dispatch
        (`_pipe_step`)."""
        # the root of the session's spans: it closes, and drops, any span
        # inside that an exception left open
        sp = profiling.begin("session.run", session=self.serial)
        try:
            it = iter(frames)
            fid = self.frame_id + 1    # the id the next frame will take
            pending = self._upload(next(it, None), fid)
            while pending is not None:
                current = pending
                fid += 1
                pending = self._upload(next(it, None), fid)
                if pipelined:
                    self._pipe_step(current)
                else:
                    self.process(current)
            self._pipe_flush()
            self.finish()
        finally:
            profiling.end(sp)
        if not self.trajectory:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.trajectory)

    def _upload(self, img, frame: int) -> Optional[torch.Tensor]:
        """`run`'s upload of its next frame `img` (None at the sequence's
        end), which will take the id `frame`."""
        if img is None:
            return None
        sp = profiling.begin("frame.upload", frame=frame)
        img = self._to_device(img)
        profiling.end(sp)
        return img

    def _pipe_step(self, img_dev: torch.Tensor) -> None:
        """Resolve the in-flight frames whose records have landed, dispatch
        this frame's step, resolve the landed ones again, then block on the
        oldest while `pipeline_depth` frames are queued: under push the
        depth is a cap, not a wait (`_resolve_landed`). Resolving first lets
        a reset found there send this frame down the synchronous path, and a
        dirty resolve push with nothing in flight to redo. Bootstrap frames
        drain the queue and run synchronously."""
        self._resolve_landed()
        self.frame_id += 1
        self._poll_ba()
        img_dev = self._ingest(img_dev)
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
        self._resolve_landed()
        depth = max(1, self.cfg.tracking.pipeline_depth)
        while len(self._pending_q) >= depth:
            self._resolve_record(self._pending_q.popleft())

    def _record_ready(self, rec: dict) -> bool:
        """Whether a dispatched frame's record has landed on the host: its
        copies' CUDA event, queried without blocking. The CPU runner's plain
        copies carry no event and count as not landed."""
        event = rec["pull"][1]
        return event is not None and event.query()

    def _resolve_landed(self) -> None:
        """Under `apply_mode="push"`, resolve the oldest in-flight frames
        for as long as their records have landed (`_record_ready`). Push
        results do not depend on which frames are in flight; under
        `apply_mode="device"` they do (the frames in flight at an apply are
        rotated when they resolve), so that mode resolves at the fixed
        depth alone."""
        if self.cfg.ba.apply_mode != "push":
            return
        while self._pending_q and self._record_ready(self._pending_q[0]):
            self._resolve_record(self._pending_q.popleft())

    def _pipe_flush(self) -> None:
        """Resolve all in-flight frames."""
        while self._pending_q:
            self._resolve_record(self._pending_q.popleft())

    def _resolve_record(self, rec: dict) -> None:
        """Finish a dispatched frame, popped from the head of the queue:
        under push as soon as its record has landed, else at the depth cap
        or a flush (`_pipe_step`). When its resolve rebuilt host state
        (reset, relocalization, BA apply), the state is pushed and the
        frames dispatched after it are redone against it. Counts the frames
        in flight, this one included (`driver.inflight`)."""
        fid = self.frame_id
        self.frame_id = rec["frame_id"]
        sp = profiling.begin("step.resolve", frame=self.frame_id)
        profiling.count("driver.inflight", len(self._pending_q) + 1)
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
            self._emit(res)
        finally:
            profiling.end(sp)
            self.frame_id = fid
        if dirty and self._pending_q:
            self._redo_queue()

    def _redo_queue(self) -> None:
        """Re-dispatch every queued in-flight frame against freshly pushed
        device state, reusing each frame's extraction. In TRACKING each is
        dispatched under its own frame id with its original LK template
        image and keeps its original predecessor pair for a reset; in INIT
        each is handled synchronously by `_handle_init`."""
        sp = profiling.begin("step.redo")
        if self._state_dirty:
            self._push_state_to_device()
        if not self._pending_q:
            profiling.end(sp)
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
                    self._emit(res2)
                finally:
                    self.frame_id = fid
        profiling.end(sp)

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def _throwaway_chain(self):
        """Run dispatches that leave the device chain (`DEVICE_KEYS`) as it
        was: its contents are saved as copies and put back afterwards (a
        replay overwrites the step graphs' buffers, which hold the chain,
        in place)."""
        saved = {k: None if getattr(self, k) is None
                 else getattr(self, k).clone() for k in DEVICE_KEYS}
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(self, k, v)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def precompile(self) -> None:
        """Pay the steady state's first-use costs before a timed loop, with
        no effect on the session: the kernels' build, one fresh and one
        redo dispatch (`pre=`, `prev_override=`) on a throwaway copy of the
        device chain (the step graphs' warm-up and capture, then a replay
        of the redo graph; the pinned record buffers) and one
        `solve_window` at this session's window shapes, its result
        dropped. Call after the bootstrap. The device chain, the map and
        the counters are left as they were."""
        if (self._d_kf_img is None or self.last_img is None
                or self.last_kp is None):
            return
        if self.device.type == "cuda":
            _build.library()
        with self._throwaway_chain():
            fresh = self._dispatch_track(self.last_img)
            redo = self._dispatch_track(
                self.last_img, pre=(fresh["kp"], fresh["desc"]),
                prev_override=fresh["prev_img"])
            for rec in (fresh, redo):
                if rec["pull"][1] is not None:
                    rec["pull"][1].synchronize()
        # Right after the bootstrap the window holds 2 keyframes, fewer than
        # `ba.min_keyframes`, so the gate is lowered here. The problem is
        # padded to [window_size, O] and `max_window_landmarks` whatever the
        # fill, so this solve has the session's shapes.
        n_dropped = self.n_ba_lm_dropped
        job = self._build_window_problem(min_keyframes=2)
        self.n_ba_lm_dropped = n_dropped
        if job is not None:
            self._solve(job[0])
        self._sync()

    def device_throughput_probe(self, imgs, n_steps: int = 200) -> dict:
        """The fused step's issue rate with no host reads: `n_steps`
        chained dispatches (extraction, step and the start of the record's
        copies, as the pipelined driver issues them) over `imgs` in turn, on
        a throwaway copy of the device chain, with one synchronize at the
        end; one warm step before the clock (on the card, with the step
        graphs, their capture when they have none yet). Where the host
        issues slower than the card computes, as on an H100 with eager
        PyTorch, this is the host's issue rate, not the device time. The
        session is left as it was. Returns {"device_step_ms", "fps_device",
        "n_steps", "graph_replays", "kernel_launches"}, the last two a
        step: graph replays (`_build.REPLAYS`) and the hand-written
        kernels' launches, which a replay counts (`_build.LAUNCHES`)."""
        if self._d_kf_img is None:
            raise RuntimeError("probe requires an initialized track chain")
        imgs = [self._ingest(im) for im in imgs]
        with self._throwaway_chain():
            for i in range(n_steps + 1):
                self._dispatch_track(imgs[i % len(imgs)])
                if i == 0:
                    self._sync()
                    replays = _build.REPLAYS["graphs"]
                    launches = sum(_build.LAUNCHES.values())
                    t0 = time.perf_counter()
            self._sync()
            dt = time.perf_counter() - t0
        return {"device_step_ms": dt / n_steps * 1e3,
                "fps_device": n_steps / dt, "n_steps": n_steps,
                "graph_replays": (_build.REPLAYS["graphs"] - replays)
                / n_steps,
                "kernel_launches": (sum(_build.LAUNCHES.values()) - launches)
                / n_steps}

    def finish(self) -> None:
        """End of sequence: resolve every frame still in flight, then drain
        the backend (wait for the solve in flight and apply it, deferred
        re-launches included). A solve that raised re-raises here."""
        self._pipe_flush()
        while self._ba_pending is not None:
            self._ba_pending["fut"].result()
            self._poll_ba()
