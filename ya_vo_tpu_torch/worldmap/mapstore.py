"""World-model store: fixed-capacity masked arrays instead of pointer graphs.

The reference's world model is a shared_ptr/weak_ptr object graph —
`Map` holds id->Frame / id->MapPoint hash maps under mutexes (reference:
include/Map.hpp:9-36), landmarks keep observation lists (include/
MapPoint.hpp:10-28), features weak-link frames to landmarks
(include/Feature.hpp:9-22). None of that maps to a TPU. Here the map is a
struct of preallocated numpy arrays on the host (SURVEY.md §7.1 "arrays,
not objects"): landmark slots with alive masks, keyframe pose slots, and
integer index links. Device stages receive flat array views; the store
itself does only O(1) bookkeeping per insert, so host Python is never on
the hot path.

The active/passive split the reference scaffolds but never uses
(include/Map.hpp:29-34, `resetActive` never called) is realized here as
`active_window()` for the sliding-window BA.

The port's own copy of the JAX package's `ya_vo_tpu/worldmap/mapstore.py`:
the same classes and methods (held equal by
tests/test_torch_numpy_modules.py).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger("ya_vo_tpu_torch.map")


class ArchiveStore:
    """Retirement archive: creation stamp -> last refined position, backed
    by growable flat arrays instead of a python dict of 3-vectors.

    Why not a dict: the archive rides every BA re-anchor
    (`transform_archive`) and grows with every retirement wave — a
    4,000-frame run retires ~10^5 landmarks, and a per-entry python loop
    on each of the ~600 BA applies turned the transform into seconds of
    host time per frame late in the run (round-5 longrun profile). Here
    the transform is ONE [N,3] matmul and appends are amortized O(1).

    Keeps a dict-compatible surface (len/bool/keys/values/getitem/setitem)
    so checkpoint/tests that treat it as a mapping keep working.
    """

    def __init__(self, init_cap: int = 4096):
        self._stamps = np.zeros(init_cap, np.int64)
        self._pos = np.zeros((init_cap, 3), np.float32)
        self._n = 0
        self._row = {}          # stamp -> row index

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def keys(self):
        return self._stamps[: self._n]

    def values(self):
        return list(self._pos[: self._n])

    def __contains__(self, stamp):
        return int(stamp) in self._row

    def __getitem__(self, stamp):
        return self._pos[self._row[int(stamp)]]

    def _grow(self, need: int) -> None:
        cap = len(self._stamps)
        if self._n + need <= cap:
            return
        new_cap = max(cap * 2, self._n + need)
        self._stamps = np.resize(self._stamps, new_cap)
        self._pos = np.resize(self._pos, (new_cap, 3))

    def __setitem__(self, stamp, pos):
        s = int(stamp)
        r = self._row.get(s)
        if r is None:
            self._grow(1)
            r = self._n
            self._row[s] = r
            self._stamps[r] = s
            self._n += 1
        self._pos[r] = pos

    def update_bulk(self, stamps: np.ndarray, positions: np.ndarray) -> None:
        """Insert-or-update many (stamp, position) rows at once."""
        stamps = np.asarray(stamps, np.int64)
        positions = np.asarray(positions, np.float32)
        rows = np.fromiter((self._row.get(int(s), -1) for s in stamps),
                           np.int64, len(stamps))
        hit = rows >= 0
        if hit.any():
            self._pos[rows[hit]] = positions[hit]
        n_new = int((~hit).sum())
        if n_new:
            self._grow(n_new)
            r0 = self._n
            new_stamps = stamps[~hit]
            self._stamps[r0: r0 + n_new] = new_stamps
            self._pos[r0: r0 + n_new] = positions[~hit]
            for i, s in enumerate(new_stamps.tolist()):
                self._row[s] = r0 + i
            self._n += n_new

    def transform(self, T: np.ndarray) -> None:
        """X' = R X + t over the whole archive, one vectorized pass."""
        if not self._n:
            return
        R = np.asarray(T[:3, :3], np.float32)
        t = np.asarray(T[:3, 3], np.float32)
        self._pos[: self._n] = self._pos[: self._n] @ R.T + t

    def arrays(self):
        """(stamps, positions) views sorted by stamp."""
        order = np.argsort(self._stamps[: self._n], kind="stable")
        return self._stamps[order], self._pos[order]


class MapStore:
    """Fixed-capacity landmark + keyframe store with observation links.

    Lifecycle (absent in round 1, required for full-length sequences —
    KITTI 00 is 4,541 frames): dead landmark slots are RECYCLED through a
    free list (`recycle_dead`), and the oldest keyframes are EVICTED in
    blocks when the ring fills (`evict_oldest_keyframes`). The reference
    gets the landmark half implicitly via shared_ptr/weak_ptr expiry
    (reference: include/MapPoint.hpp:10-28, weak_ptr obs lapse when frames
    release their features) and never bounds keyframes at all (its Map
    grows without limit, include/Map.hpp:29-34). Every capacity event here
    is LOUD (logging), never a silent -1.

    Creation stamps: each landmark/keyframe carries a monotonically
    increasing stamp so "created after snapshot X" is well-defined even
    when slots are recycled or shifted — the async-BA correction uses
    stamps, not slot ranges.
    """

    def __init__(self, max_landmarks: int = 16384, max_keyframes: int = 512,
                 max_obs_per_kf: int = 2048):
        self.max_landmarks = max_landmarks
        self.max_keyframes = max_keyframes
        self.max_obs_per_kf = max_obs_per_kf

        self.landmark_pos = np.zeros((max_landmarks, 3), np.float32)
        self.landmark_alive = np.zeros(max_landmarks, bool)
        self.landmark_obs_count = np.zeros(max_landmarks, np.int32)
        self.landmark_stamp = np.zeros(max_landmarks, np.int64)
        self.n_landmarks = 0        # high-water mark of allocated slots
        self._free = []             # recycled slot stack (below high-water)
        self.lm_stamp_counter = 0   # monotonic creation stamp
        self.n_recycled = 0         # lifetime counters (observability)
        self.n_retired = 0          # out-of-window retirements
        self.n_evicted_keyframes = 0
        self.n_dropped_landmarks = 0  # add_landmarks truncations

        self.kf_pose = np.tile(np.eye(4, dtype=np.float32),
                               (max_keyframes, 1, 1))
        self.kf_frame_id = np.full(max_keyframes, -1, np.int64)
        self.kf_valid = np.zeros(max_keyframes, bool)
        self.kf_stamp = np.zeros(max_keyframes, np.int64)
        self.n_keyframes = 0
        self.kf_stamp_counter = 0
        # sliding-window fence: keyframes BEFORE this slot must never share
        # a BA window with keyframes after it. Set at monocular scale
        # breaks (a two-view bootstrap re-triangulates at unit baseline,
        # reference reinitialize semantics src/LoopHandler.cc:168-296):
        # a window straddling the break would make GN reconcile two
        # incompatible scales, and its "corrections" whiplash the live
        # pose — the round-3 reset-storm PERSISTENCE mechanism.
        self.window_barrier = 0

        # per-keyframe observations: pixel + landmark link (-1 = none)
        self.kf_obs_uv = np.zeros((max_keyframes, max_obs_per_kf, 2),
                                  np.float32)
        self.kf_obs_lm = np.full((max_keyframes, max_obs_per_kf), -1,
                                 np.int32)
        self.kf_obs_valid = np.zeros((max_keyframes, max_obs_per_kf), bool)
        # creation stamp of the linked landmark at observation time: with
        # slot recycling, (slot id, stamp) — not the slot id alone — names
        # a landmark for the rest of the session. Offline refinement uses
        # this to resolve scrubbed links against the retirement archive.
        self.kf_obs_stamp = np.full((max_keyframes, max_obs_per_kf), -1,
                                    np.int64)
        # retirement archive: creation stamp -> last (BA-refined) position
        # of a landmark retired out of the live window. The LIVE pipeline
        # never reads this (VO retention contract, see
        # retire_out_of_window); offline full-session refinement
        # (ba/global_refine) restores these as solvable geometry so old
        # windows keep real observations instead of being starved by slot
        # recycling. Outlier-killed landmarks are deliberately NOT archived.
        self._archive = ArchiveStore()

    @property
    def archive(self) -> ArchiveStore:
        return self._archive

    @archive.setter
    def archive(self, value) -> None:
        # accept a plain mapping (checkpoint restore, tests snapshotting
        # with dict(m.archive)) and convert
        if isinstance(value, ArchiveStore):
            self._archive = value
            return
        a = ArchiveStore(max(len(value), 4) * 2)
        if len(value):
            stamps = np.fromiter(value.keys(), np.int64, len(value))
            pos = np.stack([value[int(s)] for s in stamps])
            a.update_bulk(stamps, pos)
        self._archive = a

    # -- landmarks --------------------------------------------------------
    @property
    def free_landmark_capacity(self) -> int:
        """Slots available without recycling: fresh + free-listed."""
        return self.max_landmarks - self.n_landmarks + len(self._free)

    def add_landmarks(self, positions: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Insert `positions[mask]` as new landmarks, reusing recycled slots
        first, then fresh slots up to capacity.

        Returns an int32 array shaped like `mask` with the assigned landmark
        index per input row (-1 where masked off or capacity exhausted —
        exhaustion is logged, never silent).
        """
        positions = np.asarray(positions, np.float32)
        mask = np.asarray(mask, bool)
        idx_out = np.full(mask.shape[0], -1, np.int32)
        sel = np.nonzero(mask)[0]
        if sel.size == 0:
            return idx_out
        n_free = len(self._free)
        space = self.max_landmarks - self.n_landmarks + n_free
        if sel.size > space:
            dropped = sel.size - space
            self.n_dropped_landmarks += dropped
            log.warning(
                "landmark capacity exhausted: dropping %d of %d new "
                "landmarks (hwm=%d free=%d cap=%d) — raise "
                "MapConfig.max_landmarks or recycle more aggressively",
                dropped, sel.size, self.n_landmarks, n_free,
                self.max_landmarks)
            sel = sel[:space]
        n_reuse = min(n_free, sel.size)
        slots = np.empty(sel.size, np.int64)
        if n_reuse:
            slots[:n_reuse] = self._free[-n_reuse:]
            del self._free[-n_reuse:]
        n_fresh = sel.size - n_reuse
        if n_fresh:
            slots[n_reuse:] = np.arange(self.n_landmarks,
                                        self.n_landmarks + n_fresh)
            self.n_landmarks += n_fresh
        self.landmark_pos[slots] = positions[sel]
        self.landmark_alive[slots] = True
        self.landmark_obs_count[slots] = 0
        self.landmark_stamp[slots] = np.arange(
            self.lm_stamp_counter, self.lm_stamp_counter + sel.size)
        self.lm_stamp_counter += sel.size
        idx_out[sel] = slots.astype(np.int32)
        return idx_out

    def kill_landmarks(self, indices: np.ndarray) -> None:
        """Mark landmarks dead (reference drops outlier map points by
        resetting the feature's weak_ptr, src/LoopHandler.cc:850-855).
        Dead slots become reusable after `recycle_dead` scrubs their
        remaining keyframe observations."""
        indices = np.asarray(indices)
        valid = indices[(indices >= 0) & (indices < self.max_landmarks)]
        self.landmark_alive[valid] = False

    def recycle_dead(self, protected: Optional[np.ndarray] = None) -> int:
        """Reclaim dead landmark slots onto the free list.

        Any keyframe observation still referencing a reclaimed slot is
        scrubbed first (one vectorized lookup over the obs table) —
        otherwise a reused slot would silently alias a new landmark into an
        old keyframe's residuals. `protected` slots (e.g. the frontend's
        live track table, which may still reference recently-killed
        entries) are never reclaimed. Returns the number reclaimed.
        """
        hwm = self.n_landmarks
        dead = ~self.landmark_alive[:hwm]
        if len(self._free):
            dead[np.asarray(self._free)] = False  # already on the free list
        if protected is not None:
            p = np.asarray(protected)
            p = p[(p >= 0) & (p < hwm)]
            dead[p] = False
        slots = np.nonzero(dead)[0]
        if slots.size == 0:
            return 0
        # scrub stale observations of the reclaimed slots
        nk = self.n_keyframes
        if nk:
            reclaim = np.zeros(hwm + 1, bool)
            reclaim[slots] = True
            obs = self.kf_obs_lm[:nk]
            stale = (obs >= 0) & (obs < hwm) & reclaim[np.clip(obs, 0, hwm)]
            self.kf_obs_valid[:nk][stale] = False
        self._free.extend(slots.tolist())
        self.n_recycled += slots.size
        log.info("recycled %d dead landmark slots (free=%d hwm=%d)",
                 slots.size, len(self._free), self.n_landmarks)
        return int(slots.size)

    def retire_out_of_window(self, window: int,
                             protected: Optional[np.ndarray] = None,
                             max_per_wave: int = 4096) -> int:
        """Kill live landmarks that no keyframe in the last `window` observes
        and that aren't `protected` (the frontend's live track table).

        This is the VO (not SLAM) retention contract: once a landmark has
        left both the live track table and the BA window it can never again
        contribute a residual — tracking re-acquires structure by
        triangulating fresh landmarks, and PnP relocalization matches
        against the ANCHOR keyframe (inside the window). The reference gets
        the same effect implicitly: its features hold weak_ptrs that lapse
        once frames release them (reference: include/MapPoint.hpp:10-28).
        Without retirement a 16k-slot map fills after ~55 keyframes and
        replenishment starves for the rest of a 4,500-frame sequence
        (observed: 1.06M dropped landmarks, 19 resets, ATE 856 m).

        Returns the number retired. Call `recycle_dead` afterwards to move
        the slots onto the free list (it also scrubs any old-keyframe
        observations still referencing them).
        """
        k0 = max(0, self.n_keyframes - window)
        keep = np.zeros(self.max_landmarks + 1, bool)
        obs = self.kf_obs_lm[k0:self.n_keyframes]
        keep[obs[self.kf_obs_valid[k0:self.n_keyframes]]] = True
        if protected is not None:
            p = np.asarray(protected)
            keep[p[(p >= 0) & (p < self.max_landmarks)]] = True
        hwm = self.n_landmarks
        retire = self.landmark_alive[:hwm] & ~keep[:hwm]
        idx = np.nonzero(retire)[0]
        if max_per_wave > 0 and idx.size > max_per_wave:
            # bound the wave: retiring >10k landmarks in one resolve was
            # measured (round 5, longrun route) to precede a live-track
            # collapse within ~4 frames — spread the pressure relief over
            # several keyframes, oldest creation stamps first
            order = np.argsort(self.landmark_stamp[idx], kind="stable")
            idx = idx[order[:max_per_wave]]
        if idx.size:
            # archive retirements for offline refinement (NOT outlier
            # kills — kill_landmarks drops bad geometry unarchived)
            self._archive.update_bulk(self.landmark_stamp[idx],
                                      self.landmark_pos[idx])
            self.landmark_alive[idx] = False
            self.n_retired += idx.size
            log.info("retired %d out-of-window landmarks (window=%d, "
                     "alive now %d)", idx.size, window,
                     int(self.landmark_alive.sum()))
        return int(idx.size)

    def transform_archive(self, T: np.ndarray) -> None:
        """Move every archived (retired) landmark position by `T` as
        points (X' = R X + t). MUST be called with the same corr^-1 a BA
        apply uses for fresh/stranded live landmarks
        (tracking.frontend._apply_ba_result): the archive is offline-
        refinement geometry and has to stay in the CURRENT map frame —
        round-5 measurement: un-transformed archives made offline sweeps
        pull poses toward stale coordinates and DEGRADED ATE 0.12 -> 0.64."""
        self._archive.transform(np.asarray(T, np.float32))

    def update_landmark_positions(self, indices: np.ndarray,
                                  positions: np.ndarray) -> None:
        ok = indices >= 0
        self.landmark_pos[indices[ok]] = positions[ok]

    # -- keyframes --------------------------------------------------------
    def evict_oldest_keyframes(self, n: int,
                               protected_landmarks: Optional[np.ndarray]
                               = None) -> int:
        """Drop the `n` oldest keyframes (block eviction, arrays shift left
        so slot order stays chronological and monotonic between evictions).

        Landmarks losing their last observation are killed — unless
        `protected_landmarks` (the frontend's live track table) still uses
        them. Callers holding keyframe SLOT indices across this call must
        invalidate them (the frontend bumps its session epoch so in-flight
        async BA is discarded). Returns the number evicted.
        """
        n = min(n, self.n_keyframes)
        if n <= 0:
            return 0
        # release evicted observations
        ev_valid = self.kf_obs_valid[:n]
        ev_lm = self.kf_obs_lm[:n][ev_valid]
        np.add.at(self.landmark_obs_count, ev_lm, -1)
        orphan = np.zeros(self.max_landmarks, bool)
        orphan[ev_lm] = True
        orphan &= self.landmark_obs_count <= 0
        if protected_landmarks is not None:
            p = np.asarray(protected_landmarks)
            p = p[(p >= 0) & (p < self.max_landmarks)]
            orphan[p] = False
        self.landmark_alive[orphan] = False

        k = self.n_keyframes
        for arr in (self.kf_pose, self.kf_frame_id, self.kf_valid,
                    self.kf_stamp, self.kf_obs_uv, self.kf_obs_lm,
                    self.kf_obs_valid, self.kf_obs_stamp):
            arr[: k - n] = arr[n:k]
        self.kf_valid[k - n: k] = False
        self.kf_obs_valid[k - n: k] = False
        self.n_keyframes = k - n
        self.window_barrier = max(0, self.window_barrier - n)
        self.n_evicted_keyframes += n
        log.info("evicted %d oldest keyframes (now %d/%d); %d landmarks "
                 "orphaned", n, self.n_keyframes, self.max_keyframes,
                 int(orphan.sum()))
        return n

    def insert_keyframe(
        self, frame_id: int, pose_wc: np.ndarray,
        obs_uv: Optional[np.ndarray] = None,
        obs_lm: Optional[np.ndarray] = None,
        obs_valid: Optional[np.ndarray] = None,
    ) -> int:
        """Insert a keyframe (reference Map::insertKeyFrame, src/Map.cc:9-23).
        Returns the keyframe slot, or -1 when capacity is exhausted (the
        frontend evicts ahead of this; a -1 here is logged loudly)."""
        if self.n_keyframes >= self.max_keyframes:
            log.warning("keyframe capacity exhausted (%d) — insert refused; "
                        "caller should evict_oldest_keyframes first",
                        self.max_keyframes)
            return -1
        k = self.n_keyframes
        self.kf_pose[k] = np.asarray(pose_wc, np.float32)
        self.kf_frame_id[k] = frame_id
        self.kf_valid[k] = True
        self.kf_stamp[k] = self.kf_stamp_counter
        self.kf_stamp_counter += 1
        if obs_uv is not None:
            n = min(len(obs_uv), self.max_obs_per_kf)
            if len(obs_uv) > self.max_obs_per_kf:
                log.warning("keyframe %d observations truncated %d -> %d",
                            frame_id, len(obs_uv), self.max_obs_per_kf)
            self.kf_obs_uv[k, :n] = obs_uv[:n]
            self.kf_obs_lm[k, :n] = obs_lm[:n]
            ov = obs_valid[:n] if obs_valid is not None else np.ones(n, bool)
            self.kf_obs_valid[k, :n] = ov & (self.kf_obs_lm[k, :n] >= 0)
            self.kf_obs_stamp[k, :n] = np.where(
                self.kf_obs_valid[k, :n],
                self.landmark_stamp[np.maximum(self.kf_obs_lm[k, :n], 0)],
                -1)
            if obs_lm is not None:
                linked = self.kf_obs_lm[k, :n][self.kf_obs_valid[k, :n]]
                np.add.at(self.landmark_obs_count, linked, 1)
        self.n_keyframes += 1
        return k

    def update_keyframe_poses(self, kf_indices: np.ndarray,
                              poses: np.ndarray) -> None:
        self.kf_pose[kf_indices] = poses

    # -- views ------------------------------------------------------------
    def alive_landmarks(self):
        """(positions [n, 3], indices [n]) of live landmarks."""
        idx = np.nonzero(self.landmark_alive[: self.n_landmarks])[0]
        return self.landmark_pos[idx], idx

    def mark_scale_break(self) -> None:
        """Fence the BA window at the current keyframe count (call BEFORE
        inserting the first keyframe of the new-scale segment)."""
        self.window_barrier = self.n_keyframes

    def active_window(self, window: int):
        """Last `window` keyframes: (kf_slots, poses, obs_uv, obs_lm, obs_valid)
        — the input to sliding-window BA. Never crosses `window_barrier`
        (monocular scale breaks, see __init__)."""
        k0 = max(0, self.n_keyframes - window, self.window_barrier)
        sl = slice(k0, self.n_keyframes)
        slots = np.arange(k0, self.n_keyframes)
        return (
            slots,
            self.kf_pose[sl],
            self.kf_obs_uv[sl],
            self.kf_obs_lm[sl],
            self.kf_obs_valid[sl],
        )

    def stats(self) -> dict:
        return {
            "n_landmarks": int(self.n_landmarks),
            "n_alive": int(self.landmark_alive.sum()),
            "n_keyframes": int(self.n_keyframes),
            "n_free": len(self._free),
            "n_recycled": int(self.n_recycled),
            "n_retired": int(self.n_retired),
            "n_evicted_keyframes": int(self.n_evicted_keyframes),
            "n_dropped_landmarks": int(self.n_dropped_landmarks),
        }
