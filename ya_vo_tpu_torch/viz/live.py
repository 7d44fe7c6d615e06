"""Live incremental viewer — the reference's Pangolin thread, TPU-host style.

The reference runs a Viewer on its own thread that renders the current
frustum, the keyframe trail and the landmark cloud from a double-buffered
map snapshot taken under a mutex (reference src/viz.cc:26-78,
include/viz.hpp:7-39). TPU hosts are headless, so instead of an OpenGL
window this serves the same live state over a localhost HTTP endpoint:

  * GET /          — a self-contained HTML page (canvas, no external
                     assets) that polls /state.json a few times a second
                     and draws the top-down trajectory, landmark cloud,
                     current camera frustum and per-frame stats — the
                     content of misc/kitti01.png + misc/mapping.png, live.
  * GET /state.json — {"traj": [[x,z],...], "landmarks": [[x,z],...],
                     "pose": 4x4, "frame_id", "status", "n_inliers",
                     "fps", "resets"}

Producer side mirrors the reference's API: `add_frame(result, pose)` after
every processed frame and `update_map(mapstore)` after keyframes, both
cheap (snapshot copy under a lock — viz.cc's updateMap, :26-30). The
server runs on a daemon thread; `LiveViewer(port=0)` picks a free port.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>ya_vo_tpu live</title><style>
 body { background:#111; color:#ccc; font:13px monospace; margin:0 }
 #hud { padding:6px 10px }
 canvas { display:block; margin:0 auto; background:#181818 }
</style></head><body>
<div id="hud">connecting...</div>
<canvas id="c" width="900" height="640"></canvas>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
async function tick() {
  try {
    const s = await (await fetch('/state.json')).json();
    hud.textContent = `frame ${s.frame_id}  ${s.status}  ` +
      `inliers ${s.n_inliers}  keyframes ${s.n_keyframes}  ` +
      `landmarks ${s.n_landmarks}  resets ${s.resets}  ` +
      `${s.fps.toFixed(1)} fps`;
    ctx.clearRect(0, 0, cv.width, cv.height);
    const pts = s.traj, lms = s.landmarks;
    if (pts.length > 1) {
      let xs = pts.map(p => p[0]).concat(lms.map(p => p[0]));
      let zs = pts.map(p => p[1]).concat(lms.map(p => p[1]));
      const x0 = Math.min(...xs), x1 = Math.max(...xs);
      const z0 = Math.min(...zs), z1 = Math.max(...zs);
      const sc = 0.9 * Math.min(cv.width / Math.max(x1 - x0, 1e-3),
                                cv.height / Math.max(z1 - z0, 1e-3));
      const X = x => (x - (x0 + x1) / 2) * sc + cv.width / 2;
      const Z = z => cv.height / 2 - (z - (z0 + z1) / 2) * sc;
      ctx.fillStyle = '#3a6ea5';
      for (const p of lms) ctx.fillRect(X(p[0]) - 1, Z(p[1]) - 1, 2, 2);
      ctx.strokeStyle = '#e05252'; ctx.lineWidth = 2; ctx.beginPath();
      ctx.moveTo(X(pts[0][0]), Z(pts[0][1]));
      for (const p of pts) ctx.lineTo(X(p[0]), Z(p[1]));
      ctx.stroke();
      const last = pts[pts.length - 1];
      ctx.fillStyle = '#6ee06e';
      ctx.beginPath();
      ctx.arc(X(last[0]), Z(last[1]), 5, 0, 6.3); ctx.fill();
    }
  } catch (e) { hud.textContent = 'viewer: ' + e; }
  setTimeout(tick, 250);
}
tick();
</script></body></html>
"""


class LiveViewer:
    """Threaded live state server (see module docstring).

    max_landmarks: cap on cloud points shipped per poll (uniformly
    subsampled) so state.json stays small on big maps."""

    def __init__(self, port: int = 0, max_landmarks: int = 4000):
        self._lock = threading.Lock()
        self._max_lm = max_landmarks
        # trajectory shipped to the page is CAPPED like the landmark cloud:
        # beyond max_traj points, decimate in place and keep only every
        # k-th new point — otherwise a 4,500-frame run JSON-encodes
        # thousands of points under the producer lock on every ~4 Hz poll
        self._max_traj = 4000
        self._traj_stride = 1
        self._traj_phase = 0
        self._traj: list = []
        self._state = {
            "frame_id": -1, "status": "INIT", "n_inliers": 0,
            "n_keyframes": 0, "n_landmarks": 0, "resets": 0, "fps": 0.0,
            "pose": np.eye(4).tolist(), "traj": [], "landmarks": [],
        }
        self._t_last = time.perf_counter()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    body = viewer.state_json().encode()
                    ctype = "application/json"
                elif self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="live-viewer", daemon=True)
        self._thread.start()

    # ---- producer API (reference viz.cc:16-30) ------------------------- #
    def add_frame(self, result, pose_wc: np.ndarray) -> None:
        """Per-frame update: current pose + tracking stats
        (viz.cc addCurrentFrame)."""
        T = np.asarray(pose_wc, dtype=np.float64)
        R, t = T[:3, :3], T[:3, 3]
        c = -R.T @ t  # camera center in world
        now = time.perf_counter()
        dt = max(now - self._t_last, 1e-6)
        self._t_last = now
        with self._lock:
            self._traj_phase += 1
            if self._traj_phase >= self._traj_stride:
                self._traj_phase = 0
                self._traj.append([float(c[0]), float(c[2])])
                if len(self._traj) > self._max_traj:
                    self._traj = self._traj[::2]
                    self._traj_stride *= 2
            s = self._state
            s["frame_id"] = int(getattr(result, "frame_id", s["frame_id"]))
            st = getattr(result, "status", None)
            s["status"] = getattr(st, "name", str(st))
            s["n_inliers"] = int(getattr(result, "n_ba_inliers", 0))
            s["fps"] = 0.9 * s["fps"] + 0.1 * (1.0 / dt) if s["fps"] else \
                1.0 / dt
            s["pose"] = T.tolist()
            s["traj"] = self._traj

    def update_map(self, mapstore, n_resets: int = 0) -> None:
        """Keyframe-cadence update: snapshot the landmark cloud
        (viz.cc updateMap — double-buffered copy under the lock)."""
        pos, _ = mapstore.alive_landmarks()
        pos = np.asarray(pos)
        if len(pos) > self._max_lm:
            step = len(pos) // self._max_lm + 1
            pos = pos[::step]
        cloud = [[float(p[0]), float(p[2])] for p in pos]
        with self._lock:
            s = self._state
            s["landmarks"] = cloud
            s["n_keyframes"] = int(mapstore.n_keyframes)
            s["n_landmarks"] = int(mapstore.stats()["n_alive"])
            s["resets"] = int(n_resets)

    # ---- consumer side -------------------------------------------------- #
    def state_json(self) -> str:
        with self._lock:
            return json.dumps(self._state)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def attach(frontend, port: int = 0,
           update_every: int = 1) -> "LiveViewer":
    """Wire a LiveViewer into a Frontend via its observer hook (fires on
    both the sync and pipelined drivers) — the two producer calls the
    reference makes from its VO loop (src/LoopHandler.cc:86-90, :159-162):
    per-frame pose/stats, keyframe-cadence landmark cloud."""
    viewer = LiveViewer(port=port)

    def on_frame(r):
        if r.frame_id % update_every == 0:
            viewer.add_frame(r, frontend.last_pose)
        if getattr(r, "is_keyframe", False) or r.frame_id % 25 == 0:
            viewer.update_map(frontend.map, frontend.n_resets)

    frontend.observers.append(on_frame)
    frontend.live_viewer = viewer
    return viewer
