"""Synthetic KITTI-shaped scenes for tests and the GPU smoke run.

A numpy port of `ya_vo_tpu/utils/synthetic.py` that imports no JAX: the
same landmark draw, trajectory, track projection and stamp renderer, so a
sequence rendered here is byte-identical to the JAX module's for the same
arguments.
"""

from __future__ import annotations

import functools

import numpy as np

from ya_vo_tpu_torch.core.camera import Camera

# The stamps world of bench.py's secondary (bench.py:194-196): the
# `render_sequence` arguments of the port's main path in chip_smoke.py,
# profile_slice and the card tests.
STAMPS = dict(n_frames=40, n_landmarks=1200, height=376, width=1241,
              step=0.5, yaw_rate=0.002, seed=11, corridor=True)


def kitti_camera() -> Camera:
    """The KITTI gray-camera intrinsics (reference tests/calib.txt:1)."""
    return Camera.create(718.856, 718.856, 607.1928, 185.2157)


def random_landmarks(
    n: int, seed: int = 0,
    x_range=(-15.0, 15.0), y_range=(-4.0, 3.0), z_range=(6.0, 60.0),
) -> np.ndarray:
    """[n, 3] world points in front of the initial camera."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(*x_range, n), rng.uniform(*y_range, n),
                    rng.uniform(*z_range, n)], axis=-1)
    return pts.astype(np.float32)


def forward_trajectory(n_frames: int, step: float = 0.8,
                       yaw_rate: float = 0.0) -> np.ndarray:
    """[n, 4, 4] world->camera poses moving along +z with constant yaw."""
    poses = np.zeros((n_frames, 4, 4), dtype=np.float32)
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        R = R_cw.T
        poses[i, :3, :3] = R
        poses[i, :3, 3] = -R @ pos
        poses[i, 3, 3] = 1.0
        pos = pos + R_cw @ np.array([0.0, 0.0, step])
        yaw += yaw_rate
    return poses


def project_tracks(
    landmarks: np.ndarray, poses_wc: np.ndarray, cam: Camera,
    height: int, width: int, margin: int = 20,
):
    """Project every landmark into every frame.

    Returns (uv [F, N, 2] float32, vis [F, N] bool) — vis requires positive
    depth and in-bounds projection with `margin`.
    """
    F = poses_wc.shape[0]
    N = landmarks.shape[0]
    uv = np.zeros((F, N, 2), dtype=np.float32)
    vis = np.zeros((F, N), dtype=bool)
    fx = float(cam.fx); fy = float(cam.fy)
    cx = float(cam.cx); cy = float(cam.cy)
    for f in range(F):
        R = poses_wc[f, :3, :3]
        t = poses_wc[f, :3, 3]
        pc = landmarks @ R.T + t
        z = pc[:, 2]
        ok = z > 0.25
        zs = np.where(ok, z, 1.0)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        uv[f] = np.stack([u, v], axis=-1)
        vis[f] = (
            ok & (u >= margin) & (u < width - margin)
            & (v >= margin) & (v < height - margin)
        )
    return uv, vis


_STAMP_HALF = 8  # stamp is (2*_STAMP_HALF+1)^2


def _landmark_stamp(index: int, seed: int) -> np.ndarray:
    """Deterministic per-landmark binary texture stamp [17, 17]."""
    side = 2 * _STAMP_HALF + 1
    rng = np.random.default_rng(seed * 100003 + index)
    cells = rng.choice([0.0, 1.0], size=(side // 2 + 1, side // 2 + 1),
                       p=[0.55, 0.45])
    pattern = np.kron(cells, np.ones((2, 2)))[:side, :side]
    return pattern * rng.uniform(170, 250)


@functools.lru_cache(maxsize=16384)
def _stamp_shift_views(index: int, seed: int):
    """The stamp's four 1-px-rolled variants for the bilinear subpixel
    shift (cached: regenerating them per frame dominates rendering)."""
    stamp = _landmark_stamp(index, seed)
    side = stamp.shape[0]
    pad = np.zeros((side + 1, side + 1), np.float32)
    pad[:side, :side] = stamp
    p00 = pad[:side, :side]
    p01 = np.roll(pad, 1, axis=1)[:side, :side]
    p10 = np.roll(pad, 1, axis=0)[:side, :side]
    p11 = np.roll(np.roll(pad, 1, 0), 1, 1)[:side, :side]
    return p00.copy(), p01.copy(), p10.copy(), p11.copy()


def render_scene(
    landmarks: np.ndarray, pose_wc: np.ndarray, cam: Camera,
    height: int, width: int, seed: int = 3, background: int = 25,
) -> np.ndarray:
    """Render one uint8 [H, W] frame: each visible landmark's stamp drawn at
    its projection, bilinearly shifted by the subpixel fraction."""
    rng = np.random.default_rng(seed)
    img = np.full((height, width), background, dtype=np.float32)
    img += rng.normal(0.0, 1.5, size=img.shape)  # mild sensor noise

    pc = landmarks @ pose_wc[:3, :3].T + pose_wc[:3, 3]
    z = pc[:, 2]
    h = _STAMP_HALF
    for i in np.argsort(-z):  # far first, near overwrites
        zi = z[i]
        if zi <= 0.25:
            continue
        uf = cam.fx * pc[i, 0] / zi + cam.cx
        vf = cam.fy * pc[i, 1] / zi + cam.cy
        u, v = int(np.floor(uf)), int(np.floor(vf))
        if u < h + 1 or v < h + 1 or u >= width - h - 2 or v >= height - h - 2:
            continue
        p00, p01, p10, p11 = _stamp_shift_views(int(i), seed)
        au, av = uf - u, vf - v
        shifted = ((1 - au) * (1 - av) * p00 + au * (1 - av) * p01
                   + (1 - au) * av * p10 + au * av * p11)
        region = img[v - h:v + h + 1, u - h:u + h + 1]
        img[v - h:v + h + 1, u - h:u + h + 1] = np.where(
            shifted > 8.0, shifted, region)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_sequence(
    n_frames: int = 8, n_landmarks: int = 400,
    height: int = 376, width: int = 1241,
    step: float = 0.6, yaw_rate: float = 0.0, seed: int = 0,
    corridor: bool = False,
):
    """(images [F] uint8 [H, W], poses_wc [F, 4, 4], landmarks [N, 3], cam).
    With `corridor`, landmarks spread along the whole travel path."""
    cam = kitti_camera()
    z_far = 60.0 + (step * n_frames if corridor else 0.0)
    lms = random_landmarks(n_landmarks, seed=seed, z_range=(6.0, z_far))
    poses = forward_trajectory(n_frames, step=step, yaw_rate=yaw_rate)
    imgs = [render_scene(lms, poses[f], cam, height, width, seed=seed + 11)
            for f in range(n_frames)]
    return imgs, poses, lms, cam
