"""KITTI odometry dataset IO: calibration, image streams, ground truth.

Port of `ya_vo_tpu/io/kitti.py`: the same functions, with
`CalibratedCamera.camera()` onto the port's `core.camera.Camera` (the
original builds the JAX package's) and frames decoded through the port's
copy of `native_loader`, then PIL.

Covers the reference's `Utils` parsing (reference: src/Utils.cc:4-64 parses
`calib.txt` lines "P0: <12 floats>" into 3x4 projection matrices, first two
lines = left/right gray cameras; K = left 3x3) and `LoopHandler`'s path-train
construction (src/LoopHandler.cc:37-57: `<base>/sequences/<seq>/image_0/*.png`
sorted). Adds what the reference lacks: ground-truth pose loading for ATE/RPE
(poses/<seq>.txt) and trajectory export in KITTI format.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ya_vo_tpu_torch.core.camera import Camera


@dataclass(frozen=True)
class CalibratedCamera:
    """One KITTI camera: full 3x4 projection and pinhole intrinsics."""

    P: np.ndarray  # [3, 4]

    @property
    def K(self) -> np.ndarray:
        return self.P[:3, :3]

    @property
    def fx(self) -> float: return float(self.P[0, 0])
    @property
    def fy(self) -> float: return float(self.P[1, 1])
    @property
    def cx(self) -> float: return float(self.P[0, 2])
    @property
    def cy(self) -> float: return float(self.P[1, 2])

    def camera(self) -> Camera:
        return Camera.create(self.fx, self.fy, self.cx, self.cy)


def parse_calib_line(line: str) -> np.ndarray:
    """Parse one 'Pk: v0 ... v11' line into a [3, 4] float64 matrix.

    Same semantics as reference `parseCalibString` (src/Utils.cc:4-29): the
    label token is skipped, 12 values fill rows 0..2.
    """
    tokens = line.replace(":", " ").split()
    vals = []
    for tok in tokens:
        try:
            vals.append(float(tok))
        except ValueError:
            continue  # label token, e.g. "P0"
    if len(vals) < 12:
        raise ValueError(f"calib line has {len(vals)} values, need 12: {line!r}")
    return np.array(vals[:12], dtype=np.float64).reshape(3, 4)


def load_calib(path: str) -> Tuple[CalibratedCamera, CalibratedCamera]:
    """Read calib.txt; first two lines are the left/right gray cameras
    (reference `getCalibParams`, src/Utils.cc:39-64)."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    if len(lines) < 2:
        raise ValueError(f"calib file {path} has fewer than 2 lines")
    return (
        CalibratedCamera(parse_calib_line(lines[0])),
        CalibratedCamera(parse_calib_line(lines[1])),
    )


def sequence_dir(base_path: str, sequence: str) -> str:
    return os.path.join(base_path, "sequences", sequence)


def list_images(base_path: str, sequence: str, camera: int = 0) -> List[str]:
    """Sorted image paths for a sequence (reference `generatePathTrain`
    src/LoopHandler.cc:37-57 + Boost sorted listing src/Utils.cc:31-36)."""
    img_dir = os.path.join(sequence_dir(base_path, sequence), f"image_{camera}")
    names = sorted(os.listdir(img_dir))
    return [os.path.join(img_dir, n) for n in names if n.endswith((".png", ".pgm", ".npy"))]


def load_image_gray(path: str) -> np.ndarray:
    """Load one frame as uint8 [H, W] grayscale.

    Uses the native C decoder when built (ya_vo_tpu_torch.io.native_loader),
    falling back to PIL. `.npy` fixtures load directly.
    """
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return img.astype(np.uint8)
    try:
        from ya_vo_tpu_torch.io import native_loader
        img = native_loader.decode_png_gray(path)
        if img is not None:
            return img
    except Exception:
        pass
    from PIL import Image
    return np.asarray(Image.open(path).convert("L"), dtype=np.uint8)


def load_poses(path: str) -> np.ndarray:
    """Load a KITTI 12-number-row poses file as [N, 4, 4] (cam->world) —
    the inverse of `save_trajectory_kitti` (reference poses-file
    semantics: src/Utils.cc:39-64 reads the same row layout)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = rows
    return poses


def load_gt_poses(base_path: str, sequence: str) -> Optional[np.ndarray]:
    """Ground-truth trajectory [N, 4, 4] (cam0->world), or None if absent."""
    path = os.path.join(base_path, "poses", f"{sequence}.txt")
    if not os.path.exists(path):
        return None
    return load_poses(path)


def save_trajectory_kitti(path: str, poses_cam_to_world: np.ndarray) -> None:
    """Write [N, 4, 4] camera->world poses in KITTI 12-number row format."""
    rows = np.asarray(poses_cam_to_world)[:, :3, :4].reshape(-1, 12)
    np.savetxt(path, rows, fmt="%.9e")


class ImageStream:
    """Iterates a sequence's frames as uint8 arrays; replaces the reference's
    serial `getNextFrame` + `cv::imread` (src/LoopHandler.cc:917-927)."""

    def __init__(self, base_path: str, sequence: str, camera: int = 0,
                 prefetch: int = 2):
        self.paths = list_images(base_path, sequence, camera)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self):
        if self.prefetch > 0:
            from ya_vo_tpu_torch.io.prefetch import PrefetchIterator
            return PrefetchIterator(self.paths, load_image_gray, self.prefetch)
        return (load_image_gray(p) for p in self.paths)
