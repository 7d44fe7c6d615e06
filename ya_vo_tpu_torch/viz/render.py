"""Static trajectory / map rendering.

Covers the observable output of the reference's Pangolin viewer (reference:
src/viz.cc — camera frustum trail + sparse landmark cloud, see
misc/kitti01.png and misc/mapping.png) without an interactive GL window:
matplotlib top-down (x-z) renders of the estimated trajectory, optional
ground truth overlay, and the landmark cloud. Headless-safe (Agg).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(
    est_wc: np.ndarray,
    gt_cw: Optional[np.ndarray] = None,
    landmarks: Optional[np.ndarray] = None,
    out_path: str = "trajectory.png",
    title: str = "trajectory (top-down)",
) -> str:
    """Render top-down trajectory; returns out_path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ya_vo_tpu_torch.viz.evaluation import positions_from_poses

    fig, ax = plt.subplots(figsize=(8, 8))
    pos = positions_from_poses(np.asarray(est_wc))
    ax.plot(pos[:, 0], pos[:, 2], "-", lw=1.5, label="estimate")
    ax.plot(pos[0, 0], pos[0, 2], "o", ms=6)
    if gt_cw is not None:
        g = np.asarray(gt_cw)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    if landmarks is not None and len(landmarks):
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, 0], lm[:, 2], s=1, alpha=0.25, label="landmarks")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def draw_keypoints(img: np.ndarray, uv: np.ndarray,
                   out_path: str = "keypoints.png") -> str:
    """Debug overlay of detected keypoints on a frame (the reference's
    cv::imshow feature overlay, src/viz.cc:81-94 / putPixel debug path)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img, cmap="gray")
    if len(uv):
        ax.scatter(uv[:, 0], uv[:, 1], s=6, c="lime", marker="+")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def draw_matches(img1: np.ndarray, img2: np.ndarray,
                 uv1: np.ndarray, uv2: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 out_path: str = "matches.png") -> str:
    """Side-by-side match visualization (reference Brief::drawMatches,
    src/BriefDescriptor.cc:186-210)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((H, img1.shape[1] + img2.shape[1]), np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    off = img1.shape[1]

    fig, ax = plt.subplots(figsize=(14, 5))
    ax.imshow(canvas, cmap="gray")
    uv1 = np.asarray(uv1)
    uv2 = np.asarray(uv2)
    sel = np.asarray(mask) if mask is not None else np.ones(len(uv1), bool)
    for a, b in zip(uv1[sel], uv2[sel]):
        ax.plot([a[0], b[0] + off], [a[1], b[1]], "-", lw=0.5, alpha=0.6)
    ax.scatter(uv1[sel, 0], uv1[sel, 1], s=4, c="lime", marker="o")
    ax.scatter(uv2[sel, 0] + off, uv2[sel, 1], s=4, c="cyan", marker="o")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def draw_epipolar_lines(img1: np.ndarray, img2: np.ndarray,
                        F: np.ndarray, uv1: np.ndarray,
                        out_path: str = "epilines.png") -> str:
    """Render epipolar lines of points uv1 into image 2 (reference
    3DHandlerTest epiline renders, tests/3DHandlerTest.cc:175-262 /
    tests/epilinesOpencv.png)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H2, W2 = img2.shape
    fig, axes = plt.subplots(1, 2, figsize=(14, 4))
    axes[0].imshow(img1, cmap="gray")
    axes[0].scatter(uv1[:, 0], uv1[:, 1], s=8, c="lime", marker="+")
    axes[0].set_title("points (view 1)")
    axes[1].imshow(img2, cmap="gray")
    for p in np.asarray(uv1):
        a, b, c = np.asarray(F) @ np.array([p[0], p[1], 1.0])
        if abs(b) > 1e-9:
            xs = np.array([0.0, W2 - 1.0])
            ys = -(a * xs + c) / b
            axes[1].plot(xs, ys, lw=0.6, alpha=0.7)
    axes[1].set_ylim(H2 - 1, 0)
    axes[1].set_xlim(0, W2 - 1)
    axes[1].set_title("epipolar lines (view 2)")
    for ax in axes:
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
