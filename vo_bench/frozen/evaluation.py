"""Frozen copy of the port's trajectory evaluation (`ya_vo_tpu_torch/viz/
evaluation.py`): ATE after Sim(3) alignment and KITTI's segment errors,
which each run prints on an earlier line. Held equal to its source by
`vo_bench/tests/test_vo_bench_frozen.py`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst ([N, 3] each).
    Returns (R, t, s) with dst ~ s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def positions_from_poses(poses_wc: np.ndarray) -> np.ndarray:
    """World->camera poses [N, 4, 4] -> camera centers [N, 3]
    (c = -R^T t)."""
    R = poses_wc[:, :3, :3]
    t = poses_wc[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)


def ate_rmse(
    est_wc: np.ndarray, gt_cw: np.ndarray, with_scale: bool = True
) -> float:
    """ATE RMSE (meters) between estimated world->camera poses and KITTI
    ground truth camera->world poses, after (Sim(3) if with_scale) alignment."""
    est_pos = positions_from_poses(est_wc)
    gt_pos = gt_cw[:, :3, 3]
    n = min(len(est_pos), len(gt_pos))
    est_pos, gt_pos = est_pos[:n], gt_pos[:n]
    R, t, s = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_pos) ** 2, axis=-1))))


def ate_trace(
    est_wc: np.ndarray, gt_cw: np.ndarray, with_scale: bool = True
) -> np.ndarray:
    """Per-frame position error [N] after global (Sim(3)) alignment — the
    pointwise trace whose RMS is `ate_rmse`. For diagnosing WHERE along a
    route drift accumulates (reset sites, discarded-BA stretches)."""
    est_pos = positions_from_poses(est_wc)
    gt_pos = gt_cw[:, :3, 3]
    n = min(len(est_pos), len(gt_pos))
    est_pos, gt_pos = est_pos[:n], gt_pos[:n]
    R, t, s = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    return np.linalg.norm(aligned - gt_pos, axis=-1)


def sim3_scale(est_wc: np.ndarray, gt_cw: np.ndarray) -> float:
    """Global monocular scale: the Sim(3) (Umeyama) scale factor aligning
    estimated camera centers to ground truth."""
    est_pos = positions_from_poses(est_wc)
    gt_pos = gt_cw[:, :3, 3]
    n = min(len(est_pos), len(gt_pos))
    _, _, s = umeyama_alignment(est_pos[:n], gt_pos[:n], with_scale=True)
    return float(s)


def rpe(
    est_wc: np.ndarray, gt_cw: np.ndarray, delta: int = 1,
    align_scale: bool = True,
) -> Tuple[float, float]:
    """Relative pose error over `delta` frames.
    Returns (trans RMSE meters, rot RMSE degrees).

    A monocular pipeline estimates translation only up to a global scale;
    with align_scale=True (default) the estimated relative translations are
    scaled by the trajectory's global Sim(3) factor first, so the
    translational number measures drift, not the arbitrary bootstrap unit
    (round-1 VERDICT weak #4)."""
    n = min(len(est_wc), len(gt_cw))
    s = sim3_scale(est_wc[:n], gt_cw[:n]) if align_scale else 1.0
    est_cw = np.linalg.inv(est_wc[:n])
    gt = gt_cw[:n]
    dts, drs = [], []
    for i in range(n - delta):
        rel_est = np.linalg.inv(est_cw[i]) @ est_cw[i + delta]
        rel_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        rel_est = rel_est.copy()
        rel_est[:3, 3] *= s
        err = np.linalg.inv(rel_gt) @ rel_est
        dts.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        drs.append(np.degrees(np.arccos(c)))
    return (
        float(np.sqrt(np.mean(np.square(dts)))),
        float(np.sqrt(np.mean(np.square(drs)))),
    )


def scale_drift(
    est_wc: np.ndarray, gt_cw: np.ndarray, delta: int = 10,
    min_motion: float = 0.05,
) -> dict:
    """How the monocular scale wanders along the trajectory.

    For each frame pair (i, i+delta): s_i = (global-Sim3-scaled estimated
    step length) / (ground-truth step length). Pairs where ground truth
    moves less than `min_motion` meters are skipped (ratio undefined at a
    standstill). Returns {rms_log, max_abs_log, median}: rms_log is the RMS
    of |ln s_i| — 0.0 means perfectly scale-consistent; 0.1 ≈ 10% drift.
    The global Sim(3) alignment hides exactly this error in ate_rmse
    (round-1 VERDICT weak #4), so it is reported separately."""
    n = min(len(est_wc), len(gt_cw))
    s = sim3_scale(est_wc[:n], gt_cw[:n])
    est_pos = positions_from_poses(est_wc[:n]) * s
    gt_pos = gt_cw[:n, :3, 3]
    d_est = np.linalg.norm(est_pos[delta:] - est_pos[:-delta], axis=-1)
    d_gt = np.linalg.norm(gt_pos[delta:] - gt_pos[:-delta], axis=-1)
    keep = d_gt > min_motion
    if not keep.any():
        return {"rms_log": 0.0, "max_abs_log": 0.0, "median": 1.0,
                "n_pairs": 0}
    log_r = np.log(np.maximum(d_est[keep], 1e-12) / d_gt[keep])
    return {
        "rms_log": float(np.sqrt(np.mean(log_r ** 2))),
        "max_abs_log": float(np.abs(log_r).max()),
        "median": float(np.exp(np.median(log_r))),
        "n_pairs": int(keep.sum()),
    }


def kitti_segment_errors(
    est_wc: np.ndarray, gt_cw: np.ndarray,
    lengths: Tuple[float, ...] = (100.0, 200.0, 300.0, 400.0,
                                  500.0, 600.0, 700.0, 800.0),
    step: int = 10,
) -> Tuple[float, float, int]:
    """KITTI odometry benchmark metric: average translational error (%)
    and rotational error (deg/m) over all subsequences of the given path
    lengths, starting every `step` frames. Estimated relative motion is
    scaled by the global Sim(3) factor (monocular). Lengths longer than
    the traveled path are skipped. Returns (t_pct, r_deg_per_m, n_segments);
    (nan, nan, 0) when the route is shorter than the shortest length."""
    n = min(len(est_wc), len(gt_cw))
    s = sim3_scale(est_wc[:n], gt_cw[:n])
    est_cw = np.linalg.inv(est_wc[:n])
    est_cw[:, :3, 3] *= s
    gt = gt_cw[:n]
    gt_pos = gt[:, :3, 3]
    dist = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt_pos, axis=0), axis=-1))])
    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for L in lengths:
            target = dist[first] + L
            if dist[-1] < target:
                break
            last = int(np.searchsorted(dist, target))
            rel_gt = np.linalg.inv(gt[first]) @ gt[last]
            rel_est = np.linalg.inv(est_cw[first]) @ est_cw[last]
            err = np.linalg.inv(rel_gt) @ rel_est
            t_errs.append(np.linalg.norm(err[:3, 3]) / L * 100.0)
            c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
            r_errs.append(np.degrees(np.arccos(c)) / L)
    if not t_errs:
        return float("nan"), float("nan"), 0
    return (float(np.mean(t_errs)), float(np.mean(r_errs)), len(t_errs))
