"""Absolute / relative trajectory error with Umeyama alignment (host-side).

Monocular VO is defined up to a global similarity, so ATE is computed after
a closed-form Sim(3) (or SE(3)) alignment of the estimated positions to the
ground truth. Runs in numpy on the host — evaluation is not a device-hot
path. Supports both full-3D trajectories and the reference datasets' 2D
(x, z) ground-truth format (reference: src/modules/dataset_loader.py:60
keeps pose columns [3, 11]).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Closed-form similarity aligning src -> dst (both (N, d)).

    Returns (scale, R (d, d), t (d,)) minimizing ||dst - (s R src + t)||^2.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    n = len(src)
    cov = xd.T @ xs / n
    U, S, Vt = np.linalg.svd(cov)
    d = src.shape[1]
    sign = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.eye(d)
    D[-1, -1] = sign
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs**2).sum() / n
        s = float(np.trace(np.diag(S) @ D) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: str = "sim3",
) -> float:
    """RMSE of aligned position error. align: 'sim3', 'se3', or 'none'."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align == "none":
        aligned = est
    else:
        s, R, t = umeyama_alignment(est, gt, with_scale=(align == "sim3"))
        aligned = s * est @ R.T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, delta: int = 1
) -> float:
    """RMSE of relative displacement error over a frame offset."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt((err**2).mean()))
