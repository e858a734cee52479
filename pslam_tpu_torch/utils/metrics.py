"""Trajectory metrics: ATE RMSE with SE3 (Horn) alignment.

Replicates the external TUM benchmark evaluation the reference delegates to
(`evaluate_ate.py`, README.md:14): associate poses, align by closed-form
SE3/Sim3, report translational RMSE.
"""

from __future__ import annotations

import numpy as np


def align_se3(est_t, gt_t, with_scale: bool = False):
    """Closed-form (Umeyama/Horn) alignment est -> gt over (N, 3) positions.

    Returns (s, R, t) minimizing || gt - (s R est + t) ||.
    """
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    W = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions, gt_positions, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE (meters) after alignment."""
    s, R, t = align_se3(est_positions, gt_positions, with_scale)
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def trajectory_positions(poses_w2c):
    """(N, 4, 4) world->cam poses -> (N, 3) camera centers."""
    poses = np.asarray(poses_w2c)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)
