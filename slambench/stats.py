"""The benchmark's arithmetic, frozen here so that no later change to the
program can move the yardstick.

- ATE: a copy of ``pslam_tpu_torch/utils/metrics.py`` (``align_se3``,
  ``ate_rmse``, ``trajectory_positions``).
- The translational relative pose error between consecutive poses.
- The 90th percentile and the rate over all frames of a window.
- The H100's published peaks and the K1 / K2 operation and byte counts: a
  copy of ``chip_smoke.py``'s (``PEAK_BYTES_S``, ``PEAK_F32_S``,
  ``K1_PAIR_OPS``, ``K1_CAND_OPS``, ``K2_EDGE_OPS``, ``_bound`` and the byte
  counts of phases 2 and 3).
"""

from __future__ import annotations

import statistics

import numpy as np

# One H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores (the port keeps TF32 off).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# K1 (csrc/fused_match.cu): the window and validity test of every pair (2
# subtractions, 2 absolutes, 2 radius and 2 octave comparisons, 1 flag test)
# and the distance of every pair that passes it (8 XOR, 8 popcounts, 8
# adds). Integer operations are counted at the f32 rate, which no integer
# unit exceeds.
K1_PAIR_OPS = 9
K1_CAND_OPS = 24
# K2 per edge (csrc/fused_pose.cu): transform 18, projection, residuals and
# chi2 29, robust weight 6, Jacobian factors 10, Jacobians 26, H 21 x 7, b
# 6 x 7, cost 2.
K2_EDGE_OPS = 280


def floor_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM bandwidth and the operations over the f32 rate."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def k1_bytes(na: int, nb: int) -> int:
    """K1 reads 32 descriptor bytes and 8 f32 parameters a point and a
    feature, and writes 3 int32 a row and 2 a column."""
    return (32 + 8 * 4 + 3 * 4) * na + (32 + 8 * 4 + 2 * 4) * nb


def k1_ops(na: int, nb: int, n_cand: int) -> int:
    return K1_PAIR_OPS * na * nb + K1_CAND_OPS * n_cand


def k2_bytes(e: int) -> int:
    """K2 reads 8 f32 a edge and the 128-float parameter row, and writes
    chi2 a edge, H, b and the cost."""
    return (8 * 4 + 4) * e + 128 * 4 + (36 + 6 + 1) * 4


def k2_ops(e: int) -> int:
    return K2_EDGE_OPS * e


def align_se3(est_t, gt_t, with_scale: bool = False):
    """Closed-form (Umeyama/Horn) alignment est -> gt over (N, 3) positions.
    Returns (s, R, t) minimizing || gt - (s R est + t) ||."""
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
    """Absolute trajectory error RMSE (metres) after alignment."""
    s, R, t = align_se3(est_positions, gt_positions, with_scale)
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def trajectory_positions(poses_w2c):
    """(N, 4, 4) world-to-camera poses -> (N, 3) camera centres."""
    poses = np.asarray(poses_w2c, np.float64)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)


def rpe_mm(est_w2c, gt_w2c) -> np.ndarray:
    """(N-1,) translational relative pose error (mm) between consecutive
    frames: how far each frame-to-frame motion is from the true one."""
    P = np.linalg.inv(np.asarray(est_w2c, np.float64))
    Q = np.linalg.inv(np.asarray(gt_w2c, np.float64))
    dP = np.linalg.inv(P[:-1]) @ P[1:]
    dQ = np.linalg.inv(Q[:-1]) @ Q[1:]
    E = np.linalg.inv(dQ) @ dP
    return np.linalg.norm(E[:, :3, 3], axis=1) * 1e3


def p90(values) -> float:
    """The 90th percentile of every value (inclusive quantiles: the value
    where 10% of the samples lie above)."""
    v = [float(x) for x in values]
    if len(v) == 1:
        return v[0]
    return statistics.quantiles(v, n=10, method="inclusive")[8]


def rate(count: int, seconds: float) -> float:
    """Work completed over the whole window's seconds."""
    return count / seconds
