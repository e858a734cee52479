"""Closed-form Horn alignment + fixed-trial batched Sim3/SE3 RANSAC (port of
``pslam_tpu/solver/horn.py``).

Replaces Sim3Solver (reference src/Sim3Solver.cc:37-425) and, for RGB-D
relocalization, the role of the EPnP RANSAC (src/PnPsolver.cc:165): every
hypothesis is a 3-point Horn alignment, all trials are one batch, and the
best trial wins by inlier count (first on ties).

Each RANSAC comes in two steps. ``ransac_priorities`` draws the hypotheses:
an (n_trials, N) priority table from a CPU ``torch.Generator`` seeded with an
integer, moved to the device, so every device tests the same hypotheses. The
solver takes the table as an argument; each trial samples the 3 valid
entries of highest priority (a stable descending sort, lowest index first on
ties, as ``lax.top_k`` orders them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry.camera import Camera, project


def ransac_priorities(seed: int, n_trials: int, n: int, device):
    """(n_trials, n) uniform [0, 1) priorities drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand((n_trials, n), generator=g).to(device)


def _sample3(prio, valid):
    prio = torch.where(valid[None, :], prio, -1.0)
    return torch.sort(prio, dim=1, descending=True, stable=True).indices[:, :3]


def horn_align(P, Q, fix_scale: bool = False):
    """Closed-form similarity aligning P -> Q: Q ~= s * R @ P + t.

    P, Q: (..., n, 3). Returns (s (...,), R (..., 3, 3), t (..., 3)) by
    Horn's quaternion method (Sim3Solver::ComputeSim3, Sim3Solver.cc:226-315):
    M = Pc^T Qc, the 4x4 N matrix's principal eigenvector is the rotation,
    asymmetric least-squares scale."""
    Pc_mean = P.mean(dim=-2, keepdim=True)
    Qc_mean = Q.mean(dim=-2, keepdim=True)
    Pc = P - Pc_mean
    Qc = Q - Qc_mean
    M = torch.einsum("...ni,...nj->...ij", Pc, Qc)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, vecs = torch.linalg.eigh(N)  # ascending eigenvalues
    q = vecs[..., :, -1]  # (w, x, y, z); R is even in q, so its sign is free
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    RP = torch.einsum("...ij,...nj->...ni", R, Pc)
    if fix_scale:
        s = torch.ones(P.shape[:-2], dtype=P.dtype, device=P.device)
    else:
        # Asymmetric least-squares scale (Sim3Solver.cc:286-296).
        num = torch.sum(Qc * RP, dim=(-2, -1))
        den = torch.sum(RP * RP, dim=(-2, -1))
        s = num / torch.clamp(den, min=1e-12)
    t = Qc_mean[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, Pc_mean[..., 0, :])
    return s, R, t


class Sim3RansacResult(NamedTuple):
    s12: torch.Tensor  # ()
    R12: torch.Tensor  # (3, 3)
    t12: torch.Tensor  # (3,)
    inlier: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def sim3_ransac(
    cam: Camera,
    X1,
    X2,
    uv1,
    uv2,
    inv_sigma2_1,
    inv_sigma2_2,
    valid,
    prio,
    fix_scale: bool = False,
    chi2_th: float = 9.210,
) -> Sim3RansacResult:
    """Fixed-budget 3-point RANSAC for the Sim3 (or SE3) between two matched
    camera-space landmark sets (Sim3Solver::iterate, Sim3Solver.cc:140-224),
    one trial per row of ``prio``.

    X1/X2: (N, 3) matched landmark positions in camera-1/2 frames; uv1/uv2
    their projections; inv_sigma2_*: per-match octave precision. A match is
    an inlier when X2 reprojected into image 1 through S12 and X1 into image
    2 through S21 both pass chi2_th (CheckInliers, Sim3Solver.cc:316-344)."""
    n_valid = torch.sum(valid.to(torch.int32))
    samp = _sample3(prio, valid)  # (T, 3)
    s21, R21, t21 = horn_align(X1[samp], X2[samp], fix_scale=fix_scale)  # X2 ~ S21 X1

    s12 = 1.0 / torch.clamp(s21, min=1e-12)
    R12 = R21.transpose(-1, -2)
    t12 = -s12[:, None] * torch.einsum("tij,tj->ti", R12, t21)
    X2in1 = s12[:, None, None] * torch.einsum("tij,nj->tni", R12, X2) + t12[:, None, :]
    X1in2 = s21[:, None, None] * torch.einsum("tij,nj->tni", R21, X1) + t21[:, None, :]
    e1 = uv1 - project(cam, X2in1)
    e2 = uv2 - project(cam, X1in2)
    ok = (
        valid
        & (torch.sum(e1 * e1, -1) * inv_sigma2_1 < chi2_th)
        & (torch.sum(e2 * e2, -1) * inv_sigma2_2 < chi2_th)
        & (X2in1[..., 2] > 0.05)
        & (X1in2[..., 2] > 0.05)
    )
    n_in = torch.sum(ok.to(torch.int32), dim=1)
    best = torch.argmax(n_in)
    n_best = torch.where(n_valid >= 3, n_in[best], 0)
    return Sim3RansacResult(
        s12=s12[best], R12=R12[best], t12=t12[best],
        inlier=ok[best] & (n_best > 0), n_inliers=n_best,
    )


def se3_ransac_3d3d(X_map, X_cam, valid, prio, inlier_th: float = 0.06):
    """Fixed-budget 3-point RANSAC SE3 from world-frame points to camera-frame
    points (the RGB-D relocalization hypothesis: depth gives the frame's 3D),
    one trial per row of ``prio``, then one weighted SVD refine on the best
    trial's inliers, kept when it holds at least as many.

    Returns (T_cw (4, 4), inlier (N,), n_inliers)."""
    samp = _sample3(prio, valid)
    _, R, t = horn_align(X_map[samp], X_cam[samp], fix_scale=True)

    Xc = torch.einsum("tij,nj->tni", R, X_map) + t[:, None, :]
    ok = valid & (torch.linalg.vector_norm(Xc - X_cam, dim=-1) < inlier_th)
    n_in = torch.sum(ok.to(torch.int32), dim=1)
    best = torch.argmax(n_in)

    w = ok[best].to(X_map.dtype)
    sw = torch.clamp(torch.sum(w), min=3.0)
    Pm = torch.sum(X_map * w[:, None], 0) / sw
    Qm = torch.sum(X_cam * w[:, None], 0) / sw
    Pc = (X_map - Pm) * w[:, None]
    Qc = (X_cam - Qm) * w[:, None]
    U, _, Vt = torch.linalg.svd(Pc.T @ Qc)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R_ref = Vt.T @ D @ U.T
    t_ref = Qm - R_ref @ Pm
    Xr = X_map @ R_ref.T + t_ref
    ok_ref = valid & (torch.linalg.vector_norm(Xr - X_cam, dim=-1) < inlier_th)
    n_ref = torch.sum(ok_ref.to(torch.int32))
    use_ref = n_ref >= n_in[best]
    R_out = torch.where(use_ref, R_ref, R[best])
    t_out = torch.where(use_ref, t_ref, t[best])
    ok_out = torch.where(use_ref, ok_ref, ok[best])
    T = torch.eye(4, dtype=X_map.dtype, device=X_map.device)
    T[:3, :3] = R_out
    T[:3, 3] = t_out
    n_valid = torch.sum(valid.to(torch.int32))
    n_out = torch.where(n_valid >= 3, torch.maximum(n_ref, n_in[best]), 0)
    return T, ok_out & (n_out > 0), n_out
