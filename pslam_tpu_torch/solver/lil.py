"""Structural-line (LIL) composite error terms (port of
``pslam_tpu/solver/lil.py``).

EdgeLILSE3ProjectXYZ (reference add_inc/EdgeLIL.h:210-439), batched. The LIL
landmark is the 15-d state [P1s, P1e, P2s, P2e, X_ins] (two 3D segments and
their intersection, world frame); an observation is the 8-vector
[l1 (3, normalized image-line eq), l2 (3), uv_ins (2)]. The 6-d residual
(EdgeLIL.h computeError, :220-256):

    r = [ l1 . h(pi(T P1s)),  l1 . h(pi(T P1e)),
          l2 . h(pi(T P2s)),  l2 . h(pi(T P2e)),
          uv_ins - pi(T X_ins) ]

with h(u, v) = (u, v, 1).

Landmark parameterization, kept from the JAX package on purpose: the update
is a rigid 3-d translation of the whole structure (all five points share one
shift), so landmark Hessian blocks are 3x3 like map points'. The reference's
VertexLIL reads a 15-d update from g2o's 3-d buffer (VertexLIL.h:23-27, an
out-of-bounds read); this is the 3-DoF semantics it declares instead.

Information I * LIL_INFO (Optimizer.cc:1970, 2320); Huber delta sqrt(11.07)
and chi2 gate 11.07 (Optimizer.cc:628).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.geometry import Camera, se3_R, so3_hat, transform_points
from pslam_tpu_torch.solver.robust import huber_weight

LIL_INFO = 0.01  # invSigma (Optimizer.cc:1970)
CHI2_LIL = 11.07  # chi2LLIL gate / Huber delta^2 (Optimizer.cc:628,706)
# sqrt in f32, as the JAX package computes it; a Python float, so a CUDA
# caller builds no device scalar (a host-to-device copy that waits) per call.
HUBER_LIL = float(np.sqrt(np.float32(CHI2_LIL)))
LIL_TRACK_WEIGHT = 5  # LIL matches count x5 in the tracking inlier gates
# (Tracking.cc:1037, 1281-1284, 1396)


class LILPoseObs(NamedTuple):
    """Fixed-capacity LIL observations for one frame's pose solve; the
    landmark ``state`` is held fixed (Optimizer.cc:650 setFixed(true))."""

    state: torch.Tensor  # (N, 15) world-frame [P1s, P1e, P2s, P2e, X_ins]
    obs: torch.Tensor  # (N, 8) [l1, l2, uv_ins]
    valid: torch.Tensor  # (N,) bool


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _proj(cam: Camera, Xc):
    z = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def _dproj(cam: Camera, Xc):
    """d(u, v)/dXc: (..., 2, 3)."""
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / _safe_z(Xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )


def lil_residual_jac(cam: Camera, T_cw, state, obs):
    """Batched LIL edge terms.

    T_cw (..., 4, 4) broadcasts against the leading dims of state (..., 15)
    and obs (..., 8). Returns (r (..., 6), J_pose (..., 6, 6), J_lm
    (..., 6, 3), min_z (...,)); ``min_z`` is the least camera-frame depth of
    the five points (isDepthPositive, EdgeLIL.h:258-262)."""
    pts_w = state.reshape(state.shape[:-1] + (5, 3))
    Xc = transform_points(T_cw[..., None, :, :], pts_w)  # (..., 5, 3)
    uv = _proj(cam, Xc)  # (..., 5, 2)
    dp = _dproj(cam, Xc)  # (..., 5, 2, 3)
    R = se3_R(T_cw)

    l1 = obs[..., 0:3]
    l2 = obs[..., 3:6]
    uv_obs = obs[..., 6:8]

    def line_row(l, k):
        # r = l . (u, v, 1); dr/dXc = l[:2] . dproj
        r = l[..., 0] * uv[..., k, 0] + l[..., 1] * uv[..., k, 1] + l[..., 2]
        g = l[..., 0, None] * dp[..., k, 0, :] + l[..., 1, None] * dp[..., k, 1, :]
        return r, g

    r0, g0 = line_row(l1, 0)
    r1, g1 = line_row(l1, 1)
    r2, g2 = line_row(l2, 2)
    r3, g3 = line_row(l2, 3)
    r_ins = uv_obs - uv[..., 4, :]
    r = torch.cat([r0[..., None], r1[..., None], r2[..., None], r3[..., None], r_ins],
                  dim=-1)

    # dXc/dxi = [-[Xc]x | I]; dXc/dshift = R.
    hats = so3_hat(Xc)  # (..., 5, 3, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(hats.shape)
    dXc_dxi = torch.cat([-hats, eye], dim=-1)  # (..., 5, 3, 6)
    Rb = R[..., None, :, :].expand(hats.shape)

    def row(g, M, k):  # g (..., 3) @ M[k] (..., 3, n) -> (..., n)
        return torch.einsum("...i,...ij->...j", g, M[..., k, :, :])

    gs = (g0, g1, g2, g3)
    J_pose = torch.stack([row(g, dXc_dxi, k) for k, g in enumerate(gs)], dim=-2)
    J_lm = torch.stack([row(g, Rb, k) for k, g in enumerate(gs)], dim=-2)
    # Intersection rows: residual = obs - proj => J = -dproj @ dXc/d*.
    J_ins_pose = -torch.einsum("...ij,...jk->...ik", dp[..., 4, :, :], dXc_dxi[..., 4, :, :])
    J_ins_lm = -torch.einsum("...ij,...jk->...ik", dp[..., 4, :, :], Rb[..., 4, :, :])

    J_pose = torch.cat([J_pose, J_ins_pose], dim=-2)  # (..., 6, 6)
    J_lm = torch.cat([J_lm, J_ins_lm], dim=-2)  # (..., 6, 3)
    min_z = torch.min(Xc[..., 2], dim=-1).values
    return r, J_pose, J_lm, min_z


def lil_chi2(r):
    """chi2 = r^T (I * LIL_INFO) r."""
    return torch.sum(r * r, dim=-1) * LIL_INFO


def lil_weights(r, active, use_huber: bool):
    """Robust weighting of LIL edges (..., 6) residuals. Returns (chi2,
    w_eff = Huber weight * LIL_INFO on active edges, cost)."""
    chi2 = lil_chi2(r)
    if use_huber:
        w_rob = huber_weight(chi2, HUBER_LIL)
    else:
        w_rob = torch.ones_like(chi2)
    a = active.to(r.dtype)
    return chi2, w_rob * LIL_INFO * a, torch.sum(chi2 * w_rob * a)
