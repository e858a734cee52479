"""RGB-D stereo point reprojection residuals and analytic Jacobians (port of
``pslam_tpu/solver/reproj.py``).

Semantics follow g2o's EdgeStereoSE3ProjectXYZ as used by the reference's
Optimizer (Optimizer.cc:282-362): residual = observation - projection, pose
update is left-multiplicative exp(xi) @ T_cw with tangent [omega, upsilon];
d(exp(xi) Xc)/dxi |_0 = [-[Xc]x, I].
"""

from __future__ import annotations

import torch

from pslam_tpu_torch.geometry import Camera, se3_R, transform_points
from pslam_tpu_torch.geometry.lie import so3_hat


def _proj_derivs(cam: Camera, Xc):
    """d(u,v)/dXc for pinhole projection. Xc: (..., 3) -> (..., 2, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def mono_residual_jac(cam: Camera, T_cw, X_w, obs_uv):
    """Batched mono edge: returns (r (..., 2), J_pose (..., 2, 6),
    J_point (..., 2, 3)).

    r = obs - proj(T X); J_* = dr/d(xi, X_w)."""
    Xc = transform_points(T_cw, X_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * x / z_safe + cam.cx
    v = cam.fy * y / z_safe + cam.cy
    r = obs_uv - torch.stack([u, v], dim=-1)

    dproj = _proj_derivs(cam, Xc)  # (..., 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    dXc_dxi = torch.cat([-so3_hat(Xc), eye], dim=-1)  # (..., 3, 6)
    J_pose = -(dproj @ dXc_dxi)
    R = se3_R(T_cw).expand(Xc.shape[:-1] + (3, 3))
    J_point = -(dproj @ R)
    return r, J_pose, J_point


def stereo_residual_jac(cam: Camera, T_cw, X_w, obs_uvr):
    """Batched RGB-D stereo edge: r (..., 3) = obs[u, v, ur] - proj_stereo(T X).

    Returns (r, J_pose (..., 3, 6), J_point (..., 3, 3))."""
    Xc = transform_points(T_cw, X_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = obs_uvr - torch.stack([u, v, ur], dim=-1)

    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_r = torch.stack(
        [cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], dim=-1
    )
    dproj = torch.stack([row_u, row_v, row_r], dim=-2)  # (..., 3, 3)

    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    dXc_dxi = torch.cat([-so3_hat(Xc), eye], dim=-1)  # (..., 3, 6)
    J_pose = -(dproj @ dXc_dxi)
    R = se3_R(T_cw).expand(Xc.shape[:-1] + (3, 3))
    J_point = -(dproj @ R)
    return r, J_pose, J_point
