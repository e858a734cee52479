"""Epipolar matching + two-view triangulation of new map points (port of
``pslam_tpu/ops/triangulate.py``).

LocalMapping::CreateNewMapPoints (reference src/LocalMapping.cc:275-520) and
ORBmatcher::SearchForTriangulation (src/ORBmatcher.cc:657): the keyframe
pair match is one masked Hamming distance matrix with an epipolar-band mask;
triangulation and the chi^2 / scale-consistency gates run batched over all
matched pairs. The JAX package's one-hot matmul gather of the neighbour's
rows becomes plain indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)


class KFView(NamedTuple):
    """One keyframe's features as seen by the triangulator."""

    T_cw: torch.Tensor  # (4, 4)
    uv: torch.Tensor  # (N, 2)
    ur: torch.Tensor  # (N,) virtual right u, -1 = no depth
    depth: torch.Tensor  # (N,) RGB-D depth, 0 = hole
    level: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N, 32) uint8
    free: torch.Tensor  # (N,) bool: valid AND not yet bound to a map point


def _cam_center(T_cw):
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def _fundamental(cam: Camera, T1, T2):
    """F mapping a point in image 1 to its epipolar line in image 2:
    l2 = F x1 (reference ComputeF12, LocalMapping.cc:893-915)."""
    T21 = T2 @ torch.linalg.inv_ex(T1)[0]  # cam1 -> cam2
    R = T21[:3, :3]
    t = T21[:3, 3]
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])
    Kinv = torch.linalg.inv_ex(cam.K(t.device))[0]
    return Kinv.T @ (tx @ R) @ Kinv


def _rays_world(cam: Camera, T_cw, uv):
    """Unit-norm world-frame view rays through pixels uv."""
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    d_c = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_w = d_c @ T_cw[:3, :3]  # R^T d
    return d_w / torch.linalg.vector_norm(d_w, dim=-1, keepdim=True)


def _unproject_view(cam: Camera, T_cw, uv, depth):
    """Backproject pixels with depth to world frame."""
    x = (uv[:, 0] - cam.cx) / cam.fx * depth
    y = (uv[:, 1] - cam.cy) / cam.fy * depth
    Xc = torch.stack([x, y, depth], dim=-1)
    return (Xc - T_cw[:3, 3]) @ T_cw[:3, :3]


def _reproj_ok(cam: Camera, T_cw, X_w, uv, ur, level, sigma2, chi_mono, chi_stereo):
    """Positive depth + chi^2 reprojection gate in one view
    (LocalMapping.cc:424-470)."""
    Xc = (X_w @ T_cw[:3, :3].T) + T_cw[:3, 3]
    z = Xc[:, 2]
    z_safe = torch.clamp(z, min=1e-9)
    u = cam.fx * Xc[:, 0] / z_safe + cam.cx
    v = cam.fy * Xc[:, 1] / z_safe + cam.cy
    urr = u - cam.bf / z_safe
    s2 = sigma2[torch.clamp(level.to(torch.int64), 0, sigma2.shape[0] - 1)]
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    mono_ok = e2 < chi_mono * s2
    stereo_ok = (e2 + (urr - ur) ** 2) < chi_stereo * s2
    ok = torch.where(ur >= 0, stereo_ok, mono_ok)
    return (z > 0) & ok, z


def epipolar_triangulate(
    cam: Camera, kf1: KFView, kf2: KFView, scale: float = 1.2, levels: int = 8
):
    """Match free features of kf1 against kf2 along the epipolar band and
    triangulate (or unproject from either view's depth when parallax is too
    low — the RGB-D branch of LocalMapping.cc:391-422).

    Returns per feature of kf1: (idx2 (N,) int64 match or -1, X_w (N, 3),
    ok (N,) bool all gates passed)."""
    dev = kf1.uv.device
    sigma2 = torch.tensor([(scale**l) ** 2 for l in range(levels)],
                          dtype=torch.float32, device=dev)
    sfac2 = torch.tensor([scale**l for l in range(levels)],
                         dtype=torch.float32, device=dev)
    lvl1 = torch.clamp(kf1.level.to(torch.int64), 0, levels - 1)
    lvl2 = torch.clamp(kf2.level.to(torch.int64), 0, levels - 1)

    dist = hamming_matrix(kf1.desc, kf2.desc)

    # Epipolar band: distance of the kf2 feature to the epipolar line of the
    # kf1 feature < 3.84 sigma2(level2) (CheckDistEpipolarLine, ORBmatcher.cc:612).
    F = _fundamental(cam, kf1.T_cw, kf2.T_cw)
    x1 = torch.cat([kf1.uv, torch.ones_like(kf1.uv[:, :1])], dim=1)
    l2 = x1 @ F.T  # (N1, 3)
    num = (l2[:, None, 0] * kf2.uv[None, :, 0] + l2[:, None, 1] * kf2.uv[None, :, 1]
           + l2[:, None, 2])
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2
    d2 = num**2 / torch.clamp(den[:, None], min=1e-12)
    epi_ok = d2 < 3.84 * sigma2[lvl2][None, :]

    # Keep kf2 features away from the epipole (ORBmatcher.cc:700-707).
    C1_in_2 = _cam_center(kf1.T_cw) @ kf2.T_cw[:3, :3].T + kf2.T_cw[:3, 3]
    zc = torch.clamp(C1_in_2[2], min=1e-9)
    ex = cam.fx * C1_in_2[0] / zc + cam.cx
    ey = cam.fy * C1_in_2[1] / zc + cam.cy
    de2 = (kf2.uv[:, 0] - ex) ** 2 + (kf2.uv[:, 1] - ey) ** 2
    far_from_epipole = de2 > 100.0 * sfac2[lvl2]
    epi_ok = epi_ok & (far_from_epipole | (kf2.ur >= 0))[None, :]

    idx2, _ = mutual_nn_match(
        dist, valid_a=kf1.free, valid_b=kf2.free, max_dist=TH_LOW, ratio=1.0,
        extra_mask=epi_ok,
    )
    j0 = torch.clamp(idx2, min=0)
    g_angle, g_depth = kf2.angle[j0], kf2.depth[j0]
    g_uv, g_ur = kf2.uv[j0], kf2.ur[j0]
    g_level = kf2.level[j0]
    r2 = _rays_world(cam, kf2.T_cw, kf2.uv)[j0]
    X_d2 = _unproject_view(cam, kf2.T_cw, kf2.uv, kf2.depth)[j0]

    keep = rotation_consistency_mask(kf1.angle, g_angle, idx2 >= 0)
    idx2 = torch.where(keep, idx2, -1)

    # --- triangulation (LocalMapping.cc:352-422) ---------------------------
    C1 = _cam_center(kf1.T_cw)
    C2 = _cam_center(kf2.T_cw)
    r1 = _rays_world(cam, kf1.T_cw, kf1.uv)
    cos_par = torch.sum(r1 * r2, dim=-1)

    # Stereo parallax from depth: cos(2 atan2(b/2, z)) (LocalMapping.cc:372).
    half_b = torch.tensor(cam.baseline / 2.0, dtype=torch.float32, device=dev)

    def stereo_cos(depth):
        return torch.where(
            depth > 0,
            torch.cos(2.0 * torch.atan2(half_b, torch.clamp(depth, min=1e-9))),
            torch.full_like(depth, 2.0),
        )

    cp_stereo = torch.minimum(stereo_cos(kf1.depth), stereo_cos(g_depth))

    # Two-ray midpoint least squares: min ||C1 + a r1 - C2 - b r2||.
    w = C2 - C1
    rr = cos_par
    a_num = torch.sum(w * r1, dim=-1) - rr * torch.sum(w * r2, dim=-1)
    b_num = rr * torch.sum(w * r1, dim=-1) - torch.sum(w * r2, dim=-1)
    det = torch.clamp(1.0 - rr * rr, min=1e-9)
    aa = a_num / det
    bb = b_num / det
    X_tri = 0.5 * (C1 + aa[:, None] * r1 + C2 + bb[:, None] * r2)

    X_d1 = _unproject_view(cam, kf1.T_cw, kf1.uv, kf1.depth)

    good_par = (cos_par > 0) & (cos_par < 0.9998) & (cos_par < cp_stereo)
    use_d1 = (~good_par) & (kf1.depth > 0)
    use_d2 = (~good_par) & (~use_d1) & (g_depth > 0)
    X_w = torch.where(
        good_par[:, None], X_tri, torch.where(use_d1[:, None], X_d1, X_d2)
    )
    has_X = good_par | use_d1 | use_d2

    # --- acceptance gates ---------------------------------------------------
    ok1, _ = _reproj_ok(cam, kf1.T_cw, X_w, kf1.uv, kf1.ur, kf1.level, sigma2, 5.991, 7.8)
    ok2, _ = _reproj_ok(cam, kf2.T_cw, X_w, g_uv, g_ur, g_level, sigma2, 5.991, 7.8)

    # Scale consistency (LocalMapping.cc:488-501).
    d1 = torch.linalg.vector_norm(X_w - C1, dim=-1)
    d2n = torch.linalg.vector_norm(X_w - C2, dim=-1)
    ratio_dist = d2n / torch.clamp(d1, min=1e-9)
    ratio_oct = sfac2[lvl1] / sfac2[torch.clamp(g_level.to(torch.int64), 0, levels - 1)]
    ratio_factor = 1.5 * scale
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & (
        ratio_dist < ratio_oct * ratio_factor
    )

    ok = (idx2 >= 0) & has_X & ok1 & ok2 & scale_ok & (d1 > 1e-6) & (d2n > 1e-6)
    return torch.where(ok, idx2, -1), X_w, ok
