"""Fan detection + structural-line (LIL) hypothesis construction (port of
``pslam_tpu/ops/fans.py``).

Replaces CPartiallyRecoverConnectivity (reference
add_src/PartiallyRecoverConnectivity.cpp:14-133) and the structural-line
construction inside Frame::ExtractLSD (src/Frame.cc:489-646) with masked pairwise
matrix ops, as the JAX package does: fan candidates over ordered line pairs
(search rect, angle gap >= pi/4, intersection inside the rect and the image),
unordered dedup, 3D crosspoint by closest approach, coplanarity + plane
hypothesis, OldPlane dedup against earlier candidates, and a fixed-capacity
selection.

Both selections are stable descending sorts: among equal summed lengths
``lax.top_k`` keeps the lower flat index first, and the OldPlane dedup keeps
the earlier candidate, so the order decides which LILs survive.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pslam_tpu_torch.ops.orb import topk_stable

EXPAND_WIDTH = 20.0  # Frame.h:217
FAN_THR = math.pi / 4  # Frame.h:218
COPLANAR_TOL = 0.05  # Frame.cc:619
OLDPLANE_D = 0.2  # Frame.cc:480
OLDPLANE_COS = 0.9397  # Frame.cc:482
BORDER = 4.0


class LILFeatures(NamedTuple):
    """Fixed-capacity per-frame structural-line hypotheses (camera frame)."""

    line_idx: torch.Tensor  # (Q, 2) int32 indices (l1, l2) into LineFeatures
    cross2d: torch.Tensor  # (Q, 2) 2D intersection (CrossPoint_2D)
    cross3d: torch.Tensor  # (Q, 3) 3D crosspoint (CrossPoint_3D, cam frame)
    plane: torch.Tensor  # (Q, 4) plane (n, d), |n| = 1, d >= 0 (mvPlanes)
    eq1: torch.Tensor  # (Q, 3) normalized image-line eq of line 1 (mvle_l)
    eq2: torch.Tensor  # (Q, 3)
    p1s: torch.Tensor  # (Q, 3) 3D endpoints of line 1 (cam frame)
    p1e: torch.Tensor  # (Q, 3)
    p2s: torch.Tensor  # (Q, 3) 3D endpoints of line 2
    p2e: torch.Tensor  # (Q, 3)
    valid: torch.Tensor  # (Q,) bool


def _in_rect(pt, mid, ang, half_w, half_h):
    """Point-in-rotated-rect (isPtInRotatedRect semantics), broadcasting."""
    ca, sa = torch.cos(ang), torch.sin(ang)
    dx = pt[..., 0] - mid[..., 0]
    dy = pt[..., 1] - mid[..., 1]
    fx = ca * dx + sa * dy
    fy = sa * dx - ca * dy
    return (fx >= -half_w) & (fx < half_w) & (fy >= -half_h) & (fy < half_h)


def _line_intersection(sp_i, ep_i, sp_j, ep_j):
    """Infinite-line intersections, broadcasting to (L, L, 2). Returns
    (pt, ok)."""
    a1 = sp_i[..., 1] - ep_i[..., 1]
    b1 = ep_i[..., 0] - sp_i[..., 0]
    c1 = ep_i[..., 1] * sp_i[..., 0] - sp_i[..., 1] * ep_i[..., 0]
    a2 = sp_j[..., 1] - ep_j[..., 1]
    b2 = ep_j[..., 0] - sp_j[..., 0]
    c2 = ep_j[..., 1] * sp_j[..., 0] - sp_j[..., 1] * ep_j[..., 0]
    det = a1 * b2 - a2 * b1
    ok = torch.abs(det) > 1e-9
    det_safe = torch.where(ok, det, torch.ones_like(det))
    x = (-c1 * b2 + c2 * b1) / det_safe
    y = (a1 * -c2 + a2 * c1) / det_safe
    return torch.stack([x, y], dim=-1), ok


def _closest_point_of_approach(p1, d1, p2, d2):
    """Midpoint of the shortest segment between two 3D lines p + t d
    (Frame_shortestDistance's 2x2 solve, Frame.cc:380-424). Returns
    (crosspoint (..., 3), ok (...,))."""
    d11 = torch.sum(d1 * d1, dim=-1)
    d12 = torch.sum(d1 * d2, dim=-1)
    d22 = torch.sum(d2 * d2, dim=-1)
    p21 = p1 - p2
    r1 = torch.sum(p21 * d1, dim=-1)
    r2 = torch.sum(p21 * d2, dim=-1)
    det = d11 * (-d22) + d12 * d12
    ok = torch.abs(det) > 1e-12
    det_safe = torch.where(ok, det, torch.ones_like(det))
    t1 = (-r1 * (-d22) - (-d12) * (-r2)) / det_safe
    t2 = (d11 * (-r2) - d12 * (-r1)) / det_safe
    root1 = p1 + t1[..., None] * d1
    root2 = p2 + t2[..., None] * d2
    return 0.5 * (root1 + root2), ok


def build_lils(
    sp, ep, eq2d, line_valid,
    p3s, p3e, dir3d, ok3d,
    n_lil: int = 64,
    width: int = 640,
    height: int = 480,
) -> LILFeatures:
    """Detect fans over a line set and build coplanar LIL hypotheses. 2D
    inputs from ``lines.detect_lines``, 3D from ``line3d.fit_lines_3d``."""
    L = sp.shape[0]
    dev = sp.device
    d2 = ep - sp
    length = torch.linalg.vector_norm(d2, dim=-1)
    ang = torch.atan2(d2[..., 1], d2[..., 0])
    mid = 0.5 * (sp + ep)

    # --- fan candidate mask (L_i, L_j) ---------------------------------
    r = EXPAND_WIDTH
    half_w = (length + 2.0 * r) / 2.0
    half_h = torch.full_like(length, r)

    def rect_i(pt):  # (L, 2) -> (L_i, L_j) membership in rect of i
        return _in_rect(pt[None, :, :], mid[:, None, :], ang[:, None],
                        half_w[:, None], half_h[:, None])

    endpoint_in = rect_i(sp) | rect_i(ep)

    dang = torch.remainder(torch.abs(ang[:, None] - ang[None, :]), math.pi)
    angle_ok = (dang >= FAN_THR) & (math.pi - dang >= FAN_THR)

    ipt, int_ok = _line_intersection(
        sp[:, None, :], ep[:, None, :], sp[None, :, :], ep[None, :, :]
    )
    in_rect = _in_rect(ipt, mid[:, None, :], ang[:, None], half_w[:, None],
                       half_h[:, None])
    in_img = (
        (ipt[..., 0] >= BORDER)
        & (ipt[..., 0] < width - BORDER)
        & (ipt[..., 1] >= BORDER)
        & (ipt[..., 1] < height - BORDER)
    )
    ar = torch.arange(L, device=dev)
    fan = (
        endpoint_in & angle_ok & int_ok & in_rect & in_img
        & (ar[:, None] != ar[None, :])
        & line_valid[:, None] & line_valid[None, :]
    )
    # Unordered dedup, first row-major occurrence: (i, j) with i < j wins
    # unless only (j, i) is a fan.
    upper = ar[:, None] < ar[None, :]
    fan = fan & (upper | ~fan.T)

    # --- select top candidates by combined 2D length --------------------
    score = torch.where(fan, length[:, None] + length[None, :],
                        torch.full_like(fan, -1.0, dtype=length.dtype))
    flat = score.reshape(-1)
    k = min(4 * n_lil, flat.shape[0])
    top_v, top_idx = topk_stable(flat, k)
    li = torch.div(top_idx, L, rounding_mode="floor")
    lj = top_idx % L
    cand_ok = top_v > 0.0

    # --- 3D crosspoint ---------------------------------------------------
    P1s, P1e = p3s[li], p3e[li]
    P2s, P2e = p3s[lj], p3e[lj]
    cross3d, cpa_ok = _closest_point_of_approach(P1s, P1e - P1s, P2s, P2e - P2s)
    # Reference gate: 2*|mid1-mid2| < |line1_6d| + |line2_6d|
    # (Frame_shortestDistance, Frame.cc:412-424).
    m1 = 0.5 * (P1s + P1e)
    m2 = 0.5 * (P2s + P2e)
    n6_1 = torch.sqrt(torch.sum(P1s * P1s, -1) + torch.sum(P1e * P1e, -1))
    n6_2 = torch.sqrt(torch.sum(P2s * P2s, -1) + torch.sum(P2e * P2e, -1))
    near_ok = 2.0 * torch.linalg.vector_norm(m1 - m2, dim=-1) < (n6_1 + n6_2)
    cand_ok = (
        cand_ok & cpa_ok & near_ok & ok3d[li] & ok3d[lj]
        & (torch.linalg.vector_norm(cross3d, dim=-1) > 1e-9)
    )

    # --- coplanarity + plane hypothesis ---------------------------------
    n = torch.linalg.cross(dir3d[li], dir3d[lj], dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    ds = torch.stack(
        [
            torch.sum(n * P1s, -1), torch.sum(n * P1e, -1),
            torch.sum(n * P2s, -1), torch.sum(n * P2e, -1),
            torch.sum(n * cross3d, -1),
        ],
        dim=-1,
    )  # (k, 5)
    dspread = torch.max(ds, -1).values - torch.min(ds, -1).values
    plane_d = -torch.mean(ds, dim=-1)
    flip = plane_d < 0.0
    n = torch.where(flip[:, None], -n, n)
    plane_d = torch.where(flip, -plane_d, plane_d)
    plane = torch.cat([n, plane_d[:, None]], dim=-1)
    cand_ok = cand_ok & (dspread <= COPLANAR_TOL)

    # --- OldPlane dedup: drop candidates similar to an earlier one -------
    cos = torch.abs(n @ n.T)
    dd = torch.abs(plane_d[:, None] - plane_d[None, :])
    similar = (cos >= OLDPLANE_COS) & (dd <= OLDPLANE_D)
    ak = torch.arange(k, device=dev)
    earlier = ak[None, :] < ak[:, None]  # candidates are in score order
    dup = torch.any(similar & earlier & cand_ok[None, :], dim=1)
    cand_ok = cand_ok & ~dup

    # --- final fixed-capacity selection ----------------------------------
    fsc = torch.where(cand_ok, top_v, torch.full_like(top_v, -1.0))
    sel_v, sel = topk_stable(fsc, min(n_lil, k))
    li_s, lj_s = li[sel], lj[sel]
    return LILFeatures(
        line_idx=torch.stack([li_s, lj_s], dim=-1).to(torch.int32),
        cross2d=ipt[li_s, lj_s],
        cross3d=cross3d[sel],
        plane=plane[sel],
        eq1=eq2d[li_s],
        eq2=eq2d[lj_s],
        p1s=P1s[sel],
        p1e=P1e[sel],
        p2s=P2s[sel],
        p2e=P2e[sel],
        valid=sel_v > 0.0,
    )
