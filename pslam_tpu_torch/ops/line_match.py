"""Line matching as masked distance matrices (port of
``pslam_tpu/ops/line_match.py``).

Replaces LSDmatcher (reference add_src/LSDmatcher.cpp) the way ops/match.py
replaces ORBmatcher: every search mode is a mask over one (Na, Nb) descriptor
distance matrix.

- ``match_lines_f2f``: SearchByGeomNApearance (LSDmatcher.cpp:36-110).
- ``match_lines_projection``: SearchByProjection for map lines
  (LSDmatcher.cpp:112-258).

Distances are float squared L2 (see ops/lbd.py). The row top-2 is a stable
sort, so equal distances keep the ``lax.top_k`` order (lowest index first):
``best < ratio * second`` with ratio 1.0 turns on exactly those ties.
"""

from __future__ import annotations

import torch

from pslam_tpu_torch.ops.lbd import line_dist_matrix
from pslam_tpu_torch.ops.orb import topk_stable

DESC_TH = 0.8  # squared-L2 gate (unit descriptors)
DESC_TH_LOOSE = 1.2
COS_F2F = 0.9397  # cos(20 deg), SearchByGeomNApearance th_angle
COS_PROJ = 0.9848  # cos(10 deg), SearchByProjection th_angle
LEN_RATIO = 0.75  # min/max line-length ratio (LSDmatcher.cpp:196-200)


def _dir_cos_matrix(dir_a, dir_b):
    """|cos| of the angle between line directions, (Na, Nb)."""
    return torch.abs(dir_a @ dir_b.T)


def _directions(sp, ep):
    d = ep - sp
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)


def mutual_nn_float(dist, valid_a, valid_b, max_dist, ratio, extra_mask=None):
    """Float-matrix analogue of ops.match.mutual_nn_match. Returns (idx (Na,)
    int64 into b or -1, best distance (Na,))."""
    big = torch.full_like(dist, 1e9)
    d = torch.where(valid_a[:, None] & valid_b[None, :], dist, big)
    if extra_mask is not None:
        d = torch.where(extra_mask, d, big)
    top2_v, top2_i = topk_stable(-d, 2)
    best = -top2_v[:, 0]
    second = -top2_v[:, 1]
    best_j = top2_i[:, 0]
    col_best = torch.argmin(d, dim=0)  # first index on ties, as jnp
    mutual = col_best[best_j] == torch.arange(d.shape[0], device=d.device)
    ok = (best <= max_dist) & (best < ratio * second) & mutual
    return torch.where(ok, best_j, -1), best


def match_lines_f2f(
    desc_a, sp_a, ep_a, valid_a,
    desc_b, sp_b, ep_b, valid_b,
    width: float, height: float,
    max_dist: float = DESC_TH,
    ratio: float = 0.85,
):
    """Frame-to-frame line matching (SearchByGeomNApearance semantics).
    Returns (idx (Na,) into b or -1, dist (Na,))."""
    dist = line_dist_matrix(desc_a, desc_b)
    cos = _dir_cos_matrix(_directions(sp_a, ep_a), _directions(sp_b, ep_b))
    dW, dH = 0.1 * width, 0.1 * height

    def close(pa, pb):  # either endpoint within (dW, dH)
        return (torch.abs(pa[:, None, 0] - pb[None, :, 0]) <= dW) & (
            torch.abs(pa[:, None, 1] - pb[None, :, 1]) <= dH
        )

    mask = (cos >= COS_F2F) & (close(sp_a, sp_b) | close(ep_a, ep_b))
    return mutual_nn_float(dist, valid_a, valid_b, max_dist, ratio, mask)


def point_to_segment_dist(p, sp, ep):
    """Distance from points (..., 2) to segments (..., 2)/(..., 2)."""
    d = ep - sp
    len2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
    t = torch.clamp(torch.sum((p - sp) * d, dim=-1) / len2, 0.0, 1.0)
    proj = sp + t[..., None] * d
    return torch.linalg.vector_norm(p - proj, dim=-1)


def match_lines_projection(
    proj_sp, proj_ep, dir_w, desc_m, valid_m,
    sp_f, ep_f, desc_f, valid_f,
    radius: float,
    max_dist: float = DESC_TH_LOOSE,
):
    """Match projected map lines (M, 2)/(M, 2) to frame lines. Gates: both
    projected endpoints within ``radius`` of the frame segment, direction
    cos >= cos(10 deg), length ratio >= 0.75, descriptor distance. ``dir_w``
    is unused, as in the JAX package. Returns (idx (M,) or -1, dist (M,))."""
    dist = line_dist_matrix(desc_m, desc_f)
    d_sp = point_to_segment_dist(proj_sp[:, None, :], sp_f[None, :, :], ep_f[None, :, :])
    d_ep = point_to_segment_dist(proj_ep[:, None, :], sp_f[None, :, :], ep_f[None, :, :])
    near = (d_sp <= radius) & (d_ep <= radius)

    cos = _dir_cos_matrix(_directions(proj_sp, proj_ep), _directions(sp_f, ep_f))
    len_m = torch.linalg.vector_norm(proj_ep - proj_sp, dim=-1)
    len_f = torch.linalg.vector_norm(ep_f - sp_f, dim=-1)
    lo = torch.minimum(len_m[:, None], len_f[None, :])
    hi = torch.maximum(len_m[:, None], len_f[None, :])
    mask = near & (cos >= COS_PROJ) & (lo >= LEN_RATIO * hi)
    return mutual_nn_float(dist, valid_m, valid_f, max_dist, 1.0, mask)
