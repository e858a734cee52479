"""Per-frame tracking against a device-resident snapshot (port of
``pslam_tpu/pipeline/frame_step.py``, points-only branch).

- ``LocalSnapshot``: the tracker's view of the map, uploaded once per
  keyframe event (between keyframes the map is immutable, so the snapshot is
  exact). ``lines`` and ``lils`` are None in this slice.
- ``frame_step``: feature extraction + motion-window tracking + local-map
  tracking + per-point found/visible accumulation. The host reads a
  24-float summary per frame; full frame arrays are read only on keyframe
  insertion. ``track_frame`` is the same step on an already-built
  ``FrameData``.

Behavioral anchor: Tracking::Track (reference src/Tracking.cc:274-552).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.pipeline.frame_ops import FrameData, make_frame
from pslam_tpu_torch.pipeline.track_ops import (
    PointSet,
    track_against_points,
    track_local_map_step,
)


class LocalSnapshot(NamedTuple):
    pts: PointSet  # (M,)
    lines: None
    lils: None


class Acc(NamedTuple):
    """Device-resident found/visible accumulators, folded into the host map
    at every snapshot rebuild (MapPoint::IncreaseVisible/Found). The line and
    LIL counters keep the JAX layout and stay zero in this slice."""

    pt_vis: torch.Tensor  # (M,) int32
    pt_found: torch.Tensor  # (M,) int32
    ml_vis: torch.Tensor  # (L,) int32
    ml_found: torch.Tensor  # (L,) int32
    il_obs: torch.Tensor  # (Q,) int32


class StepOut(NamedTuple):
    T_cw: torch.Tensor  # (4, 4) device pose
    vel: torch.Tensor  # (4, 4) device velocity T_cw @ inv(T_prev)
    summary: torch.Tensor  # (24,) f32, see the S_* indices below
    match_point: torch.Tensor  # (M,) feature idx per local point, -1 none
    inlier: torch.Tensor  # (M,) bool
    fd: FrameData
    acc: Acc


# summary vector layout (as in the JAX package)
S_T = slice(0, 16)  # row-major 4x4 T_cw
S_INLIERS = 16  # final point inliers (accept gate, Tracking.cc:1400-1406)
S_MATCHES = 17  # matches fed to the final solve
S_WEIGHTED = 18  # points + 5*LIL inliers (points only here)
S_TRACKED_CLOSE = 19  # close tracked features (NeedNewKeyFrame)
S_UNTRACKED_CLOSE = 20  # close untracked features
S_LINE_MATCHES = 21  # 0 in this slice
S_LIL_ASSOC = 22  # 0 in this slice
S_INLIERS_1 = 23  # inliers of the motion-window solve


def frame_step(cfg, gray, depth, T_prev, velocity, motion_radius, snap, acc) -> StepOut:
    """One frame of tracking (Tracking::Track, Tracking.cc:274-552).
    ``motion_radius`` lets the host re-run the step with the widened window
    (Tracking.cc:1198-1203) when the first attempt returns few inliers."""
    fd = make_frame(gray, depth, cfg.camera, cfg.orb)
    return track_frame(cfg, fd, T_prev, velocity, motion_radius, snap, acc)


def track_frame(cfg, fd: FrameData, T_prev, velocity, motion_radius,
                snap: LocalSnapshot, acc: Acc) -> StepOut:
    """The tracking half of ``frame_step`` on an already-built frame."""
    cam, orb = cfg.camera, cfg.orb
    T_pred = velocity @ T_prev
    # Motion-window step WITHOUT the scale/view-angle frustum gates
    # (TrackWithMotionModel, Tracking.cc:1164).
    res1 = track_against_points(
        cam, T_pred, snap.pts, fd, motion_radius, orb.scale, orb.levels,
        check_scale=False,
    )
    prior = torch.where(res1.inlier & (res1.match_point >= 0), res1.match_point, -1)
    res2 = track_local_map_step(
        cam, res1.T_cw, snap.pts, fd, prior, cfg.tracking.local_match_radius,
        orb.scale, orb.levels,
    )

    # --- keyframe-decision counts (NeedNewKeyFrame, Tracking.cc:1452) ------
    matched = (res2.match_point >= 0) & res2.inlier
    N = fd.valid.shape[0]
    hits = torch.zeros(N + 1, dtype=torch.int32, device=fd.valid.device)
    hits.index_add_(
        0, torch.where(matched, res2.match_point, N), matched.to(torch.int32)
    )
    feat_has = hits[:N] > 0
    close = (fd.depth > 0) & (fd.depth < cfg.th_depth) & fd.valid
    tracked_close = torch.sum(feat_has & close)
    untracked_close = torch.sum(~feat_has & close)

    acc2 = acc._replace(
        pt_vis=acc.pt_vis + res2.visible.to(torch.int32),
        pt_found=acc.pt_found + matched.to(torch.int32),
    )
    zero = torch.zeros((), dtype=torch.int64, device=fd.valid.device)
    counts = torch.stack([
        res2.n_inliers.to(torch.int64), res2.n_matches.to(torch.int64),
        res2.n_inliers.to(torch.int64), tracked_close, untracked_close,
        zero, zero, res1.n_inliers.to(torch.int64),
    ]).to(torch.float32)
    summary = torch.cat([res2.T_cw.reshape(16), counts])
    return StepOut(
        T_cw=res2.T_cw,
        vel=res2.T_cw @ torch.linalg.inv_ex(T_prev)[0],
        summary=summary,
        match_point=res2.match_point,
        inlier=res2.inlier,
        fd=fd,
        acc=acc2,
    )


# ---------------------------------------------------------------------------
# Host-side snapshot construction


def make_acc(cfg, device) -> Acc:
    M = cfg.caps.local_points
    L = cfg.caps.local_lines
    Q = cfg.caps.local_lils

    def z(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    return Acc(pt_vis=z(M), pt_found=z(M), ml_vis=z(L), ml_found=z(L), il_obs=z(Q))


def build_point_set(m, mp_ids: np.ndarray, cap: int, device) -> PointSet:
    """Gather + pad a device PointSet for the given map-point ids."""
    n = min(len(mp_ids), cap)
    mp_ids = np.asarray(mp_ids, np.int64)[:n]
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 32), np.uint8)
    level = np.zeros(cap, np.int32)
    angle = np.zeros(cap, np.float32)
    mind = np.zeros(cap, np.float32)
    maxd = np.full(cap, 1e9, np.float32)
    normal = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    if n:
        pos[:n] = m.mp_pos[mp_ids]
        desc[:n] = m.mp_desc[mp_ids]
        mind[:n] = m.mp_min_dist[mp_ids]
        maxd[:n] = m.mp_max_dist[mp_ids]
        normal[:n] = m.mp_normal[mp_ids]
        valid[:n] = m.mp_valid[mp_ids]
        level[:n] = m.mp_level[mp_ids]
        angle[:n] = m.mp_angle[mp_ids]

    def t(a):
        return torch.from_numpy(a).to(device)

    return PointSet(
        pos=t(pos), desc=t(desc), level=t(level), angle=t(angle),
        min_dist=t(mind), max_dist=t(maxd), normal=t(normal), valid=t(valid),
    )


def build_snapshot(m, cfg, pt_ids, device) -> LocalSnapshot:
    """Upload the tracker's local-map view (keyframe events only)."""
    pts = build_point_set(m, pt_ids, cfg.caps.local_points, device)
    return LocalSnapshot(pts=pts, lines=None, lils=None)
