"""Per-frame tracking against a device-resident snapshot (port of
``pslam_tpu/pipeline/frame_step.py``).

- ``LocalSnapshot``: the tracker's view of the map (points, map lines,
  InsectLines), uploaded once per keyframe event (between keyframes the map
  is immutable, so the snapshot is exact). ``lines`` is None without
  ``use_lines`` and ``lils`` None without ``use_lils``.
- ``frame_step``: feature extraction + line frontend + motion-window
  tracking + LIL plane association + local-map tracking + map-line matching
  + per-landmark found/visible accumulation. The host reads a 24-float
  summary per frame; full frame arrays are read only on keyframe insertion.
  ``track_frame`` is the same step on already-built frame features.

The JAX package's one-hot gathers and membership tests become plain
indexing and boolean scatters with identical results.

Behavioral anchor: Tracking::Track (reference src/Tracking.cc:274-552).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.ops.line_match import match_lines_projection
from pslam_tpu_torch.pipeline.frame_ops import (
    FrameData,
    FrameLineData,
    make_frame,
    make_frame_lines,
    make_frame_stereo,
)
from pslam_tpu_torch.pipeline.track_ops import (
    PointSet,
    track_against_points,
    track_local_map_step,
)
from pslam_tpu_torch.solver.lil import LILPoseObs
from pslam_tpu_torch.utils.trace import span


class LineSnap(NamedTuple):
    """Device snapshot of the local map-line set (capacity L)."""

    pos: torch.Tensor  # (L, 6) world endpoints
    desc: torch.Tensor  # (L, D)
    min_dist: torch.Tensor  # (L,)
    max_dist: torch.Tensor  # (L,)
    normal: torch.Tensor  # (L, 3) mean viewing direction
    valid: torch.Tensor  # (L,) bool


class LILSnap(NamedTuple):
    """Device snapshot of the map InsectLine table (capacity Q)."""

    state: torch.Tensor  # (Q, 15) world 5-point state
    plane: torch.Tensor  # (Q, 4) world plane (n, d), d >= 0
    valid: torch.Tensor  # (Q,) bool


class LocalSnapshot(NamedTuple):
    pts: PointSet  # (M,)
    lines: LineSnap | None
    lils: LILSnap | None


class Acc(NamedTuple):
    """Device-resident found/visible accumulators, folded into the host map
    at every snapshot rebuild (MapPoint::IncreaseVisible/Found etc.)."""

    pt_vis: torch.Tensor  # (M,) int32
    pt_found: torch.Tensor  # (M,) int32
    ml_vis: torch.Tensor  # (L,) int32
    ml_found: torch.Tensor  # (L,) int32
    il_obs: torch.Tensor  # (Q,) int32 distinct-frame plane associations


class StepOut(NamedTuple):
    T_cw: torch.Tensor  # (4, 4) device pose
    vel: torch.Tensor  # (4, 4) device velocity T_cw @ inv(T_prev)
    summary: torch.Tensor  # (24,) f32, see the S_* indices below
    match_point: torch.Tensor  # (M,) feature idx per local point, -1 none
    inlier: torch.Tensor  # (M,) bool
    line_match: torch.Tensor  # (L,) frame-line slot per local line, -1 none
    lil_match: torch.Tensor  # (QF,) snapshot LIL slot per frame LIL, -1 none
    fd: FrameData
    fl: FrameLineData | None
    acc: Acc


# summary vector layout (as in the JAX package)
S_T = slice(0, 16)  # row-major 4x4 T_cw
S_INLIERS = 16  # final point inliers (accept gate, Tracking.cc:1400-1406)
S_MATCHES = 17  # matches fed to the final solve
S_WEIGHTED = 18  # points + 5*LIL inliers (Tracking.cc:1037,1281,1396)
S_TRACKED_CLOSE = 19  # close tracked features (NeedNewKeyFrame)
S_UNTRACKED_CLOSE = 20  # close untracked features
S_LINE_MATCHES = 21  # local map lines matched
S_LIL_ASSOC = 22  # frame LILs associated with a map InsectLine
S_INLIERS_1 = 23  # inliers of the motion-window solve


def _project_uvz(cam, T_cw, X_w):
    Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    zs = torch.clamp(z, min=1e-9)
    uv = torch.stack([cam.fx * Xc[:, 0] / zs + cam.cx, cam.fy * Xc[:, 1] / zs + cam.cy],
                     dim=-1)
    return uv, z


def _match_local_lines(cam, T_cw, ls: LineSnap, fl: FrameLineData, radius):
    """Device analogue of LSDmatcher::SearchByProjection
    (add_src/LSDmatcher.cpp:112-260) for the local map lines. Returns
    (frame-line slot per local line or -1, visible mask)."""
    sp2, zs = _project_uvz(cam, T_cw, ls.pos[:, :3])
    ep2, ze = _project_uvz(cam, T_cw, ls.pos[:, 3:])
    okz = (zs > 0.05) & (ze > 0.05)
    W, H = float(cam.width), float(cam.height)
    in_img = (
        (sp2[:, 0] > -50) & (sp2[:, 0] < W + 50)
        & (sp2[:, 1] > -50) & (sp2[:, 1] < H + 50)
    )
    C = -T_cw[:3, :3].T @ T_cw[:3, 3]
    mid = 0.5 * (ls.pos[:, :3] + ls.pos[:, 3:])
    om = mid - C[None, :]
    dist = torch.linalg.vector_norm(om, dim=-1)
    band = (dist >= 0.8 * ls.min_dist) & (dist <= 1.2 * ls.max_dist)
    viewcos = torch.sum(om * ls.normal, dim=-1) / torch.clamp(dist, min=1e-9)
    vmask = okz & in_img & band & (viewcos > 0.5) & ls.valid
    idx, _ = match_lines_projection(
        sp2, ep2, None, ls.desc, vmask, fl.sp, fl.ep, fl.desc, fl.valid, radius,
    )
    return idx, vmask


def _associate_lils(lil, T_cw, ils: LILSnap, a_th: float, d_th: float):
    """Device plane association (Map::AssociatePlanesByBoundary,
    Map.cc:204-272): frame LIL -> map InsectLine by normal angle + mean
    |point-plane distance| over the 5 structure points; the smallest distance
    wins. Returns (LILPoseObs for the pose solve, il_match (QF,) snapshot
    slot or -1)."""
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pts_c = torch.stack([lil.p1s, lil.p1e, lil.p2s, lil.p2e, lil.cross3d], dim=1)
    pts_w = (pts_c - t) @ R  # R^T (X_c - t)
    n_w = lil.plane[:, :3] @ R  # R^T n
    cos = torch.abs(n_w @ ils.plane[:, :3].T)  # (QF, Q)
    d = torch.abs(
        torch.einsum("fpj,qj->fpq", pts_w, ils.plane[:, :3]) + ils.plane[None, None, :, 3]
    ).mean(dim=1)  # (QF, Q)
    ok = (cos > a_th) & (d < d_th) & ils.valid[None, :] & lil.valid[:, None]
    dm = torch.where(ok, d, torch.full_like(d, float("inf")))
    best = torch.argmin(dm, dim=1)
    has = torch.isfinite(torch.min(dm, dim=1).values)
    il_match = torch.where(has, best, -1)
    gathered = ils.state[best]
    state = torch.where(has[:, None], gathered, torch.zeros_like(gathered))
    obs = torch.cat([lil.eq1, lil.eq2, lil.cross2d], dim=-1)
    return LILPoseObs(state=state, obs=obs, valid=has), il_match


def _any_hit(idx, n: int):
    """(K,) indices in [-1, n) -> (n,) int32 1 where any index hits."""
    hit = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    hit[torch.where(idx >= 0, idx, n)] = 1
    return hit[:n]


def frame_step(cfg, gray, depth, T_prev, velocity, motion_radius, snap, acc) -> StepOut:
    """One frame of tracking (Tracking::Track, Tracking.cc:274-552).
    ``motion_radius`` lets the host re-run the step with the widened window
    (Tracking.cc:1198-1203) when the first attempt returns few inliers.
    With ``cfg.sensor == "stereo"``, ``depth`` carries the right image."""
    with span("track.orb"):
        if cfg.sensor == "stereo":
            fd = make_frame_stereo(gray, depth, cfg.camera, cfg.orb)
        else:
            fd = make_frame(gray, depth, cfg.camera, cfg.orb)
    fl = None
    if cfg.use_lines:
        with span("track.lines"):
            fl = make_frame_lines(gray, depth, cfg.camera, cfg.lines, cfg.caps.frame_lils)
    return track_frame(cfg, fd, T_prev, velocity, motion_radius, snap, acc, fl)


def track_frame(cfg, fd: FrameData, T_prev, velocity, motion_radius,
                snap: LocalSnapshot, acc: Acc, fl: FrameLineData | None = None) -> StepOut:
    """The tracking half of ``frame_step`` on already-built frame features."""
    cam, orb = cfg.camera, cfg.orb
    dev = fd.valid.device
    T_pred = velocity @ T_prev
    # Motion-window step WITHOUT the scale/view-angle frustum gates
    # (TrackWithMotionModel, Tracking.cc:1164).
    with span("track.motion"):
        res1 = track_against_points(
            cam, T_pred, snap.pts, fd, motion_radius, orb.scale, orb.levels,
            check_scale=False,
        )

    lil_obs = None
    lil_match = torch.full((cfg.caps.frame_lils,), -1, dtype=torch.int64, device=dev)
    if cfg.use_lines and cfg.use_lils and snap.lils is not None:
        lil_obs, lil_match = _associate_lils(
            fl.lil, res1.T_cw, snap.lils, cfg.plane_assoc.a_th, cfg.plane_assoc.d_th,
        )

    prior = torch.where(res1.inlier & (res1.match_point >= 0), res1.match_point, -1)
    with span("track.local_map"):
        res2 = track_local_map_step(
            cam, res1.T_cw, snap.pts, fd, prior, cfg.tracking.local_match_radius,
            orb.scale, orb.levels, lil=lil_obs,
        )

    L = acc.ml_vis.shape[0]
    line_match = torch.full((L,), -1, dtype=torch.int64, device=dev)
    line_vis = torch.zeros(L, dtype=torch.bool, device=dev)
    if cfg.use_lines and snap.lines is not None:
        with span("track.line_match"):
            line_match, line_vis = _match_local_lines(cam, res2.T_cw, snap.lines, fl, 8.0)

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

    acc2 = Acc(
        pt_vis=acc.pt_vis + res2.visible.to(torch.int32),
        pt_found=acc.pt_found + matched.to(torch.int32),
        ml_vis=acc.ml_vis + line_vis.to(torch.int32),
        ml_found=acc.ml_found + (line_match >= 0).to(torch.int32),
        il_obs=acc.il_obs + _any_hit(lil_match, acc.il_obs.shape[0]),
    )
    counts = torch.stack([
        res2.n_inliers.to(torch.int64), res2.n_matches.to(torch.int64),
        res2.n_weighted.to(torch.int64), tracked_close, untracked_close,
        torch.sum(line_match >= 0), torch.sum(lil_match >= 0),
        res1.n_inliers.to(torch.int64),
    ]).to(torch.float32)
    summary = torch.cat([res2.T_cw.reshape(16), counts])
    return StepOut(
        T_cw=res2.T_cw,
        vel=res2.T_cw @ torch.linalg.inv_ex(T_prev)[0],
        summary=summary,
        match_point=res2.match_point,
        inlier=res2.inlier,
        line_match=line_match,
        lil_match=lil_match,
        fd=fd,
        fl=fl,
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


def build_snapshot(m, cfg, pt_ids, device, ml_ids=(), il_ids=()) -> LocalSnapshot:
    """Upload the tracker's local-map view (keyframe events only)."""
    pts = build_point_set(m, pt_ids, cfg.caps.local_points, device)

    def t(a):
        return torch.from_numpy(a).to(device)

    lines = lils = None
    if cfg.use_lines:
        L = cfg.caps.local_lines
        n = min(len(ml_ids), L)
        ml = np.asarray(ml_ids, np.int64)[:n]
        pos = np.zeros((L, 6), np.float32)
        desc = np.zeros((L, m.ml_desc.shape[1]), np.float32)
        mind = np.zeros(L, np.float32)
        maxd = np.full(L, 1e9, np.float32)
        normal = np.zeros((L, 3), np.float32)
        lvalid = np.zeros(L, bool)
        if n:
            pos[:n] = m.ml_pos[ml]
            desc[:n] = m.ml_desc[ml]
            mind[:n] = m.ml_min_dist[ml]
            maxd[:n] = m.ml_max_dist[ml]
            normal[:n] = m.ml_normal[ml]
            lvalid[:n] = m.ml_valid[ml]
        lines = LineSnap(pos=t(pos), desc=t(desc), min_dist=t(mind), max_dist=t(maxd),
                         normal=t(normal), valid=t(lvalid))
        if cfg.use_lils:
            Q = cfg.caps.local_lils
            nq = min(len(il_ids), Q)
            il = np.asarray(il_ids, np.int64)[:nq]
            state = np.zeros((Q, 15), np.float32)
            plane = np.zeros((Q, 4), np.float32)
            plane[:, 3] = 1e9  # far dummy plane: never associates
            qvalid = np.zeros(Q, bool)
            if nq:
                state[:nq] = m.il_state[il]
                plane[:nq] = m.il_plane[il]
                qvalid[:nq] = m.il_valid[il]
            lils = LILSnap(state=t(state), plane=t(plane), valid=t(qvalid))
    return LocalSnapshot(pts=pts, lines=lines, lils=lils)
