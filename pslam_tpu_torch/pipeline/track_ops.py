"""Per-frame tracking steps (port of ``pslam_tpu/pipeline/track_ops.py``).

- ``track_against_points``: the core of TrackWithMotionModel /
  TrackReferenceKeyFrame (reference Tracking.cc:1164, 880): project candidate
  map points with a pose prior, window-masked Hamming matching (kernel K1 on
  CUDA tensors), rotation consistency, then PoseOptimization (kernel K2).
- ``track_local_map_step``: SearchLocalPoints + second PoseOptimization
  (Tracking.cc:1317-1408), also returning per-point visible/found flags;
  map-associated structural-line (LIL) observations join its pose solve.
- ``track_against_points_unwindowed``: the reference-KF fallback with no
  projection window (plain Hamming matrix).
- ``track_frame_to_frame`` / ``track_frame_to_frame_unwindowed``: the
  localization-only visual-odometry steps against the previous frame's
  depth-backed features (``_vo_point_set``).

The TPU's one-hot matmul row gathers (``_gather_rows``) become plain
indexing with identical results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera, in_image, project_stereo, transform_points
from pslam_tpu_torch.ops.fused_match import projection_match
from pslam_tpu_torch.ops.match import (
    TH_HIGH,
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
from pslam_tpu_torch.pipeline.frame_ops import FrameData
from pslam_tpu_torch.solver.lil import LIL_TRACK_WEIGHT, LILPoseObs
from pslam_tpu_torch.solver.pose_opt import PoseObs, pose_optimization
from pslam_tpu_torch.utils.trace import span


class PointSet(NamedTuple):
    """A fixed-capacity set of candidate map points (device snapshot)."""

    pos: torch.Tensor  # (M, 3) world positions
    desc: torch.Tensor  # (M, 32) uint8
    level: torch.Tensor  # (M,) reference observation octave
    angle: torch.Tensor  # (M,)
    min_dist: torch.Tensor  # (M,) scale-invariance band
    max_dist: torch.Tensor  # (M,)
    normal: torch.Tensor  # (M, 3) mean viewing direction
    valid: torch.Tensor  # (M,) bool


class TrackResult(NamedTuple):
    T_cw: torch.Tensor  # (4, 4) optimized pose
    match_point: torch.Tensor  # (M,) feature index matched per point, -1 none
    n_matches: torch.Tensor  # () matches fed to the optimizer
    n_inliers: torch.Tensor  # () optimizer point inliers
    inlier: torch.Tensor  # (M,) bool per-point inlier flag
    visible: torch.Tensor  # (M,) bool point projected into the frame
    lil_inlier: torch.Tensor  # (Nl,) bool LIL inliers ((1,) False without LILs)
    n_weighted: torch.Tensor  # () points + 5 x LIL inliers (Tracking.cc:1396)


def _project_points(cam: Camera, T_cw, pts: PointSet):
    Xc = transform_points(T_cw, pts.pos)
    uvr = project_stereo(cam, Xc)
    z = Xc[..., 2]
    visible = pts.valid & (z > 0.05) & in_image(cam, uvr[..., :2], margin=1.0)
    return uvr, z, visible


def _scale_visibility(cam: Camera, T_cw, pts: PointSet, scale: float, levels: int):
    """Distance band + viewing angle checks + predicted octave
    (Frame::isInFrustum; MapPoint::PredictScale)."""
    C = -torch.einsum("ij,i->j", T_cw[:3, :3], T_cw[:3, 3])
    d = pts.pos - C[None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    in_band = (dist >= pts.min_dist * 0.8) & (dist <= pts.max_dist * 1.2)
    viewcos = torch.sum(d * pts.normal, dim=-1) / torch.clamp(dist, min=1e-9)
    ok_view = viewcos > 0.5  # cos(60 deg), Tracking.cc SearchLocalPoints
    ratio = torch.clamp(pts.max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    log_scale = torch.log(torch.tensor(scale, dtype=ratio.dtype, device=ratio.device))
    pred_level = torch.clamp(
        torch.ceil(torch.log(ratio) / log_scale).to(torch.int32), 0, levels - 1
    )
    return in_band & ok_view, pred_level


def _level_factors(scale: float, levels: int, device):
    return torch.tensor(
        [scale**l for l in range(levels)], dtype=torch.float32, device=device
    )


def _match_points_to_frame(
    cam: Camera,
    T_pred,
    pts: PointSet,
    frame: FrameData,
    radius,
    orb_scale: float,
    orb_levels: int,
    check_scale: bool,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
):
    """Project points, window-masked Hamming match (fused matcher).
    Returns (match feature index per point (M,), visible mask (M,))."""
    uvr, z, visible = _project_points(cam, T_pred, pts)
    if check_scale:
        band_ok, pred_level = _scale_visibility(cam, T_pred, pts, orb_scale, orb_levels)
        visible = visible & band_ok
    else:
        pred_level = pts.level
    sig = _level_factors(orb_scale, orb_levels, T_pred.device)
    r = radius * sig[torch.clamp(pred_level, 0, orb_levels - 1).to(torch.int64)]
    idx, _ = projection_match(
        uvr[:, :2], r, pred_level - 1, pred_level + 1, visible, pts.desc,
        frame.uv, frame.level, frame.valid, frame.desc,
        max_dist=max_dist, ratio=ratio,
    )
    keep = rotation_consistency_mask(
        pts.angle, frame.angle[torch.clamp(idx, min=0)], idx >= 0
    )
    return torch.where(keep, idx, -1), visible


def scale_sigma2_arr(scale: float, levels: int, device=None):
    return torch.tensor(
        [(scale**l) ** 2 for l in range(levels)], dtype=torch.float32, device=device
    )


def _pose_obs_from_matches(pts: PointSet, frame: FrameData, match_idx, sigma2):
    """Build the fixed-capacity PoseObs (one slot per candidate point)."""
    fi = torch.clamp(match_idx, min=0)
    obs = torch.cat([frame.uv[fi], frame.ur[fi][:, None]], dim=1)
    lvl = torch.clamp(frame.level[fi].to(torch.int64), 0, sigma2.shape[0] - 1)
    return PoseObs(
        X_w=pts.pos,
        obs=obs,
        inv_sigma2=1.0 / sigma2[lvl],
        valid=match_idx >= 0,
    )


def _result(T_opt, match_idx, po, inlier, visible, lil=None, lil_inlier=None):
    if lil is None:
        lil_in = torch.zeros(1, dtype=torch.bool, device=inlier.device)
    else:
        lil_in = lil_inlier & lil.valid
    n_pts = torch.sum(inlier.to(torch.int32))
    return TrackResult(
        T_cw=T_opt,
        match_point=match_idx,
        n_matches=torch.sum(po.valid.to(torch.int32)),
        n_inliers=n_pts,
        inlier=inlier,
        visible=visible,
        lil_inlier=lil_in,
        n_weighted=n_pts + LIL_TRACK_WEIGHT * torch.sum(lil_in.to(torch.int32)),
    )


def track_against_points(
    cam: Camera,
    T_pred,
    pts: PointSet,
    frame: FrameData,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
    check_scale: bool = False,
) -> TrackResult:
    """Motion-model / reference-KF tracking step."""
    match_idx, visible = _match_points_to_frame(
        cam, T_pred, pts, frame, radius, orb_scale, orb_levels, check_scale
    )
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels, T_pred.device)
    po = _pose_obs_from_matches(pts, frame, match_idx, sigma2)
    with span("track.pose"):
        T_opt, inlier, _, _ = pose_optimization(cam, T_pred, po)
    return _result(T_opt, match_idx, po, inlier, visible)


def track_against_points_unwindowed(
    cam: Camera,
    T_prior,
    pts: PointSet,
    frame: FrameData,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Reference-KF fallback (TrackReferenceKeyFrame, Tracking.cc:880):
    descriptor-only matching with NO projection window, ratio 0.7 and
    rotation consistency (``ORBmatcher matcher(0.7, true)``)."""
    dist = hamming_matrix(pts.desc, frame.desc)
    idx, _ = mutual_nn_match(
        dist, valid_a=pts.valid, valid_b=frame.valid, max_dist=TH_LOW, ratio=0.7,
    )
    keep = rotation_consistency_mask(
        pts.angle, frame.angle[torch.clamp(idx, min=0)], idx >= 0
    )
    match_idx = torch.where(keep, idx, -1)
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels, T_prior.device)
    po = _pose_obs_from_matches(pts, frame, match_idx, sigma2)
    with span("track.pose"):
        T_opt, inlier, _, _ = pose_optimization(cam, T_prior, po)
    return _result(T_opt, match_idx, po, inlier, pts.valid)


def _vo_point_set(prev_fd: FrameData, T_prev) -> PointSet:
    """The previous frame's depth-backed features as temporary landmarks
    (UpdateLastFrame's temporal VO points, Tracking.cc:1110-1162); nothing is
    inserted into the map."""
    R = T_prev[:3, :3]
    t = T_prev[:3, 3]
    pos_w = (prev_fd.xyz_c - t) @ R  # R^T (Xc - t)
    C = -R.T @ t
    d = pos_w - C[None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    return PointSet(
        pos=pos_w,
        desc=prev_fd.desc,
        level=prev_fd.level,
        angle=prev_fd.angle,
        min_dist=torch.zeros_like(dist),
        max_dist=dist * 10.0 + 1.0,
        normal=d / torch.clamp(dist[:, None], min=1e-9),
        valid=prev_fd.valid & (prev_fd.depth > 0),
    )


def track_frame_to_frame(
    cam: Camera,
    T_prior,
    prev_fd: FrameData,
    T_prev,
    frame: FrameData,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Windowed visual-odometry step of localization-only mbVO mode (kernels
    K1 and K2 on CUDA tensors)."""
    pts = _vo_point_set(prev_fd, T_prev)
    return track_against_points(
        cam, T_prior, pts, frame, radius, orb_scale, orb_levels, check_scale=False,
    )


def track_frame_to_frame_unwindowed(
    cam: Camera,
    T_prior,
    prev_fd: FrameData,
    T_prev,
    frame: FrameData,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Unwindowed VO fallback: descriptor matching against the previous
    frame's features, for pans whose image shift exceeds any projection
    window (kernel K2 in the pose solve)."""
    pts = _vo_point_set(prev_fd, T_prev)
    return track_against_points_unwindowed(cam, T_prior, pts, frame, orb_scale, orb_levels)


def track_local_map_step(
    cam: Camera,
    T_init,
    local_pts: PointSet,
    frame: FrameData,
    prior_match_idx,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
    lil: LILPoseObs | None = None,
) -> TrackResult:
    """TrackLocalMap: match the local-map point set (scale-checked), merge
    with the motion-model matches already held, re-optimize (with the
    optional fixed LIL observations). A fresh match replaces the prior only
    where one is found."""
    match_idx, visible = _match_points_to_frame(
        cam, T_init, local_pts, frame, radius, orb_scale, orb_levels,
        check_scale=True, ratio=0.95,
    )
    match_idx = torch.where(match_idx >= 0, match_idx, prior_match_idx)
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels, T_init.device)
    po = _pose_obs_from_matches(local_pts, frame, match_idx, sigma2)
    with span("track.pose"):
        T_opt, inlier, _, lil_inlier = pose_optimization(cam, T_init, po, lil=lil)
    return _result(T_opt, match_idx, po, inlier, visible, lil, lil_inlier)
