"""Per-frame feature construction (port of
``pslam_tpu/pipeline/frame_ops.py``: ``make_frame``, ``make_frame_stereo``
and ``make_frame_lines``).

Replaces the Frame RGB-D constructor pipeline (reference src/Frame.cc:133-210:
ExtractORB -> ExtractLSD -> UndistortKeyPoints -> ComputeStereoFromRGBD) and
the stereo constructor (Frame.cc:56-131).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera, backproject, undistort_points
from pslam_tpu_torch.ops.fans import LILFeatures, build_lils
from pslam_tpu_torch.ops.image import gather_pixels
from pslam_tpu_torch.ops.lbd import line_descriptors
from pslam_tpu_torch.ops.line3d import fit_lines_3d
from pslam_tpu_torch.ops.lines import LineConfig, detect_lines
from pslam_tpu_torch.ops.orb import OrbConfig, OrbFeatures, extract_orb
from pslam_tpu_torch.ops.stereo import compute_stereo_matches


class FrameData(NamedTuple):
    """Device-side frame: SoA features + stereo depth (capacity N)."""

    uv: torch.Tensor  # (N, 2) undistorted level-0 pixel coords
    ur: torch.Tensor  # (N,) virtual right-image u, -1 if no depth
    depth: torch.Tensor  # (N,) z in meters, 0 if invalid
    xyz_c: torch.Tensor  # (N, 3) camera-frame backprojection (0 if no depth)
    level: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N, 32) uint8
    valid: torch.Tensor  # (N,) bool


def make_frame(img, depth_img, cam: Camera, orb_cfg: OrbConfig) -> FrameData:
    """img (H, W) float32 [0..255]; depth_img (H, W) float32 meters (0=hole).

    Depth is sampled at the raw (distorted) keypoint location like
    Frame::ComputeStereoFromRGBD (Frame.cc:1342-1363); keypoints are then
    undistorted for all geometric use."""
    feats: OrbFeatures = extract_orb(img, orb_cfg)
    z = gather_pixels(depth_img, feats.uv[:, 1], feats.uv[:, 0])
    has_depth = (z > 0.05) & feats.valid
    uv = undistort_points(cam, feats.uv)
    z_safe = torch.where(has_depth, z, torch.ones_like(z))
    ur = torch.where(has_depth, uv[:, 0] - cam.bf / z_safe, torch.full_like(z, -1.0))
    xyz_c = backproject(cam, uv, z) * has_depth[:, None]
    return FrameData(
        uv=uv,
        ur=ur,
        depth=torch.where(has_depth, z, torch.zeros_like(z)),
        xyz_c=xyz_c,
        level=feats.level,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
    )


def make_frame_stereo(img_l, img_r, cam: Camera, orb_cfg: OrbConfig) -> FrameData:
    """Stereo frame construction (Frame stereo ctor, Frame.cc:56-131 +
    ComputeStereoMatches, Frame.cc:1165): ORB in both images, left->right
    matching along the epipolar rows with sub-pixel SAD refinement
    (ops/stereo.py), and the same FrameData the RGB-D path produces."""
    featsL: OrbFeatures = extract_orb(img_l, orb_cfg)
    featsR: OrbFeatures = extract_orb(img_r, orb_cfg)
    ur, z = compute_stereo_matches(
        cam, img_l, img_r,
        featsL.uv, featsL.level, featsL.desc, featsL.valid,
        featsR.uv, featsR.level, featsR.desc, featsR.valid,
        orb_cfg.scale, orb_cfg.levels,
    )
    has_depth = (z > 0.05) & featsL.valid
    uv = undistort_points(cam, featsL.uv)
    # ur was measured on the raw image row; shift it by the undistortion of
    # the left u (rectified stereo: the same distortion in both views).
    ur_u = torch.where(has_depth, ur + (uv[:, 0] - featsL.uv[:, 0]), torch.full_like(z, -1.0))
    xyz_c = backproject(cam, uv, z) * has_depth[:, None]
    return FrameData(
        uv=uv,
        ur=ur_u,
        depth=torch.where(has_depth, z, torch.zeros_like(z)),
        xyz_c=xyz_c,
        level=featsL.level,
        angle=featsL.angle,
        desc=featsL.desc,
        valid=featsL.valid,
    )


class FrameLineData(NamedTuple):
    """Device-side line features of one frame (capacity NL) + LIL set: the
    line part of the Frame ctor (ExtractLSD + isLineGood + fan detection +
    plane build, Frame.cc:489-646)."""

    sp: torch.Tensor  # (NL, 2)
    ep: torch.Tensor  # (NL, 2)
    eq2d: torch.Tensor  # (NL, 3) normalized image-line equations
    angle: torch.Tensor  # (NL,)
    length: torch.Tensor  # (NL,)
    desc: torch.Tensor  # (NL, D) float band descriptors
    valid: torch.Tensor  # (NL,)
    p3s: torch.Tensor  # (NL, 3) camera-frame 3D endpoints (mvLines3D)
    p3e: torch.Tensor  # (NL, 3)
    dir3d: torch.Tensor  # (NL, 3) normalized 3D direction (mvLineEq)
    ok3d: torch.Tensor  # (NL,)
    lil: LILFeatures  # structural-line hypotheses


def make_frame_lines(
    img, depth_img, cam: Camera, line_cfg: LineConfig, n_lil: int = 64
) -> FrameLineData:
    """The line half of the per-frame frontend."""
    lf = detect_lines(img, line_cfg)
    desc = line_descriptors(img, lf.sp, lf.ep, lf.valid)
    p3s, p3e, d3, ok3 = fit_lines_3d(cam, depth_img, lf.sp, lf.ep, lf.valid)
    lil = build_lils(
        lf.sp, lf.ep, lf.eq2d, lf.valid, p3s, p3e, d3, ok3,
        n_lil=n_lil, width=cam.width, height=cam.height,
    )
    return FrameLineData(
        sp=lf.sp, ep=lf.ep, eq2d=lf.eq2d, angle=lf.angle, length=lf.length,
        desc=desc, valid=lf.valid, p3s=p3s, p3e=p3e, dir3d=d3, ok3d=ok3,
        lil=lil,
    )
