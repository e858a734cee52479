"""Per-frame feature construction, RGB-D half (port of
``pslam_tpu/pipeline/frame_ops.py``: ``FrameData`` and ``make_frame``).

Replaces the Frame RGB-D constructor pipeline (reference src/Frame.cc:133-210:
ExtractORB -> UndistortKeyPoints -> ComputeStereoFromRGBD). The line
frontend and stereo frames are not part of this slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera, backproject, undistort_points
from pslam_tpu_torch.ops.image import gather_pixels
from pslam_tpu_torch.ops.orb import OrbConfig, OrbFeatures, extract_orb


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
