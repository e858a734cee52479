"""Typed configuration (port of ``pslam_tpu/utils/config.py``; same fields).

All capacities are fixed at construction: every tensor on the hot path has a
static shape, so these are the knobs that trade memory for headroom.
"""

from __future__ import annotations

import dataclasses

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops.lines import LineConfig
from pslam_tpu_torch.ops.orb import OrbConfig


@dataclasses.dataclass(frozen=True)
class Capacities:
    max_keyframes: int = 256
    max_map_points: int = 32768
    local_points: int = 4096  # tracking local-map view
    local_lines: int = 512  # tracking local map-line snapshot
    local_lils: int = 512  # tracking InsectLine snapshot
    ba_cams: int = 48  # total cameras in a local BA problem
    ba_free: int = 16  # free cameras (1-hop covisibility window)
    ba_points: int = 4096
    ba_edges: int = 16384
    # Structural-line capacities.
    max_map_lines: int = 4096
    max_lils: int = 1024  # map InsectLine landmarks
    frame_lils: int = 64  # LIL hypotheses per frame
    ba_lil_edges: int = 512
    # Global BA (loop closing; Optimizer.cc:41-237).
    gba_cams: int = 128
    gba_free: int = 64
    gba_points: int = 8192
    gba_edges: int = 32768


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    motion_match_radius: float = 15.0
    motion_match_radius_wide: float = 30.0
    local_match_radius: float = 5.0
    min_motion_matches: int = 20
    min_track_inliers: int = 10
    min_local_inliers: int = 30
    kf_min_inlier_ratio: float = 0.75  # NeedNewKeyFrame thRefRatio (RGB-D: 0.75)
    kf_min_interval: int = 0
    kf_max_interval: int = 30  # mMaxFrames = fps (Tracking.cc:124-129)
    th_depth_factor: float = 40.0  # ThDepth = 40 * baseline (TUM1.yaml:66)
    max_new_points_per_kf: int = 256
    reloc_accept_inliers: int = 50  # Tracking.cc:2173
    reloc_max_candidates: int = 5
    reset_if_lost_with_kfs: int = 5  # hard reset gate (Tracking.cc:518-526)


@dataclasses.dataclass(frozen=True)
class PlaneAssocConfig:
    """Map::AssociatePlanesByBoundary gates (Tracking.cc:967, 1209, 1329)."""

    d_th: float = 0.05
    a_th: float = 0.999
    observe_th: int = 20
    probation_kfs: int = 8


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: Camera = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    orb: OrbConfig = OrbConfig()
    lines: LineConfig = LineConfig()
    caps: Capacities = Capacities()
    tracking: TrackingConfig = TrackingConfig()
    plane_assoc: PlaneAssocConfig = PlaneAssocConfig()
    sensor: str = "rgbd"
    use_lines: bool = True  # BASELINE config 1 (points only) sets False
    use_lils: bool = True
    use_bow: bool = True
    use_loop_closing: bool = True
    loop_gba: bool = True
    bow_k: int = 10
    bow_levels: int = 4
    distributed: bool = False

    def __post_init__(self):
        if self.sensor == "stereo" and self.use_lines:
            raise ValueError(
                "sensor='stereo' has no dense depth for the 3D line fit; "
                "set use_lines=False"
            )

    @property
    def th_depth(self) -> float:
        """Close/far stereo depth threshold (reference mThDepth)."""
        return self.tracking.th_depth_factor * self.camera.baseline
