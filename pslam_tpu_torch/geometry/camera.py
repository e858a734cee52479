"""Pinhole / RGB-D stereo camera model (port of
``pslam_tpu/geometry/camera.py``).

RGB-D "stereo" convention follows the reference: a virtual right image at
baseline*fx = ``bf``; for a point at depth z the right-view u-coordinate is
``ur = u - bf / z`` (Frame::ComputeStereoFromRGBD, Frame.cc:1342).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 40.0  # baseline * fx (reference: Camera.bf in YAML)
    width: int = 640
    height: int = 480
    # Radial/tangential distortion (OpenCV order k1 k2 p1 p2 k3).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    def K(self, device=None):
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
            device=device,
        )

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, Xc):
    """Camera-frame points (..., 3) -> pixel (..., 2). No validity check."""
    z_safe = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z_safe + cam.cx
    v = cam.fy * Xc[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Camera, Xc):
    """Camera-frame points (..., 3) -> (..., 3) [u, v, ur]."""
    uv = project(cam, Xc)
    ur = uv[..., 0] - cam.bf / _safe_z(Xc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Camera, uv, z):
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)
    (Frame::UnprojectStereo, Frame.cc:1365)."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def in_image(cam: Camera, uv, margin: float = 0.0):
    """Validity mask for pixel coords (..., 2)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= margin)
        & (u < cam.width - margin)
        & (v >= margin)
        & (v < cam.height - margin)
    )


def distort_normalized(cam: Camera, xn):
    """Apply the OpenCV distortion model to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 5):
    """Iteratively undistort pixel coordinates (..., 2) -> (..., 2)
    (cv::undistortPoints + re-projection with the same K)."""
    if not cam.has_distortion:
        return uv
    xn0 = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    xn = xn0
    for _ in range(iters):
        d = distort_normalized(cam, xn) - xn
        xn = xn0 - d
    u = cam.fx * xn[..., 0] + cam.cx
    v = cam.fy * xn[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)
