"""The benchmark's scene: a closed textured box room rendered on the card.

A frozen torch copy of ``pslam_tpu_torch/io/synthetic.py``'s ``ClosedRoom``
(``checker_texture``, ``_tex_bilinear``, ``_undistort_normalized_np`` and
``ClosedRoom.render``), rewritten to render a batch of frames in one pass on
the device. Rays are cast in float64; the image is rounded to 8 bits and the
depth to the sensor's ``1 / depth_map_factor`` metres, the form in which a
TUM sequence reaches ``track_rgbd`` after its PNGs are decoded.

The textures are made from the seed with a ``torch.Generator`` on the
device. ``render`` also takes textures from elsewhere, so the tests can
hold it against the port's numpy renderer on the same textures.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def checker_texture(size: int, cell: int, gen: torch.Generator, device) -> torch.Tensor:
    """High-contrast random checkerboard with 8-texel blobs (float32,
    [0, 255]), as ``synthetic.checker_texture`` draws it."""
    n = -(-size // cell)
    base = torch.rand((n, n), generator=gen, device=device, dtype=torch.float64) * 180 + 40
    tex = base.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:size, :size]
    nb = -(-size // 8)
    blobs = torch.rand((nb, nb), generator=gen, device=device, dtype=torch.float64)
    blobs = blobs.repeat_interleave(8, 0).repeat_interleave(8, 1)[:size, :size] * 60 - 30
    return torch.clamp(tex + blobs, 0, 255).to(torch.float32)


def tex_bilinear(tex: torch.Tensor, tu: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup with wrap addressing (``synthetic._tex_bilinear``)."""
    n = tex.shape[0]
    u0 = torch.floor(tu)
    v0 = torch.floor(tv)
    fu = (tu - u0).to(torch.float32)
    fv = (tv - v0).to(torch.float32)
    u0 = torch.remainder(u0.to(torch.int64), n)
    v0 = torch.remainder(v0.to(torch.int64), n)
    u1 = (u0 + 1) % n
    v1 = (v0 + 1) % n
    flat = tex.reshape(-1)
    c00, c01 = flat[v0 * n + u0], flat[v0 * n + u1]
    c10, c11 = flat[v1 * n + u0], flat[v1 * n + u1]
    return (c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv)
            + c10 * (1 - fu) * fv + c11 * fu * fv)


def distort_normalized(x, y, dist):
    """The OpenCV radial-tangential model on normalized coordinates."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def undistort_normalized(x0, y0, dist, iters: int = 8):
    """Fixed-point inverse of ``distort_normalized``
    (``synthetic._undistort_normalized_np``): a distorted pixel's ray goes
    through these undistorted coordinates."""
    x, y = x0, y0
    for _ in range(iters):
        xd, yd = distort_normalized(x, y, dist)
        x = x - (xd - x0)
        y = y - (yd - y0)
    return x, y


@dataclasses.dataclass
class Room:
    """``ClosedRoom``: all six faces textured. Walls at x = +-half_w,
    floor and ceiling at y = +-half_h (y down), back wall at z = depth and
    front wall at z = 2 - depth."""

    depth: float
    half_w: float
    half_h: float
    tex_size: int
    textures: list  # six (tex_size, tex_size) float32 tensors

    @classmethod
    def from_seed(cls, seed: int, depth: float, half_w: float, half_h: float,
                  tex_size: int, device) -> "Room":
        """Six checker textures of cells 24, 32, ..., 64 texels, drawn from
        ``seed`` in one generator on ``device``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        tex = [checker_texture(tex_size, 24 + 8 * i, gen, device) for i in range(6)]
        return cls(depth, half_w, half_h, tex_size, tex)

    def planes(self):
        """(axis, value, (texture u axis, texture v axis), texture index)."""
        return [
            (2, self.depth, (0, 1), 0),  # back wall
            (2, -self.depth + 2.0, (0, 1), 5),  # front wall
            (1, self.half_h, (0, 2), 1),  # floor
            (1, -self.half_h, (0, 2), 4),  # ceiling
            (0, -self.half_w, (2, 1), 2),  # left wall
            (0, self.half_w, (2, 1), 3),  # right wall
        ]

    def bounds(self):
        """(lo, hi) of the room on each world axis."""
        return ((-self.half_w, self.half_w), (-self.half_h, self.half_h),
                (-self.depth + 2.0, self.depth))


def camera_rays(K, width: int, height: int, dist, device) -> torch.Tensor:
    """(H, W, 3) float64 camera-frame rays with z = 1 through each pixel
    centre, undistorted when ``dist`` is given."""
    fx, fy, cx, cy = K
    vs, us = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                            torch.arange(width, dtype=torch.float64, device=device),
                            indexing="ij")
    x, y = (us - cx) / fx, (vs - cy) / fy
    if dist is not None:
        x, y = undistort_normalized(x, y, dist)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def render(room: Room, rays: torch.Tensor, T_cw: torch.Tensor):
    """Ray-cast a batch of poses. ``rays`` (H, W, 3) float64, ``T_cw`` (B, 4, 4)
    world-to-camera. Returns (gray (B, H, W) float32 in [0, 255], depth
    (B, H, W) float64 metres along the camera z axis)."""
    T = T_cw.to(torch.float64)
    R, t = T[:, :3, :3], T[:, :3, 3]
    C = -torch.einsum("bji,bj->bi", R, t)  # camera centres, world frame
    dirs = torch.einsum("hwj,bji->bhwi", rays, R)  # R^T ray, world frame
    B, H, W = dirs.shape[:3]
    best = torch.full((B, H, W), math.inf, dtype=torch.float64, device=rays.device)
    gray = torch.zeros((B, H, W), dtype=torch.float32, device=rays.device)
    bounds = room.bounds()
    scale = room.tex_size / (2 * max(room.half_w, room.half_h, room.depth))
    for axis, value, (ua, va), ti in room.planes():
        d = dirs[..., axis]
        t_hit = (value - C[:, axis, None, None]) / d
        pt = C[:, None, None, :] + t_hit[..., None] * dirs
        ok = (t_hit > 0.05) & torch.isfinite(t_hit)
        for ax2 in range(3):
            if ax2 != axis:
                lo, hi = bounds[ax2]
                ok &= (pt[..., ax2] >= lo - 1e-6) & (pt[..., ax2] <= hi + 1e-6)
        closer = ok & (t_hit < best)
        col = tex_bilinear(room.textures[ti], pt[..., ua] * scale, pt[..., va] * scale)
        gray = torch.where(closer, col, gray)
        best = torch.where(closer, t_hit, best)
    depth = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return gray, depth


def sensor_frames(gray: torch.Tensor, depth: torch.Tensor, depth_map_factor: float):
    """What a decoded TUM frame holds: 8-bit intensities and depth in steps
    of 1 / depth_map_factor metres, both float32."""
    g = torch.round(torch.clamp(gray, 0, 255)).to(torch.float32)
    z = (torch.round(depth * depth_map_factor) / depth_map_factor).to(torch.float32)
    return g, z
