"""Synthetic textured RGB-D scenes with exact ground truth.

The reference validates only end-to-end on TUM/ICL sequences (SURVEY.md §4);
no dataset ships in this environment, so integration tests and benchmarks run
on synthetic scenes: a textured box room rendered by projective texture
lookup, giving pixel-exact depth and poses.

Geometry: an axis-aligned room (floor, back wall, left/right walls) with
procedural high-contrast textures; the camera moves on a configurable
trajectory looking into the room. Rendering is plain ray casting against the
four planes — done in numpy on the host once per sequence (dataset
generation is not part of the benched pipeline).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _tex_bilinear(tex: np.ndarray, tu: np.ndarray, tv: np.ndarray):
    """Bilinear texture lookup with wrap addressing. Nearest-texel lookup
    quantizes sub-pixel image shifts to the texel grid (at ~1 texel/pixel
    that aliases stereo disparity by up to ~0.5 px); bilinear keeps the
    rendered photometry consistent at sub-pixel camera motion."""
    n = tex.shape[0]
    u0 = np.floor(tu).astype(np.int64)
    v0 = np.floor(tv).astype(np.int64)
    fu = (tu - u0).astype(np.float32)
    fv = (tv - v0).astype(np.float32)
    u0 %= n
    v0 %= n
    u1 = (u0 + 1) % n
    v1 = (v0 + 1) % n
    c00 = tex[v0, u0]
    c01 = tex[v0, u1]
    c10 = tex[v1, u0]
    c11 = tex[v1, u1]
    return (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )


def checker_texture(size: int = 1024, cell: int = 32, seed: int = 0):
    """High-contrast random checkerboard with corner-rich structure."""
    rng = np.random.default_rng(seed)
    n = -(-size // cell)
    base = rng.uniform(40, 220, size=(n, n))
    tex = np.kron(base, np.ones((cell, cell)))[:size, :size]
    # Add fine blobs for sub-cell corners.
    blobs = rng.uniform(0, 1, size=(-(-size // 8), -(-size // 8)))
    blobs = np.kron(blobs, np.ones((8, 8)))[:size, :size] * 60 - 30
    tex = np.clip(tex + blobs, 0, 255)
    return tex.astype(np.float32)


def _undistort_normalized_np(xn, dist, iters: int = 8):
    """Invert the OpenCV distortion model on normalized coords (numpy
    fixed-point, mirrors geometry.camera.undistort_points)."""
    k1, k2, p1, p2, k3 = dist

    def fwd(x, y):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return xd, yd

    x0, y0 = xn[..., 0], xn[..., 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        xd, yd = fwd(x, y)
        x = x - (xd - x0)
        y = y - (yd - y0)
    return np.stack([x, y], axis=-1)


@dataclasses.dataclass
class BoxRoom:
    """Axis-aligned textured box room. Walls at z=depth, x=+-half_w, y=+-half_h."""

    depth: float = 6.0
    half_w: float = 3.0
    half_h: float = 2.0
    tex_size: int = 1024
    seed: int = 0

    def __post_init__(self):
        self.textures = [
            checker_texture(self.tex_size, 32 + 8 * i, self.seed + i) for i in range(4)
        ]

    def render(self, K, T_cw, width: int, height: int, dist=None):
        """Render grayscale + depth for camera pose T_cw (world->cam, 4x4).

        ``dist``: optional (k1, k2, p1, p2, k3) — renders through the OpenCV
        lens-distortion model so the images match a distorted calibration.
        Returns (gray (H, W) float32 [0..255], depth (H, W) float32 meters).
        """
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        xn = np.stack([(us - cx) / fx, (vs - cy) / fy], axis=-1)
        if dist is not None:
            # Distorted-image rendering: the ray of a distorted pixel goes
            # through the UNDISTORTED normalized coordinates.
            xn = _undistort_normalized_np(xn, dist)
        rays_c = np.concatenate(
            [xn, np.ones(xn.shape[:-1] + (1,), np.float64)], axis=-1
        )
        R = T_cw[:3, :3]
        t = T_cw[:3, 3]
        # Camera center and ray directions in world frame.
        C = -R.T @ t
        dirs = rays_c @ R  # (H, W, 3) = R^T @ ray

        best_t = np.full((height, width), np.inf)
        gray = np.zeros((height, width), np.float32)

        planes = [
            # (axis, value, (tex_u_axis, tex_v_axis), texture)
            (2, self.depth, (0, 1), self.textures[0]),  # back wall
            (1, self.half_h, (0, 2), self.textures[1]),  # floor (y down)
            (0, -self.half_w, (2, 1), self.textures[2]),  # left wall
            (0, self.half_w, (2, 1), self.textures[3]),  # right wall
        ]
        for axis, value, (ua, va), tex in planes:
            d = dirs[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (value - C[axis]) / d
            pt = C[None, None, :] + t_hit[..., None] * dirs
            ok = (t_hit > 0.05) & np.isfinite(t_hit)
            # Inside the room extent on the other two axes.
            for ax2, lim in ((0, self.half_w), (1, self.half_h), (2, self.depth)):
                if ax2 == axis:
                    continue
                ok &= (pt[..., ax2] >= -lim - 1e-6) & (pt[..., ax2] <= lim + 1e-6)
            closer = ok & (t_hit < best_t)
            # Texture lookup (wrap).
            scale = self.tex_size / (2 * max(self.half_w, self.half_h, self.depth))
            col = _tex_bilinear(
                tex, pt[..., ua] * scale, pt[..., va] * scale
            )
            gray = np.where(closer, col, gray)
            best_t = np.where(closer, t_hit, best_t)

        zdir = dirs[..., 2]
        depth = np.where(np.isfinite(best_t), best_t, 0.0)
        # best_t is distance along the ray; depth (z) = t * ray_z component
        # of the *camera-frame* ray, which has z=1 by construction after
        # normalization below.
        # rays_c has z=1, so camera-frame depth = t_hit directly in units of
        # the z=1-normalized ray -> z = t_hit.
        del zdir
        return gray.astype(np.float32), depth.astype(np.float32)


def arc_trajectory(n_frames: int, radius: float = 0.4, advance: float = 0.8):
    """Smooth test trajectory: slight arc + forward advance, returns (n, 4, 4)
    world->cam poses."""
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        yaw = 0.15 * np.sin(2 * np.pi * a)
        tx = radius * np.sin(2 * np.pi * a)
        tz = advance * a
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        C = np.array([tx, 0.0, tz])
        R = R_wc.T
        t = -R @ C
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses).astype(np.float32)


def loop_trajectory(
    n_frames: int,
    orbit: float = 0.6,
    loops: float = 1.0,
    center=(0.0, 0.0, 2.0),
    wobble: float = 0.08,
):
    """Closed-circuit trajectory with revisits (the fr2_desk analogue for
    loop-closure validation): the camera pans a full ``loops`` x 360 deg yaw
    while translating on a small orbit, so the final frames re-observe the
    first frames' scene. Returns (n, 4, 4) world->cam poses."""
    poses = []
    c = np.asarray(center, np.float64)
    for i in range(n_frames):
        a = loops * i / max(n_frames - 1, 1)
        th = 2 * np.pi * a
        yaw = th
        C = c + np.array(
            [
                orbit * np.sin(th),
                wobble * np.sin(3 * th),
                orbit * (np.cos(th) - 1.0),
            ]
        )
        cy, sy = np.cos(yaw), np.sin(yaw)
        # Camera looks along world +z rotated by yaw about y.
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R = R_wc.T
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        poses.append(T)
    return np.stack(poses).astype(np.float32)


class ClosedRoom(BoxRoom):
    """Box room with ALL six faces textured so a panning loop trajectory
    always sees structure (BoxRoom leaves the front/ceiling open)."""

    def __post_init__(self):
        self.textures = [
            checker_texture(self.tex_size, 24 + 8 * i, self.seed + i)
            for i in range(6)
        ]

    def render(self, K, T_cw, width: int, height: int, dist=None):
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        xn = np.stack([(us - cx) / fx, (vs - cy) / fy], axis=-1)
        if dist is not None:
            xn = _undistort_normalized_np(xn, dist)
        rays_c = np.concatenate(
            [xn, np.ones(xn.shape[:-1] + (1,), np.float64)], axis=-1
        )
        R = T_cw[:3, :3]
        t = T_cw[:3, 3]
        C = -R.T @ t
        dirs = rays_c @ R

        best_t = np.full((height, width), np.inf)
        gray = np.zeros((height, width), np.float32)
        planes = [
            (2, self.depth, (0, 1), self.textures[0]),  # back wall
            (2, -self.depth + 2.0, (0, 1), self.textures[5]),  # front wall
            (1, self.half_h, (0, 2), self.textures[1]),  # floor
            (1, -self.half_h, (0, 2), self.textures[4]),  # ceiling
            (0, -self.half_w, (2, 1), self.textures[2]),  # left wall
            (0, self.half_w, (2, 1), self.textures[3]),  # right wall
        ]
        lim = {0: self.half_w, 1: self.half_h}
        for axis, value, (ua, va), tex in planes:
            d = dirs[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (value - C[axis]) / d
            pt = C[None, None, :] + t_hit[..., None] * dirs
            ok = (t_hit > 0.05) & np.isfinite(t_hit)
            for ax2 in (0, 1, 2):
                if ax2 == axis:
                    continue
                if ax2 == 2:
                    ok &= (pt[..., 2] >= -self.depth + 2.0 - 1e-6) & (
                        pt[..., 2] <= self.depth + 1e-6
                    )
                else:
                    ok &= (pt[..., ax2] >= -lim[ax2] - 1e-6) & (
                        pt[..., ax2] <= lim[ax2] + 1e-6
                    )
            closer = ok & (t_hit < best_t)
            scale = self.tex_size / (
                2 * max(self.half_w, self.half_h, self.depth)
            )
            col = _tex_bilinear(
                tex, pt[..., ua] * scale, pt[..., va] * scale
            )
            gray = np.where(closer, col, gray)
            best_t = np.where(closer, t_hit, best_t)

        depth = np.where(np.isfinite(best_t), best_t, 0.0)
        return gray.astype(np.float32), depth.astype(np.float32)


def panel_texture(size: int = 1024, n_rows: int = 4, n_cols: int = 4,
                  seed: int = 0, noise: float = 1.5):
    """Low-texture wall: a few LARGE uniform panels with high-contrast
    straight borders (the fr3_structure_notexture analogue, BASELINE
    config 2). Panel interiors are near-constant (FAST finds nothing
    there); the only corners are the sparse panel crossings, while every
    border is a long straight edge — and the horizontal/vertical border
    pairs are exactly the coplanar intersecting line pairs that become
    LILs. Irregular panel boundaries + per-panel random intensities keep
    the few corners descriptively distinct (no grid aliasing). ``noise``
    adds faint jitter so the texture is not numerically degenerate."""
    rng = np.random.default_rng(seed)
    # Random interior boundaries on a 16-cell lattice; checkerboard-ish
    # alternation guarantees >= 40 gray-level contrast across every border.
    rbounds = np.r_[0, np.sort(
        rng.choice(np.arange(2, 15), n_rows - 1, replace=False)
    ) * size // 16, size]
    cbounds = np.r_[0, np.sort(
        rng.choice(np.arange(2, 15), n_cols - 1, replace=False)
    ) * size // 16, size]
    tex = np.empty((size, size), np.float32)
    for i in range(n_rows):
        for j in range(n_cols):
            base = (
                rng.uniform(55, 105) if (i + j) % 2 == 0
                else rng.uniform(155, 205)
            )
            tex[rbounds[i]: rbounds[i + 1], cbounds[j]: cbounds[j + 1]] = base
    tex += rng.normal(0.0, noise, tex.shape).astype(np.float32)
    return np.clip(tex, 0, 255).astype(np.float32)


class LowTextureRoom(BoxRoom):
    """Box room whose walls carry only large uniform panels: long straight
    high-contrast borders but only a handful of corners (the panel
    crossings) — the scene class where point-only tracking starves and the
    structural-line (LIL) path has to carry the solve (reference
    README.md:4 low-texture claim; BASELINE config 2
    fr3_structure_notexture)."""

    panels: int = 4

    def __post_init__(self):
        s = self.tex_size
        p = self.panels
        self.textures = [
            panel_texture(s, p, p, self.seed + i) for i in range(4)
        ]


def render_stereo_sequence(
    cam,
    n_frames: int = 30,
    seed: int = 0,
    room: BoxRoom | None = None,
    poses: np.ndarray | None = None,
):
    """Render a rectified stereo sequence: the right camera is the left one
    translated by +baseline along camera-x (X_r = X_l - (b, 0, 0), i.e.
    T_cw_right = Tb @ T_cw_left with Tb = trans(-b, 0, 0)). Returns
    (grays_l, grays_r, poses_w2c) — poses are the LEFT camera's."""
    room = room or BoxRoom(seed=seed)
    K = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=np.float64
    )
    if poses is None:
        poses = arc_trajectory(n_frames)
    Tb = np.eye(4)
    Tb[0, 3] = -cam.baseline
    gl, gr = [], []
    for T in poses:
        g0, _ = room.render(K, T.astype(np.float64), cam.width, cam.height)
        g1, _ = room.render(K, Tb @ T.astype(np.float64), cam.width, cam.height)
        gl.append(g0)
        gr.append(g1)
    return np.stack(gl), np.stack(gr), poses


def render_sequence(
    cam,
    n_frames: int = 30,
    seed: int = 0,
    room: BoxRoom | None = None,
    poses: np.ndarray | None = None,
    use_distortion: bool = False,
):
    """Render an RGB-D sequence. Returns (grays, depths, poses_w2c).

    ``use_distortion``: render through ``cam``'s k1/k2/p1/p2/k3 so the
    images are consistent with a distorted calibration (exercises the
    Frame::UndistortKeyPoints path end to end)."""
    room = room or BoxRoom(seed=seed)
    K = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=np.float64
    )
    dist = (
        (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3) if use_distortion else None
    )
    if poses is None:
        poses = arc_trajectory(n_frames)
    grays, depths = [], []
    for T in poses:
        g, d = room.render(
            K, T.astype(np.float64), cam.width, cam.height, dist=dist
        )
        grays.append(g)
        depths.append(d)
    return np.stack(grays), np.stack(depths), poses
