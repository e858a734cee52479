"""The plain reference the comparison holds the program's output against.

NumPy only: it imports neither torch nor anything of the program. It knows
what the scene is, not what the program made of it: the room's six faces,
the camera model of the configuration file and the true poses of the
traffic. From those it works out, in float64:

- ``true_depth``: the depth the sensor gives at a pixel (the ray through the
  pixel centre, undistorted as the renderer does it, cast against the room,
  rounded to the sensor's depth step);
- ``octave_coords`` and ``raw_pixels``: where in the raw image the program
  found a keyframe feature and read its depth, recovered from the feature's
  undistorted coordinates and octave (the program keeps no raw ones);
- ``descriptors``: the rBRIEF descriptor of a keypoint, from the image;
- ``surface_distance``: how far a world point lies from the room's faces;
- ``orthonormality``: how far a pose's rotation is from a rotation, and
  ``chained_poses``: the true poses composed frame to frame, as a tracker
  chains them.

``tf32=True`` computes the same in the nearest precision below the
configuration's (float32 with TF32 off): float32, with the inputs of every
matrix product rounded to TF32's 10-bit mantissa, as a TF32 tensor core
takes them. That is the control of the comparison.
"""

from __future__ import annotations

import numpy as np


def tf32_round(x) -> np.ndarray:
    """Round float32 values to TF32 (1 sign, 8 exponent, 10 mantissa bits),
    to nearest, ties to even."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    b = a.view(np.uint32).astype(np.uint64)
    lsb = (b >> 13) & 1
    b = ((b + 0xFFF + lsb) >> 13) << 13
    return b.astype(np.uint32).view(np.float32).reshape(a.shape)


def matmul(a, b, tf32: bool = False):
    """``a @ b`` in float64, or with TF32 inputs and float32 sums."""
    if not tf32:
        return np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    return (tf32_round(a).astype(np.float32) @ tf32_round(b).astype(np.float32)).astype(np.float32)


def distort(x, y, dist):
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def undistort(x0, y0, dist, iters: int = 8):
    x, y = x0, y0
    for _ in range(iters):
        xd, yd = distort(x, y, dist)
        x, y = x - (xd - x0), y - (yd - y0)
    return x, y


def room_faces(room: dict):
    """(axis, value) of the six faces and the (lo, hi) bounds on each axis of
    the traffic file's ``room``."""
    d, hw, hh = float(room["depth"]), float(room["half_w"]), float(room["half_h"])
    bounds = ((-hw, hw), (-hh, hh), (2.0 - d, d))
    faces = [(ax, v) for ax in range(3) for v in bounds[ax]]
    return faces, bounds


def true_depth(room: dict, cam: dict, T_cw, pixels, depth_map_factor: float,
               tf32: bool = False) -> np.ndarray:
    """(N,) sensor depth at integer raw ``pixels`` (N, 2) [u, v] of a camera
    at ``T_cw`` (4, 4)."""
    dt = np.float32 if tf32 else np.float64
    px = np.asarray(pixels, dt)
    x0 = (px[:, 0] - dt(cam["cx"])) / dt(cam["fx"])
    y0 = (px[:, 1] - dt(cam["cy"])) / dt(cam["fy"])
    dist = tuple(dt(cam[k]) for k in ("k1", "k2", "p1", "p2", "k3"))
    x, y = undistort(x0, y0, dist)
    rays = np.stack([x, y, np.ones_like(x)], axis=1)
    T = np.asarray(T_cw, dt)
    R, t = T[:3, :3], T[:3, 3]
    dirs = matmul(rays, R, tf32).astype(dt)
    C = -matmul(R.T, t[:, None], tf32)[:, 0].astype(dt)
    faces, bounds = room_faces(room)
    best = np.full(len(px), np.inf, dt)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis, value in faces:
            t_hit = (dt(value) - C[axis]) / dirs[:, axis]
            pt = C[None, :] + t_hit[:, None] * dirs
            ok = (t_hit > 0.05) & np.isfinite(t_hit)
            for ax2 in range(3):
                if ax2 != axis:
                    lo, hi = bounds[ax2]
                    ok &= (pt[:, ax2] >= lo - 1e-6) & (pt[:, ax2] <= hi + 1e-6)
            best = np.where(ok & (t_hit < best), t_hit, best)
    z = np.where(np.isfinite(best), best, 0.0)
    return np.round(z * depth_map_factor) / depth_map_factor


def octave_coords(uv_undist, level, cam: dict, scale: float) -> np.ndarray:
    """(N, 2) float32 integer coordinates [x, y] on their octave of features
    at undistorted level-0 ``uv_undist``: the lens distortion put back, then
    divided by the octave's scale and rounded (the program detects at
    integer octave coordinates)."""
    uv = np.asarray(uv_undist, np.float64)
    x = (uv[:, 0] - cam["cx"]) / cam["fx"]
    y = (uv[:, 1] - cam["cy"]) / cam["fy"]
    xd, yd = distort(x, y, tuple(cam[k] for k in ("k1", "k2", "p1", "p2", "k3")))
    raw = np.stack([xd * cam["fx"] + cam["cx"], yd * cam["fy"] + cam["cy"]], axis=1)
    lvl_scale = np.array([scale**l for l in range(int(level.max()) + 1)], np.float32)
    s = lvl_scale[np.asarray(level, np.int64)]
    return np.round(raw / s[:, None].astype(np.float64)).astype(np.float32)


def raw_pixels(on_level, level, scale: float) -> np.ndarray:
    """(N, 2) int raw pixels at which the program read the depth of
    features at ``on_level`` coordinates of octave ``level``: scaled by
    float32(scale**level) and rounded."""
    lvl_scale = np.array([scale**l for l in range(int(np.max(level)) + 1)], np.float32)
    s = lvl_scale[np.asarray(level, np.int64)]
    return np.round(on_level * s[:, None]).astype(np.int64)


def surface_distance(room: dict, points) -> np.ndarray:
    """(N,) distance of world points from the nearest face of the room
    (inside or outside it)."""
    p = np.asarray(points, np.float64)
    _, bounds = room_faces(room)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    inside_gap = np.minimum(p - lo, hi - p)
    inside = (inside_gap >= 0).all(axis=1)
    outside = np.linalg.norm(np.maximum(0.0, np.maximum(lo - p, p - hi)), axis=1)
    return np.where(inside, inside_gap.min(axis=1), outside)


def orthonormality(poses) -> np.ndarray:
    """(N,) largest entry of |R R^T - I| of each (4, 4) pose."""
    R = np.asarray(poses, np.float64)[:, :3, :3]
    return np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max(axis=(1, 2))


def chained_poses(poses, tf32: bool = False) -> np.ndarray:
    """Each pose as a tracker reaches it: the first pose, then each frame's
    relative motion (float64) composed onto the previous result."""
    out = [np.asarray(poses[0], np.float32 if tf32 else np.float64)]
    for a, b in zip(poses[:-1], poses[1:]):
        out.append(matmul(np.asarray(b) @ np.linalg.inv(a), out[-1], tf32))
    return np.stack(out)


def _rot(axis: int, deg: float, tf32: bool):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    M = np.eye(3)
    M[i, i], M[i, j], M[j, i], M[j, j] = c, -s, s, c
    if axis == 1:  # the y rotation's sign convention: [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        M[i, j], M[j, i] = s, -s
    return M.astype(np.float32) if tf32 else M


def true_poses(angles_deg, centres, tf32: bool = False) -> np.ndarray:
    """(N, 4, 4) world-to-camera poses from (N, 3) yaw, pitch, roll in
    degrees and (N, 3) camera centres: R_wc = Ry(yaw) Rx(pitch) Rz(roll)."""
    out = np.zeros((len(centres), 4, 4), np.float32 if tf32 else np.float64)
    for n, ((yaw, pitch, roll), C) in enumerate(zip(angles_deg, centres)):
        R_wc = matmul(matmul(_rot(1, yaw, tf32), _rot(0, pitch, tf32), tf32),
                      _rot(2, roll, tf32), tf32)
        out[n, :3, :3] = R_wc.T
        out[n, :3, 3] = -matmul(R_wc.T, np.asarray(C)[:, None], tf32)[:, 0]
        out[n, 3, 3] = 1.0
    return out


# ---------------------------------------------------------------------------
# rBRIEF descriptors: a frozen numpy copy of the port's plain routines
# (ops/image.py: the resize matrices, the reflect-101 Gaussian blur with its
# tap order; ops/orb.py: the patch, the intensity-centroid angle, the seeded
# test pattern at 32 rotations, bf16-rounded samples).

HALF_PATCH = 15
PATCH = 32
N_ANGLE_BINS = 32


def _resize_matrix_1d(n_in: int, n_out: int) -> np.ndarray:
    out = np.zeros((n_out, n_in), np.float32)
    s = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * s - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        out[i, min(max(x0, 0), n_in - 1)] += 1.0 - f
        out[i, min(max(x0 + 1, 0), n_in - 1)] += f
    return out


def pyramid(img, levels: int, scale: float, tf32: bool = False) -> np.ndarray:
    """(L, H, W) float32 canvas, level l in its top-left corner, each level
    resized from the one before it (bilinear, half-pixel centres)."""
    h, w = img.shape
    shapes = [(int(round(h / scale**l)), int(round(w / scale**l))) for l in range(levels)]
    R, C = np.eye(h, dtype=np.float32), np.eye(w, dtype=np.float32)
    out = np.zeros((levels, h, w), np.float32)
    prev = (h, w)
    for l, (hl, wl) in enumerate(shapes):
        if l > 0:
            R = _resize_matrix_1d(prev[0], hl) @ R
            C = _resize_matrix_1d(prev[1], wl) @ C
        prev = (hl, wl)
        lv = matmul(matmul(R, img, tf32).astype(np.float32), C.T, tf32)
        out[l, :hl, :wl] = lv.astype(np.float32)
    return out


def _gauss7() -> np.ndarray:
    x = np.arange(7) - 3.0
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(stack) -> np.ndarray:
    """7-tap sigma-2 Gaussian, rows then columns, reflect-101 borders; tap 1
    a rounded product, then each other tap one float32 rounding of an exact
    multiply-add."""
    k = _gauss7()

    def taps(get):
        acc = (np.float32(k[1]) * get(1)).astype(np.float32)
        for i in [0, 2, 3, 4, 5, 6]:
            acc = (get(i).astype(np.float64) * float(k[i]) + acc.astype(np.float64)).astype(
                np.float32)
        return acc

    H, W = stack.shape[-2:]
    x = np.pad(stack, ((0, 0), (3, 3), (0, 0)), mode="reflect")
    y = taps(lambda i: x[:, i:i + H, :])
    y = np.pad(y, ((0, 0), (0, 0), (3, 3)), mode="reflect")
    return taps(lambda i: y[:, :, i:i + W])


def _bf16(x) -> np.ndarray:
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def _pattern_samples() -> np.ndarray:
    """(32, 512) flattened patch index of each rotated test point."""
    rng = np.random.default_rng(1234)
    pts = rng.normal(0.0, (2 * HALF_PATCH + 1) / 5.0, size=(256, 4))
    r_max = float(HALF_PATCH - 2)
    for cols in ((0, 1), (2, 3)):
        xy = pts[:, cols]
        r = np.linalg.norm(xy, axis=1, keepdims=True)
        pts[:, cols] = np.where(r > r_max, xy * (r_max / r), xy)
    pat = np.round(pts).astype(np.int32).astype(np.float64)
    p = np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)
    out = np.zeros((N_ANGLE_BINS, 512), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        rx = p[:, 0] * np.cos(th) - p[:, 1] * np.sin(th)
        ry = p[:, 0] * np.sin(th) + p[:, 1] * np.cos(th)
        xi = np.clip(np.round(rx).astype(np.int64) + PATCH // 2, 0, PATCH - 1)
        yi = np.clip(np.round(ry).astype(np.int64) + PATCH // 2, 0, PATCH - 1)
        out[b] = yi * PATCH + xi
    return out


def _moments() -> np.ndarray:
    c = PATCH // 2
    ys, xs = np.mgrid[0:PATCH, 0:PATCH]
    mask = ((xs - c) ** 2 + (ys - c) ** 2) <= HALF_PATCH**2 + 1
    return np.stack([((xs - c) * mask).reshape(-1), ((ys - c) * mask).reshape(-1)],
                    axis=1).astype(np.float32)


def descriptors(img, on_level, level, levels: int, scale: float, tf32: bool = False):
    """(N, 32) uint8 rBRIEF descriptors of keypoints at integer octave
    coordinates ``on_level`` (N, 2) [x, y] of octave ``level`` in the 8-bit
    image ``img``."""
    canvas = blur(pyramid(np.asarray(img, np.float32), levels, scale, tf32))
    L, h, w = canvas.shape
    half = PATCH // 2
    x0 = np.clip(on_level[:, 0].astype(np.int64) - half, 0, w - PATCH)
    y0 = np.clip(on_level[:, 1].astype(np.int64) - half, 0, h - PATCH)
    ar = np.arange(PATCH)
    patches = canvas[np.asarray(level, np.int64)[:, None, None], (y0[:, None] + ar)[:, :, None],
                     (x0[:, None] + ar)[:, None, :]]
    m = matmul(patches.reshape(len(patches), -1), _moments(), tf32).astype(np.float32)
    angle = np.arctan2(m[:, 1], m[:, 0]).astype(np.float32)
    two_pi = np.float32(2.0 * np.pi)
    bin_f = np.remainder(angle, two_pi) * np.float32(N_ANGLE_BINS / (2.0 * np.pi))
    kp_bin = np.remainder(np.round(bin_f).astype(np.int64), N_ANGLE_BINS)
    flat = _bf16(patches.reshape(len(patches), -1))
    s = np.take_along_axis(flat, _pattern_samples()[kp_bin], axis=1)
    bits = (s[:, :256] < s[:, 256:]).astype(np.uint8).reshape(-1, 32, 8)
    return (bits << np.arange(8, dtype=np.uint8)).sum(axis=2).astype(np.uint8)


def hamming(a, b) -> np.ndarray:
    """(N,) bits that differ between two (N, 32) uint8 descriptor sets."""
    return np.unpackbits(np.bitwise_xor(a, b), axis=1).sum(axis=1)
