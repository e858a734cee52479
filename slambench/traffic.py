"""The one traffic generator: camera paths from a traffic file's parameters.

A traffic file (``slambench/traffic/<name>.json``) describes the camera's
motion as segments played one after another. Within a segment of ``frames``
frames, each coordinate is a sum of terms

    value(t) = amp * sin(2 pi * cycles * t / frames + phase_deg) + rate * t

over the frame index t. The coordinates are the camera centre ``x``, ``y``,
``z`` in metres (world frame, y down) and ``yaw`` (about world y), ``pitch``
(about the camera's x) and ``roll`` (about its z) in degrees, each added to
the segment's ``start``. At yaw = pitch = roll = 0 the camera looks along
world +z. ``replay`` says how a run longer than the sequence goes on without
a jump: ``cycle`` (a closed circuit: frame N follows frame N - 1 and is frame
0 again) or ``pingpong`` (forward, then backward, then forward).

Every seed gets the same path; the seed draws only the room's textures.
"""

from __future__ import annotations

import math

import numpy as np

from slambench.reference import true_poses

COORDS = ("x", "y", "z", "yaw", "pitch", "roll")


def _segment_values(seg: dict) -> np.ndarray:
    """(frames, 6) coordinates of one segment."""
    n = int(seg["frames"])
    t = np.arange(n, dtype=np.float64)
    start = seg.get("start", {})
    unknown = set(start) - set(COORDS)
    if unknown:
        raise ValueError(f"unknown coordinates {sorted(unknown)} in a segment's start")
    vals = np.tile(np.array([float(start.get(c, 0.0)) for c in COORDS]), (n, 1))
    for term in seg.get("terms", []):
        extra = set(term) - {"coord", "amp", "cycles", "phase_deg", "rate"}
        if extra or term.get("coord") not in COORDS:
            raise ValueError(f"malformed term {term}")
        k = COORDS.index(term["coord"])
        vals[:, k] += float(term.get("amp", 0.0)) * np.sin(
            2 * np.pi * float(term.get("cycles", 0.0)) * t / n
            + math.radians(float(term.get("phase_deg", 0.0))))
        vals[:, k] += float(term.get("rate", 0.0)) * t
    return vals


def path_coords(traffic: dict) -> np.ndarray:
    """(N, 6) x, y, z, yaw, pitch, roll of one pass of the sequence."""
    return np.concatenate([_segment_values(s) for s in traffic["segments"]])


def path_poses(traffic: dict, tf32: bool = False) -> np.ndarray:
    """(N, 4, 4) world-to-camera poses of one pass of the sequence (float64;
    with ``tf32``, the reference's control precision)."""
    rows = path_coords(traffic)
    return true_poses(rows[:, 3:], rows[:, :3], tf32=tf32)


def replay_index(traffic: dict, n_pass: int, i: int) -> int:
    """The sequence frame shown as the i-th frame of the stream."""
    mode = traffic["replay"]
    if mode == "cycle":
        return i % n_pass
    if mode == "pingpong":
        period = 2 * (n_pass - 1)
        k = i % period
        return k if k < n_pass else period - k
    raise ValueError(f"unknown replay {mode!r}")


def speeds(poses: np.ndarray, fps: float):
    """(mean translational speed m/s, mean angular speed deg/s) between
    consecutive frames, as the TUM benchmark's tools report them."""
    C = np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])
    trans = np.linalg.norm(np.diff(C, axis=0), axis=1)
    ang = []
    for a, b in zip(poses[:-1], poses[1:]):
        dR = b[:3, :3] @ a[:3, :3].T
        ang.append(math.degrees(math.acos(max(-1.0, min(1.0, (np.trace(dR) - 1) / 2)))))
    return float(trans.mean() * fps), float(np.mean(ang) * fps)
