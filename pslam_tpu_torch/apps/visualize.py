"""Headless visualization / map introspection (port of
``pslam_tpu/apps/visualize.py``; MapDrawer + FrameDrawer replacement,
reference src/MapDrawer.cc:44-344, src/FrameDrawer.cc:1-332).

Artifacts (all file outputs, no GL / Pangolin):

- ``draw_frame_overlay``: per-frame PNG — tracked points (inlier/outlier),
  line segments, LIL fans drawn over the grayscale frame.
- ``dump_map_ply``: map points + line segments as an ASCII PLY any point-
  cloud viewer opens (the MapDrawer point/line draw, headless).
- ``dump_map_npz``: raw SoA arrays (positions, validity, observation
  counts) for programmatic inspection.
- ``plot_trajectory``: top-down (x-z) trajectory figure, estimate vs
  optional ground truth + keyframe marks.
- ``render_run_artifacts``: one call that writes the map dump + trajectory
  plot for a finished run.

Colors are the Okabe-Ito colorblind-safe palette; identity is additionally
encoded by line style/marker so no information is color-alone.

PIL and matplotlib are imported inside the two functions that draw; the map
dumps need neither and run wherever numpy does.
"""

from __future__ import annotations

import os

import numpy as np

# Okabe-Ito (Wong 2011): colorblind-safe, high mutual CVD separation.
C_EST = "#0072B2"  # blue — estimated trajectory (solid)
C_GT = "#999999"  # gray — ground truth (dashed)
C_KF = "#E69F00"  # orange — keyframes (markers)
C_PT_IN = (60, 200, 80)  # overlay BGR-ish greens/reds for raster drawing
C_PT_OUT = (220, 60, 60)
C_LINE = (70, 130, 240)
C_LIL = (240, 180, 40)


# ---------------------------------------------------------------------------
# Frame overlay (FrameDrawer)
# ---------------------------------------------------------------------------


def _put_disk(img, x, y, r, color):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    if not (0 <= x < w and 0 <= y < h):
        return
    ys, xs = np.mgrid[max(0, y - r) : min(h, y + r + 1),
                      max(0, x - r) : min(w, x + r + 1)]
    m = (xs - x) ** 2 + (ys - y) ** 2 <= r * r
    img[ys[m], xs[m]] = color


def _put_segment(img, p0, p1, color, thickness=1):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    for t in np.linspace(0.0, 1.0, n + 1):
        x = p0[0] + t * (p1[0] - p0[0])
        y = p0[1] + t * (p1[1] - p0[1])
        _put_disk(img, x, y, thickness, color)


def draw_frame_overlay(gray, hf, path: str, inlier_mask=None):
    """Write a PNG of the frame with tracked features drawn on it.

    gray: (H, W) float [0..255]; hf: a HostFrame (pipeline/system.py) after
    tracking — points with a map association draw green (red when
    ``inlier_mask`` marks them outliers), line features blue, LIL fans
    orange with their intersection point emphasized.
    """
    from PIL import Image

    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], axis=-1)

    matched = hf.feat_mp >= 0
    for i in np.flatnonzero(hf.valid):
        u, v = hf.uv[i]
        if matched[i]:
            ok = True if inlier_mask is None else bool(inlier_mask[i])
            _put_disk(img, u, v, 2, C_PT_IN if ok else C_PT_OUT)
        else:
            _put_disk(img, u, v, 1, (140, 140, 140))

    if getattr(hf, "line_valid", None) is not None:
        for i in np.flatnonzero(hf.line_valid):
            _put_segment(img, hf.line_sp[i], hf.line_ep[i], C_LINE, 1)
        if getattr(hf, "lil", None) is not None:
            lil = hf.lil
            lv = np.asarray(lil.valid)
            c2 = np.asarray(lil.cross2d)
            for i in np.flatnonzero(lv):
                _put_disk(img, c2[i, 0], c2[i, 1], 3, C_LIL)

    Image.fromarray(img).save(path)
    return path


# ---------------------------------------------------------------------------
# Map dumps (MapDrawer)
# ---------------------------------------------------------------------------


def dump_map_ply(m, path: str):
    """ASCII PLY: map points as vertices, map lines as edges (2-vertex
    elements). InsectLine structure points are included as vertices flagged
    by a scalar property."""
    pts = m.mp_pos[m.mp_valid]
    ml = m.ml_pos[m.ml_valid]
    il = m.il_state[m.il_valid].reshape(-1, 5, 3) if m.il_valid.any() else (
        np.zeros((0, 5, 3), np.float32)
    )
    il_pts = il.reshape(-1, 3)
    n_v = len(pts) + 2 * len(ml) + len(il_pts)
    n_e = len(ml)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n_v}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar kind\n"
            f"element edge {n_e}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 0\n")
        base = len(pts)
        for seg in ml:
            f.write(f"{seg[0]:.4f} {seg[1]:.4f} {seg[2]:.4f} 1\n")
            f.write(f"{seg[3]:.4f} {seg[4]:.4f} {seg[5]:.4f} 1\n")
        for p in il_pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 2\n")
        for i in range(n_e):
            f.write(f"{base + 2 * i} {base + 2 * i + 1}\n")
    return path


def dump_map_npz(m, path: str):
    """Raw SoA arrays for programmatic inspection."""
    np.savez_compressed(
        path,
        mp_pos=m.mp_pos[m.mp_valid],
        mp_n_obs=m.mp_n_obs[m.mp_valid],
        ml_pos=m.ml_pos[m.ml_valid],
        ml_n_obs=m.ml_n_obs[m.ml_valid],
        il_state=m.il_state[m.il_valid],
        il_plane=m.il_plane[m.il_valid],
        kf_pose=m.kf_pose[: m.n_kf][m.kf_valid[: m.n_kf]],
        kf_timestamp=m.kf_timestamp[: m.n_kf][m.kf_valid[: m.n_kf]],
    )
    return path


# ---------------------------------------------------------------------------
# Trajectory plot
# ---------------------------------------------------------------------------


def plot_trajectory(est_poses, path: str, gt_poses=None, kf_poses=None,
                    title: str = "trajectory (top-down)"):
    """Top-down x–z plot of (N, 4, 4) world->cam poses. One axis, recessive
    grid, direct labels (no legend box needed beyond the two labeled
    series)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pslam_tpu_torch.utils.metrics import trajectory_positions

    est = trajectory_positions(est_poses)
    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_poses is not None:
        gt = trajectory_positions(gt_poses)
        ax.plot(gt[:, 0], gt[:, 2], ls="--", lw=1.5, color=C_GT,
                label="ground truth")
    ax.plot(est[:, 0], est[:, 2], ls="-", lw=2.0, color=C_EST,
            label="estimate")
    if kf_poses is not None and len(kf_poses):
        kf = trajectory_positions(kf_poses)
        ax.scatter(kf[:, 0], kf[:, 2], s=18, marker="s", color=C_KF,
                   label="keyframes", zorder=3)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title(title)
    ax.set_aspect("equal")
    ax.grid(True, lw=0.4, alpha=0.3)
    ax.legend(frameon=False, loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def render_run_artifacts(system, outdir: str, gt_poses=None):
    """Write map PLY + NPZ + trajectory PNG for a finished SlamSystem run."""
    os.makedirs(outdir, exist_ok=True)
    m = system.map
    out = {
        "ply": dump_map_ply(m, os.path.join(outdir, "map.ply")),
        "npz": dump_map_npz(m, os.path.join(outdir, "map.npz")),
    }
    est = system.poses
    kf = m.kf_pose[: m.n_kf][m.kf_valid[: m.n_kf]]
    out["trajectory"] = plot_trajectory(
        est, os.path.join(outdir, "trajectory.png"), gt_poses=gt_poses,
        kf_poses=kf,
    )
    return out
