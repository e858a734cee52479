"""Per-stage cost of the frame program on the card: the counterpart of
``scripts/profile_frame.py`` plus ``scripts/bench_frame_step.py``.

The stages, their inputs and shapes are the scripts' (``SlamConfig()``,
640x480, 1000 ORB features on 8 levels, a 4096-point local map built from
frame 0): ``build_pyramid``, ``fast_dual``, ``nms3x3``, ``detect_keypoints``,
``gaussian_blur``, ``extract_patches``, ``keypoint_angles``, ``brief_bits``,
``extract_orb (full)``, ``make_frame``, ``make_frame_lines``,
``track_against_points``, ``track_local_map_step``; then
``frame_step (real map)``: a ``SlamSystem`` warmed over 12 frames of
``render_sequence(seed=0)``, its snapshot rebuilt, and ``frame_step``
chained over the next 16 frames as the script's scan chains them (one
row, its numbers a frame; the profiler sees the chain's first 4 frames). Each warm-up frame that inserts a keyframe gets a row of its own
(``keyframe frame i``): one call through ``track_rgbd``, timed once, and
profiled once on a twin system fed the same frames.

Each row is ``utils.profile``'s: event ms, device ms, launches, busy share,
the K1 and K2 launches a call, peak memory, and the H100 floor of the
stage's counted operations and bytes. The table goes to stdout and to
``--out PATH``. Runs on the CUDA card unless ``--device cpu`` asks for
host times on the CPU.

Usage:
    python -m pslam_tpu_torch.apps.profile_frame [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

N_WARM = 12  # scripts/bench_frame_step.py
N_SCAN = 16
PROF_FRAMES = 4  # frames of the chain in the profiler window (~19,000 activities each)
REPS = 20  # scripts/profile_frame.py's R, a ceiling


def point_set_from_frame(fd, M: int, device):
    """The synthetic local map of ``scripts/profile_frame.py:124-146``: the
    first ``M`` features with depth at their camera-frame positions (frame
    0's camera is the world), with ``min_dist``/``max_dist``/``normal`` made
    from their distance."""
    from pslam_tpu_torch.pipeline.track_ops import PointSet

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    has = host(fd.depth > 0) & host(fd.valid)
    sel = np.flatnonzero(has)[:M]
    pos = np.zeros((M, 3), np.float32)
    pos[: len(sel)] = host(fd.xyz_c)[sel]
    desc = np.zeros((M, 32), np.uint8)
    desc[: len(sel)] = host(fd.desc)[sel]
    dist = np.linalg.norm(pos, axis=-1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PointSet(
        pos=t(pos), desc=t(desc),
        level=torch.zeros(M, dtype=torch.int32, device=device),
        angle=torch.zeros(M, dtype=torch.float32, device=device),
        min_dist=t((dist * 0.2).astype(np.float32)),
        max_dist=t((dist * 5.0 + 1.0).astype(np.float32)),
        normal=t(pos / np.maximum(dist[:, None], 1e-9).astype(np.float32)),
        valid=t(np.arange(M) < len(sel)),
    )


def frontend_inputs(cfg, device):
    """Frame 0 of ``render_sequence(seed=0)`` on ``device``: (img, depth)."""
    from pslam_tpu_torch.io.synthetic import render_sequence

    grays, depths, _ = render_sequence(cfg.camera, n_frames=2, seed=0)
    return (torch.from_numpy(grays[0]).to(device), torch.from_numpy(depths[0]).to(device))


def frontend_rows(cfg, img, depth, device, reps: int, stages=None) -> list[dict]:
    """The frontend and tracking stages of ``scripts/profile_frame.py``, in
    its order (all of them, or the names in ``stages``)."""
    from pslam_tpu_torch.ops import orb as orb_mod
    from pslam_tpu_torch.ops.fast import fast_score, fast_score_dual, nms3x3
    from pslam_tpu_torch.ops.image import build_pyramid, gaussian_blur
    from pslam_tpu_torch.ops.orb import (PATCH, detect_keypoints, extract_orb,
                                         extract_patches, keypoint_angles)
    from pslam_tpu_torch.pipeline.frame_ops import make_frame, make_frame_lines
    from pslam_tpu_torch.pipeline.track_ops import track_against_points, track_local_map_step
    from pslam_tpu_torch.utils import profile as P

    cam, orb = cfg.camera, cfg.orb
    h, w = img.shape
    stack = build_pyramid(img, orb.levels, orb.scale)[0]
    canvas = stack.numel()
    feats = extract_orb(img, orb)
    blurred = gaussian_blur(stack)
    bpatch = extract_patches(blurred, feats.uv_lvl, feats.level)
    n_kp = feats.valid.shape[0]
    pyr = P.pyramid_ops(h, w, orb.levels, orb.scale)
    detect = canvas * (P.FAST_DUAL_PIXEL_OPS + 1 + P.NMS_PIXEL_OPS)
    orb_ops = (pyr + detect + canvas * P.BLUR_PIXEL_OPS + P.angle_ops(n_kp, PATCH)
               + n_kp * P.BRIEF_KEYPOINT_OPS)

    fd0 = make_frame(img, depth, cam, orb)
    M = cfg.caps.local_points
    pts = point_set_from_frame(fd0, M, device)
    T0 = torch.eye(4, dtype=torch.float32, device=device)
    t_cfg = cfg.tracking
    n_pts, n_feat = int(pts.valid.sum()), int(fd0.valid.sum())

    def track_count(res):
        return P.track_ops(n_pts, n_feat, int(res.n_matches))

    res1 = track_against_points(cam, T0, pts, fd0, t_cfg.motion_match_radius, orb.scale,
                                orb.levels)
    no_prior = torch.full((M,), -1, dtype=torch.int64, device=device)
    res2 = track_local_map_step(cam, T0, pts, fd0, no_prior, t_cfg.local_match_radius,
                                orb.scale, orb.levels)

    table = [
        ("build_pyramid", lambda x: build_pyramid(x, orb.levels, orb.scale)[0], (img,), pyr),
        ("fast_dual", lambda s: fast_score_dual(s, orb.th_fast_hi, orb.th_fast_lo), (stack,),
         canvas * P.FAST_DUAL_PIXEL_OPS),
        ("nms3x3", lambda s: nms3x3(fast_score(s, orb.th_fast_lo)[1]), (stack,),
         canvas * (P.FAST_PIXEL_OPS + P.NMS_PIXEL_OPS)),
        # FAST, the masked score and NMS; the top-k selection is not counted.
        ("detect_keypoints", lambda s: detect_keypoints(s, orb, h, w), (stack,), detect),
        ("gaussian_blur", gaussian_blur, (stack,), canvas * P.BLUR_PIXEL_OPS),
        ("extract_patches", extract_patches, (blurred, feats.uv_lvl, feats.level), 0),
        ("keypoint_angles", keypoint_angles, (bpatch,), P.angle_ops(n_kp, PATCH)),
        ("brief_bits", orb_mod._brief_bits, (bpatch, feats.angle), n_kp * P.BRIEF_KEYPOINT_OPS),
        # The sum of the stages above (the depth sampling of make_frame is
        # not counted).
        ("extract_orb (full)", lambda x: extract_orb(x, orb), (img,), orb_ops),
        ("make_frame", lambda i, d: make_frame(i, d, cam, orb), (img, depth), orb_ops),
        ("make_frame_lines", lambda i, d: make_frame_lines(i, d, cam, cfg.lines),
         (img, depth), None),
        ("track_against_points", lambda T, p, f: track_against_points(
            cam, T, p, f, t_cfg.motion_match_radius, orb.scale, orb.levels),
         (T0, pts, fd0), track_count(res1)),
        ("track_local_map_step", lambda T, p, f, prior: track_local_map_step(
            cam, T, p, f, prior, t_cfg.local_match_radius, orb.scale, orb.levels),
         (T0, pts, fd0, no_prior), track_count(res2)),
    ]
    return [P.stage_row(name, fn, *args, ops=ops, reps=reps, device=device)
            for name, fn, args, ops in table if stages is None or name in stages]


def frame_step_rows(cfg, device, n_warm: int = N_WARM, n_scan: int = N_SCAN) -> list[dict]:
    """``scripts/bench_frame_step.py`` on the port: the keyframe frames of
    the warm-up (one row each), then ``frame_step`` chained over ``n_scan``
    frames against the warmed map (one row, a frame)."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline import frame_step as fstep
    from pslam_tpu_torch.pipeline.system import SlamSystem
    from pslam_tpu_torch.utils import profile as P

    grays, depths, _ = render_sequence(cfg.camera, n_frames=n_warm + n_scan, seed=0)
    # On the card each warm-up frame is timed on one system and profiled on
    # its twin: a tracked frame cannot run twice on one map. The two take
    # the same decisions on every frame (held below); the local BA graph
    # counters are no decision: the twins share one process's graphs, so
    # the second to meet a problem shape captures where the first ran eager.
    slam = SlamSystem(cfg, device=device)
    twin = SlamSystem(cfg, device=device) if device.type == "cuda" else None

    def decisions(s):
        return s.state, {k: v for k, v in s.stats.items() if not k.startswith("ba_graph_")}

    rows = []
    for i in range(n_warm):
        n_kf = slam.stats["kf_inserted"]
        row = P.stage_row(f"keyframe frame {i}", slam.track_rgbd, grays[i], depths[i], i / 30.0,
                          reps=1, warmup=0, prof_reps=1, device=device,
                          profile_fn=twin.track_rgbd if twin else None)
        if twin and decisions(twin) != decisions(slam):
            raise RuntimeError(f"the warm-up's twin systems part at frame {i}")
        if slam.stats["kf_inserted"] > n_kf:
            rows.append(dict(row, note="initializes the map" if i == 0 else "inserts a keyframe"))
    slam._rebuild_snapshot()
    snap, acc0 = slam._snap, slam._acc
    gd = torch.from_numpy(np.ascontiguousarray(grays[n_warm:])).to(device)
    dd = torch.from_numpy(np.ascontiguousarray(depths[n_warm:])).to(device)
    T0 = torch.from_numpy(slam.last.T_cw).to(device)
    radius = cfg.tracking.motion_match_radius

    def scan(gd, dd, T0, snap):
        T, vel, acc = T0, torch.eye(4, dtype=torch.float32, device=device), acc0
        inl = []
        for g, d in zip(gd, dd):
            out = fstep.frame_step(cfg, g, d, T, vel, radius, snap, acc)
            T, vel, acc = out.T_cw, out.vel, out.acc
            inl.append(out.summary[fstep.S_INLIERS])
        return torch.stack(inl)

    # Timed over the whole chain, profiled over its first frames: the trace
    # of 16 frames would hold ~300,000 activities (see utils/profile.py).
    k = min(PROF_FRAMES, n_scan)
    row = P.time_stage(scan, gd, dd, T0, snap, reps=1, device=device, warmup=1,
                       prof_reps=1, profile_fn=lambda g, d, T, s: scan(g[:k], d[:k], T, s))
    per_frame = dict(row)
    for key, n in (("event_ms", n_scan), ("host_ms", n_scan), ("k1", n_scan), ("k2", n_scan),
                   ("device_ms", k), ("launches", k)):
        if isinstance(row[key], float):
            per_frame[key] = row[key] / n
    if isinstance(per_frame["device_ms"], float):
        per_frame["busy"] = per_frame["device_ms"] / per_frame["event_ms"]
    per_frame["nbytes"] = row["nbytes"] // n_scan
    per_frame.update(P.bound(None, per_frame["nbytes"], per_frame["event_ms"]))
    rows.append(dict(name="frame_step (real map)", **per_frame, frames=n_scan))
    return rows


def run(device: str = "cuda", cfg=None, reps: int = REPS, n_warm: int = N_WARM,
        n_scan: int = N_SCAN) -> list[dict]:
    """Every stage's row, then the real-map rows. ``cfg`` defaults to
    ``SlamConfig()``; smaller configs and counts are for tests on the CPU."""
    from pslam_tpu_torch.utils import profile as P
    from pslam_tpu_torch.utils.config import SlamConfig

    dev = P.cuda_device(device)
    cfg = cfg or SlamConfig()
    img, depth = frontend_inputs(cfg, dev)
    rows = frontend_rows(cfg, img, depth, dev, reps)
    return rows + frame_step_rows(cfg, dev, n_warm, n_scan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write the markdown table to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure (default: the CUDA card)")
    args = ap.parse_args(argv)
    from pslam_tpu_torch.utils import profile as P

    rows = run(args.device)
    text = P.table(rows, "Frame program, a stage a row (pslam_tpu_torch.apps.profile_frame)",
                   args.device)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
