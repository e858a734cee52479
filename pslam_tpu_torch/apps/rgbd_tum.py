"""RGB-D TUM/ICL app (port of ``pslam_tpu/apps/rgbd_tum.py``).

Counterpart of the reference's only built executable
(Examples/RGB-D/rgbd_tum.cc:36-176): load an association file, drive the
SLAM system frame by frame, print median/mean tracking time, and save the
frame + keyframe trajectories in TUM format. Runs on the CUDA card unless
``--device cpu`` asks for the CPU.

Usage:
    python -m pslam_tpu_torch.apps.rgbd_tum <settings.yaml> <seq_dir> <assoc_file>
        [out_name] [--no-lines] [--no-loop] [--max-frames N] [--kitti]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("settings", help="reference-style YAML settings file")
    ap.add_argument("seq_dir", help="dataset root (contains rgb/, depth/)")
    ap.add_argument("assoc", help="association file")
    ap.add_argument("name", nargs="?", default="out",
                    help="trajectory files are f_<name>.txt / kf_<name>.txt "
                         "(rgbd_tum.cc:152-166)")
    ap.add_argument("--no-lines", action="store_true",
                    help="points-only tracking (BASELINE config 1)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closing (matches the shipped "
                         "reference, LoopClosing.cc:61)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kitti", action="store_true",
                    help="also save KITTI-format trajectory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to track on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from pslam_tpu_torch.io.tum import TumRgbdDataset, config_from_settings, load_settings_yaml
    from pslam_tpu_torch.pipeline.system import SlamSystem
    from pslam_tpu_torch.utils.trace import StageTimers

    settings = load_settings_yaml(args.settings)
    cfg = config_from_settings(settings)
    if args.no_lines:
        cfg = dataclasses.replace(cfg, use_lines=False)
    if args.no_loop:
        cfg = dataclasses.replace(cfg, use_loop_closing=False)

    ds = TumRgbdDataset(
        args.seq_dir, args.assoc,
        depth_map_factor=float(settings.get("DepthMapFactor", 5000.0)),
    )
    n = len(ds)
    if args.max_frames:
        n = min(n, args.max_frames)
    print(f"frames: {n}  settings: {args.settings}  device: {args.device}", file=sys.stderr)

    slam = SlamSystem(cfg, device=args.device)
    timers = StageTimers()
    track_times = np.zeros(n, np.float64)
    for i in range(n):
        with timers.stage("io"):
            gray, depth, ts = ds[i]
        t0 = time.perf_counter()
        with timers.stage("track"):
            slam.track_rgbd(gray, depth, ts)
        track_times[i] = time.perf_counter() - t0
        if (i + 1) % 50 == 0:
            print(
                f"[{i + 1}/{n}] state={slam.state.name} "
                f"kfs={slam.map.n_kf} mean_ms={track_times[:i + 1].mean() * 1e3:.1f}",
                file=sys.stderr,
            )

    # Exit summary (rgbd_tum.cc:137-146).
    ts_sorted = np.sort(track_times)
    print("-------", file=sys.stderr)
    print(f"median tracking time: {ts_sorted[n // 2]:.4f}", file=sys.stderr)
    print(f"mean tracking time: {track_times.mean():.4f}", file=sys.stderr)
    print(timers.report(), file=sys.stderr)

    slam.save_trajectory_tum(f"f_{args.name}.txt")
    slam.save_keyframe_trajectory_tum(f"kf_{args.name}.txt")
    if args.kitti:
        slam.save_trajectory_kitti(f"kitti_{args.name}.txt")
    print(f"saved f_{args.name}.txt kf_{args.name}.txt", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
