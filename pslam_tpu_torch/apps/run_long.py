"""Long-sequence run: the full config (lines, LILs, BoW, loop closing) over
a double-loop circuit, default 500 frames, within the fixed capacities
(keyframe culling, slot recycling and capacity eviction keep it bounded).
The counterpart of ``scripts/run_long.py``: the same scene, the same
progress line every 100 frames, the same ``DONE`` line and the same 10 cm
ATE bar. ``--pipelined`` drives ``track_rgbd_pipelined`` + ``finish()``.
Runs on the CUDA card unless ``--device cpu`` asks for the CPU.

Usage:
    python -m pslam_tpu_torch.apps.run_long [n_frames] [--pipelined] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

ATE_BAR_M = 0.10  # scripts/run_long.py:77


def run(n: int = 500, pipelined: bool = False, device: str = "cuda") -> dict:
    """Render and track ``n`` frames; print the progress and ``DONE`` lines
    and return the evaluation row."""
    from pslam_tpu_torch.apps.evaluate import evaluate, require_device
    from pslam_tpu_torch.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
    from pslam_tpu_torch.utils.config import SlamConfig

    require_device(device)
    cfg = SlamConfig()
    print(f"rendering {n}-frame double-loop sequence...", flush=True)
    # Two loops in a closed 6 x 4 x 5 m room.
    grays, depths, poses_gt = render_sequence(
        cfg.camera, poses=loop_trajectory(n, loops=2.0),
        room=ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=9))

    def progress(i, slam, secs):
        if (i + 1) % 100 == 0:
            m = slam.map
            loops = slam.loop_closer.stats["closed"] if slam.loop_closer is not None else 0
            print(f"frame {i + 1}: kfs={int(m.kf_valid.sum())} pts={int(m.mp_valid.sum())} "
                  f"lines={int(m.ml_valid.sum())} lils={int(m.il_valid.sum())} "
                  f"loops={loops} ({secs:.0f}s)", flush=True)

    row = evaluate(cfg, grays, depths, poses_gt, device=device, pipelined=pipelined,
                   name="long", progress=progress)
    print(f"DONE {n} frames in {row['secs']:.0f}s: ATE={row['ate_cm']:.2f} cm, "
          f"kf_inserted={row['kf_inserted']}, kf_culled={row['kf_culled']}, "
          f"loops={row['loops']}, relocs={row['relocs']}, resets={row['resets']}",
          flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_frames", nargs="?", type=int, default=500)
    ap.add_argument("--pipelined", action="store_true",
                    help="drive track_rgbd_pipelined + finish()")
    ap.add_argument("--device", default="cuda",
                    help="torch device to track on (default: the CUDA card)")
    args = ap.parse_args(argv)
    row = run(args.n_frames, pipelined=args.pipelined, device=args.device)
    print(json.dumps(row), flush=True)
    if not row["ate_cm"] < ATE_BAR_M * 100:
        raise SystemExit(f"ATE {row['ate_cm']:.2f} cm too high (bar {ATE_BAR_M * 100:.0f} cm)")
    print("LONG RUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
