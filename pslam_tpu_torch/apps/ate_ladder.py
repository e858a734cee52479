"""ATE ladder: the BASELINE config ladder over a rendered closed circuit
with a revisit at its end (default 200 frames), one JSON row per config.
The counterpart of ``scripts/run_ate_ladder.py``: the same four configs and
scene. It never writes ``RESULTS.md``; ``--out PATH`` writes the same table
to PATH. Runs on the CUDA card unless ``--device cpu`` asks for the CPU.

  1. points        (BASELINE config 1: points only)
  2. +lines        (config 2: map lines, no composite error)
  3. +LILs         (config 3: structural-line composite error in pose/BA)
  4. +loop         (config 4: BoW place recognition and loop closing)

``kfs`` is keyframes inserted less keyframes culled and ``lost`` is
relocalizations plus resets, as the script counts them.

Usage:
    python -m pslam_tpu_torch.apps.ate_ladder [n_frames] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

LADDER = (
    ("points", dict(use_lines=False, use_bow=False, use_loop_closing=False)),
    ("+lines", dict(use_lines=True, use_lils=False, use_bow=False, use_loop_closing=False)),
    ("+LILs", dict(use_lines=True, use_lils=True, use_bow=False, use_loop_closing=False)),
    ("+loop", dict(use_lines=True, use_lils=True, use_bow=True, use_loop_closing=True)),
)


def run(n_frames: int = 200, device: str = "cuda") -> list[dict]:
    """Render the circuit once and run every config of the ladder on it."""
    from pslam_tpu_torch.apps.evaluate import evaluate, require_device
    from pslam_tpu_torch.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
    from pslam_tpu_torch.utils.config import SlamConfig

    require_device(device)
    print(f"rendering {n_frames}-frame loop sequence...", flush=True)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3)
    grays, depths, poses_gt = render_sequence(
        SlamConfig().camera, poses=loop_trajectory(n_frames, loops=1.0), room=room)
    rows = []
    for name, kw in LADDER:
        row = evaluate(SlamConfig(**kw), grays, depths, poses_gt, device=device, name=name)
        row.update(kfs=row["kf_inserted"] - row["kf_culled"],
                   lost=row["relocs"] + row["resets"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def write_table(path: str, rows: list[dict], n_frames: int):
    """The table ``scripts/run_ate_ladder.py`` writes, with the device."""
    with open(path, "w") as f:
        f.write(
            f"# ATE ladder — synthetic loop circuit ({n_frames} frames, ClosedRoom, "
            "revisit at end)\n\n"
            "`ATE` scores the final corrected trajectory (SaveTrajectoryTUM\n"
            "semantics), `online` the per-frame output before loop corrections.\n\n"
            "| config | ATE RMSE (cm) | online (cm) | keyframes | loops closed | "
            "lost events | device |\n|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(f"| {r['name']} | {r['ate_cm']:.2f} | {r['online_cm']:.2f} | "
                    f"{r['kfs']} | {r['loops']} | {r['lost']} | {r['device']} |\n")
        f.write(f"\nGenerated by pslam_tpu_torch.apps.ate_ladder, "
                f"{time.strftime('%Y-%m-%d')}.\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_frames", nargs="?", type=int, default=200)
    ap.add_argument("--out", help="write the markdown table to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to track on (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = run(args.n_frames, device=args.device)
    if args.out:
        write_table(args.out, rows, args.n_frames)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
