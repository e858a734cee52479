"""Low-texture scene: do lines and LILs carry tracking where points starve?
A ``LowTextureRoom`` circuit (large uniform panels: few corners, long
high-contrast borders; the BASELINE config-2 fr3_structure_notexture
analogue), default 120 frames, through three configs:

  points   points only
  +lines   map lines, no LIL terms
  +LILs    the full structural-line composite error

One JSON row per config. The counterpart of ``scripts/run_lowtex.py``: the
same scene and configs; it writes no ``RESULTS.md``. ``kfs`` is keyframes
inserted and ``lost`` is relocalizations plus resets, as the script counts
them. Runs on the CUDA card unless ``--device cpu`` asks for the CPU.

Usage:
    python -m pslam_tpu_torch.apps.lowtex [n_frames] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

LADDER = (
    ("points", dict(use_lines=False, use_bow=False, use_loop_closing=False)),
    ("+lines", dict(use_lines=True, use_lils=False, use_bow=False, use_loop_closing=False)),
    ("+LILs", dict(use_lines=True, use_lils=True, use_bow=False, use_loop_closing=False)),
)


def frames(cam, n_frames: int):
    """The first ``n_frames`` of the scene's one-loop circuit."""
    from pslam_tpu_torch.io.synthetic import LowTextureRoom, loop_trajectory, render_sequence

    room = LowTextureRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=5)
    return render_sequence(cam, poses=loop_trajectory(n_frames, loops=1.0), room=room)


def run_one(name: str, kw: dict, grays, depths, poses_gt, device: str = "cuda") -> dict:
    """One config (``SlamConfig(**kw)``) over the frames; prints and returns
    its row."""
    from pslam_tpu_torch.apps.evaluate import evaluate
    from pslam_tpu_torch.utils.config import SlamConfig

    row = evaluate(SlamConfig(**kw), grays, depths, poses_gt, device=device, name=name)
    row.update(kfs=row["kf_inserted"], lost=row["relocs"] + row["resets"])
    print(json.dumps(row), flush=True)
    return row


def run(n_frames: int = 120, device: str = "cuda") -> list[dict]:
    from pslam_tpu_torch.apps.evaluate import require_device
    from pslam_tpu_torch.utils.config import SlamConfig

    require_device(device)
    print(f"rendering {n_frames}-frame low-texture sequence...", flush=True)
    grays, depths, poses_gt = frames(SlamConfig().camera, n_frames)
    return [run_one(name, kw, grays, depths, poses_gt, device) for name, kw in LADDER]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_frames", nargs="?", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="torch device to track on (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.n_frames, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
