"""Run one cell on several seeds in one process and print, for each seed,
the program's readings judged against the limits; with ``--control N`` also
the control's (the reference computed in TF32 in the program's place) on
the first N seeds; with ``--fault`` under a fault planted in the port
(``planted.py``).

    python3 slambench/tests/drive.py --workload points-fr2xyz --seeds 11,12,13 \\
        --seconds 51 [--control 3] [--fault stale_pose] [--out DIR]

From the root of a checkout, on a card; the CPU tests run it with
``--device cpu`` and small stand-ins for the cell's files (``--config``,
``--traffic``). Each seed's line on standard output is a JSON object with
the key ``reading``. With ``--out``, each seed's returned poses and
keyframes go to ``DIR/<workload>.<fault or sound>.<seed>.npz``, so that a
number can be worked out again from them.
"""

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0, help="seeds read with the control")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None, help="a configuration file in the cell's place")
    ap.add_argument("--traffic", default=None, help="a traffic file in the cell's place")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")

    import numpy as np
    import torch

    torch.set_num_threads(2 if args.device == "cpu" else 1)
    from slambench import check, harness
    from slambench.tests import planted

    _, cfg, traffic, _, _ = harness.resolve_cell(args.workload)
    cfg_o = json.loads(Path(args.config).read_text()) if args.config else None
    traffic_o = json.loads(Path(args.traffic).read_text()) if args.traffic else None
    cfg, traffic = cfg_o or cfg, traffic_o or traffic
    first = int(traffic.get("resume_frames", 0)) + int(traffic["warm_frames"])
    if args.fault:
        planted.plant(args.fault, first)

    seen = {}
    real_readings, real_control = check.readings, check.control_readings

    def readings(cfg, traffic, seed, frames, m, seq_of_frame, first_frame, image_of, **kw):
        seen.update(frames=frames, m=m, seq=seq_of_frame)
        seen["program"] = real_readings(cfg, traffic, seed, frames, m, seq_of_frame,
                                        first_frame, image_of, **kw)
        return seen["program"]

    def control_readings(*a):
        seen["control"] = real_control(*a)
        return seen["control"]

    check.readings, check.control_readings = readings, control_readings
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        seen.clear()
        res = harness.run(args.workload, seed, args.seconds, False, control=n < args.control,
                          device=args.device, config_override=cfg_o,
                          traffic_override=traffic_o)
        ok, _ = check.judge(seen["program"], cfg["limits"])
        line = {"seed": seed, "fault": args.fault, "program_correct": ok,
                "program": seen["program"], "attempted": res["attempted"],
                "failed": res["failed"]}
        if "control" in seen:
            line["control"] = {**seen["program"], **seen["control"]}
            line["control_correct"] = res["correct"]
        print(json.dumps({"reading": line}), flush=True)
        if args.out:
            frames, m, seq = seen["frames"], seen["m"], seen["seq"]
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            kf_seq = np.array([seq(int(f)) if v else -1
                               for f, v in zip(m["kf_frame_id"], m["kf_valid"])])
            np.savez(out / f"{args.workload}.{args.fault or 'sound'}.{seed}.npz",
                     frame_i=np.array([i for i, _, _ in frames]),
                     frame_seq=np.array([seq(i) for i, _, _ in frames]),
                     frame_T=np.stack([T for _, T, _ in frames]),
                     frame_ok=np.array([ok_ for _, _, ok_ in frames]),
                     kf_valid=m["kf_valid"], kf_pose=m["kf_pose"],
                     kf_frame_id=m["kf_frame_id"], kf_seq=kf_seq, first_frame=first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
