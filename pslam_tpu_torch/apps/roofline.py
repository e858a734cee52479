"""Per-stage roofline account of the hot path on the card: the counterpart
of ``scripts/roofline.py``.

Its nine stages, built as it builds them (``SlamConfig()``, 640x480, frame
0 of ``render_sequence(seed=0)``): ``pyramid``, ``fast_dual``,
``detect_keypoints``, ``gaussian_blur``, ``patches+angles+brief``,
``line_frontend``, ``match+pose (motion model)`` against the 4096-point
map of ``apps/profile_frame.py``, ``frame_step (fused)`` against a map of
one keyframe, and ``local BA (48c/2048p/8192e)`` on the random problem of
``apps/profile_backend.py``.

Each stage's floor is ``utils.profile.bound``: the larger of its bytes
(inputs read once, outputs written once, from its actual tensors) over
3.35 TB/s and its operations (counted from its shapes by the formulas of
``utils/profile.py``; "not counted" where a stage has none, and then the
bytes floor alone) over 67 TFLOP/s f32, the peaks of one H100 SXM at 700 W.
``share`` = floor / event ms. The JAX package's ``ROOFLINE.md`` is a TPU
v5e's table, measured against that chip's peaks, and no yardstick here.

Columns: ms (event ms a call), GFLOP, MB, TFLOP/s, GB/s, bound, floor ms,
share, launches a call and busy share. The closing line names the two
stages with the most ``ms x (1 - share)``, the frame program itself left
out, as the script does. The header names the card and its power limit
(``nvidia-smi``). The table goes to stdout and to ``--out PATH``. Runs on
the CUDA card unless ``--device cpu`` asks for host times on the CPU (no
share there).

Usage:
    python -m pslam_tpu_torch.apps.roofline [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

REPS = 20  # scripts/roofline.py's R, a ceiling
BA_REPS = 3
FUSED = "frame_step (fused)"


def run(device: str = "cuda", cfg=None, reps: int = REPS, ba_reps: int = BA_REPS,
        ba_shape=(2048, 8192)) -> list[dict]:
    """The nine stages' rows. ``cfg`` defaults to ``SlamConfig()``; smaller
    configs and shapes are for tests on the CPU."""
    from pslam_tpu_torch.apps.profile_backend import ba_count, random_ba_problem
    from pslam_tpu_torch.apps.profile_frame import (frontend_inputs, frontend_rows,
                                                    point_set_from_frame)
    from pslam_tpu_torch.ops import orb as orb_mod
    from pslam_tpu_torch.ops.image import build_pyramid, gaussian_blur
    from pslam_tpu_torch.ops.orb import PATCH, extract_orb, extract_patches, keypoint_angles
    from pslam_tpu_torch.pipeline import frame_step as fstep
    from pslam_tpu_torch.pipeline.frame_ops import make_frame, make_frame_lines
    from pslam_tpu_torch.pipeline.system import SlamSystem
    from pslam_tpu_torch.pipeline.track_ops import track_against_points
    from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment
    from pslam_tpu_torch.utils import profile as P
    from pslam_tpu_torch.utils.config import SlamConfig

    dev = P.cuda_device(device)
    cfg = cfg or SlamConfig()
    cam, orb = cfg.camera, cfg.orb
    img, depth = frontend_inputs(cfg, dev)
    rows = frontend_rows(cfg, img, depth, dev, reps,
                         stages=("build_pyramid", "fast_dual", "detect_keypoints",
                                 "gaussian_blur"))
    rows[0]["name"] = "pyramid"

    stack = build_pyramid(img, orb.levels, orb.scale)[0]
    feats = extract_orb(img, orb)
    blurred = gaussian_blur(stack)
    n_kp = feats.valid.shape[0]
    rows.append(P.stage_row(
        "patches+angles+brief",
        lambda b, u, l: orb_mod._brief_bits(extract_patches(b, u, l),
                                            keypoint_angles(extract_patches(b, u, l))),
        blurred, feats.uv_lvl, feats.level,
        ops=P.angle_ops(n_kp, PATCH) + n_kp * P.BRIEF_KEYPOINT_OPS, reps=reps, device=dev))
    rows.append(P.stage_row(
        "line_frontend",
        lambda i, d: make_frame_lines(i, d, cam, cfg.lines, cfg.caps.frame_lils),
        img, depth, reps=reps, device=dev))

    fd0 = make_frame(img, depth, cam, orb)
    pts = point_set_from_frame(fd0, cfg.caps.local_points, dev)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    radius = cfg.tracking.motion_match_radius
    res = track_against_points(cam, T0, pts, fd0, radius, orb.scale, orb.levels)
    rows.append(P.stage_row(
        "match+pose (motion model)",
        lambda T, p, f: track_against_points(cam, T, p, f, radius, orb.scale, orb.levels),
        T0, pts, fd0, ops=P.track_ops(int(pts.valid.sum()), int(fd0.valid.sum()),
                                 int(res.n_matches)), reps=reps, device=dev))

    # The whole frame program against a map of one keyframe.
    slam = SlamSystem(cfg, device=dev)
    slam.track_rgbd(img.cpu().numpy(), depth.cpu().numpy(), 0.0)
    slam._rebuild_snapshot()
    snap, acc = slam._snap, slam._acc
    rows.append(P.stage_row(
        FUSED, lambda g, d, T, v, s, a: fstep.frame_step(cfg, g, d, T, v, radius, s, a),
        img, depth, T0, torch.eye(4, dtype=torch.float32, device=dev), snap, acc,
        reps=reps, device=dev))

    prob, _, _ = random_ba_problem(cfg, np.random.default_rng(0), *ba_shape, dev)
    rows.append(P.stage_row(
        f"local BA ({prob.T_cw.shape[0]}c/{ba_shape[0]}p/{ba_shape[1]}e)",
        lambda p: local_bundle_adjustment(cam, p, cfg.caps.ba_free), prob,
        ops=ba_count(prob, cfg.caps.ba_free), reps=ba_reps, warmup=1, prof_reps=1, device=dev))
    return rows


def _num(x):
    return x if isinstance(x, (int, float)) else None


def targets(rows) -> list[dict]:
    """The two stages with the most time above their floor, ``ms x (1 -
    share)``, the fused frame program left out (scripts/roofline.py)."""
    cand = [r for r in rows if r["name"] != FUSED and r["share"] is not None]
    return sorted(cand, key=lambda r: r["event_ms"] * (1 - r["share"]), reverse=True)[:2]


def table(rows, device) -> str:
    """The roofline table, its header naming the card, and the closing
    line."""
    from pslam_tpu_torch.utils import profile as P

    def f(x, d=3):
        return "-" if x is None else (x if isinstance(x, str) else f"{x:.{d}f}")

    lines = [
        "# Per-stage roofline account (pslam_tpu_torch.apps.roofline)", "",
        f"Card: {P.card_identity(device)}. Peaks: {P.PEAK_F32_S / 1e12:.0f} TFLOP/s f32 "
        f"(no tensor cores), {P.PEAK_BYTES_S / 1e12:.2f} TB/s HBM. `floor` = max(ops / peak, "
        "bytes / peak); `share` = floor / ms; ms is the event-timed time a call, host "
        "enqueue included.", "",
        "| stage | ms | GFLOP | MB | TFLOP/s | GB/s | bound | floor ms | share | "
        "launches a call | busy |",
        "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        ms, ops = P.measured_ms(r), _num(r["ops"])
        on_card = r["event_ms"] is not None
        lines.append(
            f"| {r['name']} | {f(ms)} | {f(ops / 1e9 if ops is not None else r['ops'], 4)} | "
            f"{r['nbytes'] / 1e6:.3f} | "
            f"{f(ops / ms / 1e9 if on_card and ops is not None else None)} | "
            f"{f(r['nbytes'] / ms / 1e6 if on_card else None, 2)} | {r['bound_by']} | "
            f"{r['floor_ms']:.6f} | {f(r['share'] * 100 if r['share'] is not None else None, 2)}"
            f"{'%' if r['share'] is not None else ''} | {f(_num(r['launches']), 1)} | "
            f"{f(_num(r['busy']) * 100 if _num(r['busy']) is not None else r['busy'], 1)}"
            f"{'%' if _num(r['busy']) is not None else ''} |")
    top = targets(rows)
    if top:
        lines += ["", "Top targets (largest ms x (1 - share)): " + ", ".join(
            f"**{r['name']}** ({r['event_ms']:.2f} ms at {r['share'] * 100:.2f}% of its "
            f"{r['bound_by']} floor)" for r in top) + "."]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write the markdown table to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure (default: the CUDA card)")
    args = ap.parse_args(argv)
    text = table(run(args.device), args.device)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
