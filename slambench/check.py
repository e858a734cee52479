"""The comparison that decides ``correct``.

It judges what the timed path produced, once the window has closed, against
the plain reference (``reference.py``) and the true scene:

- frontend: every valid feature of a sample of the keyframes that the
  window inserted (up to ``KF_SAMPLE``, drawn from the seed): its depth
  against the sensor depth at the raw pixel its keypoint came from
  (``depth_rel_p99``, the 99th percentile of the relative gap; a feature the
  program left without depth counts 1), and its descriptor against the
  reference's rBRIEF at its keypoint in the frame's image
  (``desc_bits_mean``, the mean number of bits that differ);
- tracking: every pose ``track_rgbd`` returned after the warm-up: frames
  lost (``lost_frames``); and over the first ``head_frames`` of the window
  (a fixed count: drift and the rounding of chained poses grow with the
  frames tracked, and a faster program tracks more), cut before the first
  frame that accepted a loop (a loop correction rightly moves the poses
  after it), their ATE as a share of
  the ATE that a pose held still would read, the spread of their true
  positions (``ate_head_ratio``: a stale pose reads 1 under any motion), and
  how far each rotation is from a rotation (``pose_orth``);
- backend: the map after the last keyframe's BA is committed, over the
  keyframes the window inserted that are still in it: how far each one's
  pose relative to the surviving keyframe before it is from the true
  relative pose (the mean, ``kf_rel_cm``; relative, so free of the drift
  that grows with the frames a window tracks), and the median distance from
  the room's faces of each map point they observe, carried into the
  keyframe's camera by the program's pose of it and out again by its true
  pose (``map_surface_mm``);
- loop closing, where the configuration judges it: whether the loop closer
  accepted no loop from the first window frame to the end of the run
  (``loop_missed``, 1 or 0), and for each loop edge (keyframe, loop
  keyframe) it added then, how far the two keyframes' relative pose in the
  final map is from their true relative pose (``loop_rel_cm``, the largest).

The limits come from the configuration file's ``limits``, and ``judge``
judges the numbers that it lists. ``lost_frames`` and ``loop_missed`` are
exact. ``kf_rel_cm``, ``map_surface_mm`` and ``loop_rel_cm`` hold the
configuration's stated accuracy. ``ate_head_ratio`` was set between the
program's readings and those of a stale pose; the three precision limits
(``pose_orth``, ``depth_rel_p99``, ``desc_bits_mean``) between the
program's and the control's (the reference computed in TF32 in the
program's place), as ``PERF.md`` records.
"""

from __future__ import annotations

import numpy as np

from slambench import reference, stats
from slambench.traffic import path_poses

KF_SAMPLE = 8
CHECKS = ("lost_frames", "ate_head_ratio", "pose_orth", "depth_rel_p99", "desc_bits_mean",
          "kf_rel_cm", "map_surface_mm", "loop_missed", "loop_rel_cm")


def ate_ratio(est_poses, gt_poses) -> float:
    """ATE of the poses over the RMS distance of their true positions from
    their mean, which is the ATE of any pose held still: 1 for a stale
    tracker, whatever the motion."""
    if len(est_poses) < 3:
        return float("inf")
    gt = stats.trajectory_positions(gt_poses)
    spread = np.sqrt(((gt - gt.mean(axis=0)) ** 2).sum(axis=1).mean())
    return float(stats.ate_rmse(stats.trajectory_positions(est_poses), gt) / spread)


def sample_keyframes(kf_frame_id, kf_valid, first_frame: int, seed: int):
    """Slots of up to KF_SAMPLE keyframes inserted at or after
    ``first_frame``, drawn from the seed."""
    slots = np.flatnonzero(kf_valid & (kf_frame_id >= first_frame))
    rng = np.random.default_rng(int(seed))
    if len(slots) > KF_SAMPLE:
        slots = np.sort(rng.choice(slots, KF_SAMPLE, replace=False))
    return slots


def feature_pixels(m, slots, cam: dict, scale: float):
    """Per sampled keyframe: (valid feature indices, octave coordinates,
    raw pixels)."""
    out = []
    for k in slots:
        idx = np.flatnonzero(m["kf_feat_valid"][k])
        lvl = m["kf_level"][k][idx]
        on = reference.octave_coords(m["kf_uv"][k][idx], lvl, cam, scale)
        out.append((idx, on, reference.raw_pixels(on, lvl, scale)))
    return out


def desc_bits(m, slots, pixels, image_of, orb: dict, tf32_ref: bool = False):
    """Bits by which each sampled feature's descriptor (the program's, or
    with ``tf32_ref`` the reference's in TF32) differs from the
    reference's."""
    bits = []
    for k, (idx, on, _) in zip(slots, pixels):
        img = image_of(int(m["kf_frame_id"][k]))
        lvl = m["kf_level"][k][idx]
        ref = reference.descriptors(img, on, lvl, orb["levels"], orb["scale"])
        got = (reference.descriptors(img, on, lvl, orb["levels"], orb["scale"], tf32=True)
               if tf32_ref else m["kf_desc"][k][idx])
        bits.append(reference.hamming(got, ref))
    return np.concatenate(bits) if bits else np.zeros(0)


def depth_gaps(m, slots, pixels, seq_of_frame, gt, room, cam, dmf, depth_of=None):
    """Relative gaps of the sampled features' depths (the program's, or
    ``depth_of(k, px)``'s) to the reference's."""
    gaps = []
    for k, (idx, _, px) in zip(slots, pixels):
        T = gt[seq_of_frame(int(m["kf_frame_id"][k]))]
        z_ref = reference.true_depth(room, cam, T, px, dmf)
        z = m["kf_feat_depth"][k][idx] if depth_of is None else depth_of(k, px)
        gap = np.abs(np.asarray(z, np.float64) - z_ref) / z_ref
        gaps.append(np.where(np.asarray(z) > 0, gap, 1.0))
    return np.concatenate(gaps) if gaps else np.zeros(0)


def loop_readings(m, seq_of_frame, gt, loops) -> dict:
    """``loop_missed`` and ``loop_rel_cm`` of ``loops``: {"closed": loops
    accepted from the first window frame on, "edges": [(keyframe slot, loop
    keyframe slot)] added then}, or None where the program has no loop
    closer."""
    if loops is None:
        return {"loop_missed": 1.0, "loop_rel_cm": float("inf")}
    rel = []
    for a, b in loops["edges"]:
        if not (m["kf_valid"][a] and m["kf_valid"][b]):
            rel.append(float("inf"))
            continue
        true = gt[[seq_of_frame(int(m["kf_frame_id"][k])) for k in (a, b)]]
        rel.append(stats.rpe_mm(m["kf_pose"][[a, b]], true)[0] / 10)
    return {"loop_missed": 0.0 if loops["closed"] > 0 else 1.0,
            "loop_rel_cm": float(max(rel)) if rel else float("inf")}


def readings(cfg: dict, traffic: dict, seed: int, frames, m, seq_of_frame, first_frame: int,
             image_of, loops=None):
    """The numbers compared. ``frames``: [(stream index, pose returned,
    tracked OK)] of every frame after the warm-up; ``m``: the map's arrays;
    ``image_of(stream index)``: the frame's image as the program got it;
    ``loops``: as ``loop_readings`` takes it."""
    cam = cfg["slam"]["camera"]
    room = traffic["room"]
    gt = path_poses(traffic)
    dmf = float(cfg["sensor"]["depth_map_factor"])
    n_head = int(traffic["head_frames"])
    if loops is not None and loops["edges"]:
        # The keyframe of a loop edge is the one made in the frame that
        # accepted the loop.
        loop_at = min(int(m["kf_frame_id"][a]) for a, _ in loops["edges"])
        n_head = min(n_head, sum(i < loop_at for i, _, _ in frames))
    head = np.array([T for _, T, _ in frames[:n_head]], np.float64).reshape(-1, 4, 4)
    head_gt = gt[[seq_of_frame(i) for i, _, _ in frames[:n_head]]]
    kf = np.flatnonzero(m["kf_valid"])
    kf = kf[np.argsort(m["kf_frame_id"][kf])]
    kf_all_gt = gt[[seq_of_frame(int(f)) for f in m["kf_frame_id"][kf]]]
    in_window = m["kf_frame_id"][kf] >= first_frame
    # Each surviving window keyframe against the surviving keyframe before it.
    pair = np.flatnonzero(in_window[1:])
    rel = [stats.rpe_mm(m["kf_pose"][kf[[i, i + 1]]], kf_all_gt[[i, i + 1]])[0] / 10
           for i in pair]
    kf_eval, kf_gt = kf[in_window], kf_all_gt[in_window]
    dists = []
    for k, T_true in zip(kf_eval, kf_gt):
        ids = m["kf_feat_mp"][k]
        ids = ids[(ids >= 0)]
        ids = ids[m["mp_valid"][ids]]
        X = m["mp_pos"][ids].astype(np.float64)
        T = m["kf_pose"][k].astype(np.float64)
        X_c = X @ T[:3, :3].T + T[:3, 3]
        T_wc = np.linalg.inv(T_true)
        dists.append(reference.surface_distance(room, X_c @ T_wc[:3, :3].T + T_wc[:3, 3]))
    dists = np.concatenate(dists) if dists else np.zeros(0)
    slots = sample_keyframes(m["kf_frame_id"], m["kf_valid"], first_frame, seed)
    pixels = feature_pixels(m, slots, cam, float(cfg["slam"]["orb"]["scale"]))
    gaps = depth_gaps(m, slots, pixels, seq_of_frame, gt, room, cam, dmf)
    bits = desc_bits(m, slots, pixels, image_of, cfg["slam"]["orb"])
    return {
        "lost_frames": float(sum(not ok for _, _, ok in frames)),
        "ate_head_ratio": ate_ratio(head, head_gt),
        "pose_orth": float(reference.orthonormality(head).max()) if n_head else float("inf"),
        "depth_rel_p99": float(np.percentile(gaps, 99)) if len(gaps) else float("inf"),
        "desc_bits_mean": float(bits.mean()) if len(bits) else float("inf"),
        "kf_rel_cm": float(np.mean(rel)) if rel else float("inf"),
        "map_surface_mm": float(np.median(dists)) * 1e3 if len(dists) else float("inf"),
        **loop_readings(m, seq_of_frame, gt, loops),
    }


def control_readings(cfg: dict, traffic: dict, seed: int, frames, m, seq_of_frame,
                     first_frame: int, image_of):
    """The control: the reference computed in TF32 put in the program's
    place, read by the precision numbers on the same frames and sampled
    features: the true poses chained frame to frame from the stream's first
    frame, the sensor depths, the descriptors."""
    cam = cfg["slam"]["camera"]
    room = traffic["room"]
    gt = path_poses(traffic)
    dmf = float(cfg["sensor"]["depth_map_factor"])
    slots = sample_keyframes(m["kf_frame_id"], m["kf_valid"], first_frame, seed)
    pixels = feature_pixels(m, slots, cam, float(cfg["slam"]["orb"]["scale"]))
    by_slot = {int(k): px for k, (_, _, px) in zip(slots, pixels)}

    def tf32_depth(k, px):
        T = gt[seq_of_frame(int(m["kf_frame_id"][k]))]
        return reference.true_depth(room, cam, T, px, dmf, tf32=True)

    gaps = depth_gaps(m, slots, pixels, seq_of_frame, gt, room, cam, dmf,
                      depth_of=lambda k, px: tf32_depth(k, by_slot[int(k)]))
    bits = desc_bits(m, slots, pixels, image_of, cfg["slam"]["orb"], tf32_ref=True)
    n_head = min(int(traffic["head_frames"]), len(frames))
    stream = gt[[seq_of_frame(i) for i in range(first_frame + n_head)]]
    chained = reference.chained_poses(stream, tf32=True)[first_frame:]
    return {
        "pose_orth": float(reference.orthonormality(chained).max()),
        "depth_rel_p99": float(np.percentile(gaps, 99)) if len(gaps) else float("inf"),
        "desc_bits_mean": float(bits.mean()) if len(bits) else float("inf"),
    }


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit, ok)]) over the numbers that ``limits``
    lists: every one at or under its limit."""
    unknown = set(limits) - set(CHECKS)
    if unknown:
        raise ValueError(f"limits for unknown checks {sorted(unknown)}")
    rows = []
    for name in (c for c in CHECKS if c in limits):
        v, lim = values[name], float(limits[name])
        rows.append((name, v, lim, bool(np.isfinite(v) and v <= lim)))
    return all(r[3] for r in rows), rows
