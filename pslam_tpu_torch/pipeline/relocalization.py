"""Relocalization: BoW candidate search + RANSAC pose recovery + refine (port
of ``pslam_tpu/pipeline/relocalization.py``).

Replaces Tracking::Relocalization (reference Tracking.cc:2031-2180):
BoW-bucketed descriptor matching against each candidate keyframe
(ORBmatcher::SearchByBoW, ORBmatcher.cc:159), a fixed-budget RANSAC pose
hypothesis, pose optimization (kernel K2 on the card), and a coarse, then
narrow, projection re-search around the recovered pose against the
candidate's covisible neighbourhood (kernels K1 and K2, through
``track_against_points`` and ``track_local_map_step``).

The hypothesis is a 3-point SE3 alignment of the map points to the frame's
depth back-projections (solver/horn.py) when at least 12 matches carry
depth, else a uv-only PnP RANSAC (solver/pnp.py). Its draws come from a CPU
generator seeded with ``frame_id * 131 + rank``, the integer the JAX package
seeds its PRNG key with.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops.bow import bow_group_mask
from pslam_tpu_torch.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
from pslam_tpu_torch.pipeline.frame_ops import FrameData
from pslam_tpu_torch.pipeline.track_ops import track_against_points, track_local_map_step
from pslam_tpu_torch.solver.horn import ransac_priorities, se3_ransac_3d3d
from pslam_tpu_torch.solver.pnp import pnp_draws, pnp_ransac_2d3d, pnp_sample_indices
from pslam_tpu_torch.solver.pose_opt import PoseObs, pose_optimization

N_TRIALS = 256
MIN_3D_MATCHES = 12  # below this many depth-carrying matches, PnP on uv


class RelocStepResult(NamedTuple):
    T_cw: torch.Tensor  # (4, 4)
    inlier: torch.Tensor  # (Nkf,) per-KF-feature inlier after pose opt
    match_idx: torch.Tensor  # (Nkf,) frame feature per KF feature, -1 none
    n_inliers: torch.Tensor  # () int32
    n_ransac: torch.Tensor  # () int32 RANSAC support


def reloc_bow_step(
    cam: Camera,
    kf_mp_pos,  # (N, 3) world position of the KF feature's map point
    kf_mp_valid,  # (N,) bool: feature has a live map point
    kf_desc,  # (N, 32)
    kf_angle,  # (N,)
    kf_node,  # (N,) BoW node ids (FeatureVector bucket)
    frame: FrameData,
    f_node,  # (N,) frame BoW node ids
    sigma2,  # (levels,)
    seed: int,
) -> RelocStepResult:
    """One relocalization attempt against one candidate KF: SearchByBoW
    matching -> RANSAC on the matches -> LM pose optimization
    (Tracking.cc:2088-2130). Reads one count back to pick the RANSAC."""
    dist = hamming_matrix(kf_desc, frame.desc)
    idx, _ = mutual_nn_match(
        dist, valid_a=kf_mp_valid, valid_b=frame.valid, max_dist=TH_LOW,
        ratio=0.75,  # SearchByBoW mfNNratio for reloc (Tracking.cc:2060)
        extra_mask=bow_group_mask(kf_node, f_node),
    )
    fi = torch.clamp(idx, min=0)
    keep = rotation_consistency_mask(kf_angle, frame.angle[fi], idx >= 0)
    idx = torch.where(keep, idx, -1)
    m = idx >= 0
    fi = torch.clamp(idx, min=0)

    has3d = m & (frame.depth[fi] > 0)
    dev = kf_mp_pos.device
    if int(torch.sum(has3d.to(torch.int32))) >= MIN_3D_MATCHES:
        prio = ransac_priorities(seed, N_TRIALS, has3d.shape[0], dev)
        T0, _, n_ransac = se3_ransac_3d3d(kf_mp_pos, frame.xyz_c[fi], has3d, prio)
    else:
        samp = pnp_sample_indices(pnp_draws(seed, N_TRIALS, dev), m)
        T0, _, n_ransac = pnp_ransac_2d3d(cam, kf_mp_pos, frame.uv[fi], m, samp)

    obs = torch.stack([frame.uv[fi, 0], frame.uv[fi, 1], frame.ur[fi]], dim=-1)
    lvl = torch.clamp(frame.level[fi].to(torch.int64), 0, sigma2.shape[0] - 1)
    po = PoseObs(X_w=kf_mp_pos, obs=obs, inv_sigma2=1.0 / sigma2[lvl], valid=m)
    T_opt, inlier, _, _ = pose_optimization(cam, T0, po)
    return RelocStepResult(
        T_cw=T_opt, inlier=inlier, match_idx=idx,
        n_inliers=torch.sum(inlier.to(torch.int32)), n_ransac=n_ransac,
    )


def relocalize(system, hf, fd: FrameData) -> bool:
    """Host orchestration (Tracking::Relocalization, Tracking.cc:2031):
    detect candidates, try each, then refine the best by a coarse projection
    search; accept at >= reloc_accept_inliers (Tracking.cc:2173 uses 50).
    Returns True and fills hf.T_cw / hf.feat_mp on success."""
    cfg = system.cfg
    m = system.map
    db = system.kf_db
    if db is None or m.n_kf == 0:
        return False
    bow_q, _, node_q = db.compute_bow(hf.desc, hf.valid)
    cands = db.detect_relocalization_candidates(bow_q, m)
    if len(cands) == 0:
        return False

    dev = system.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sigma2 = t(np.asarray([(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32))
    min_bow_inliers = 15  # Tracking.cc:2074 (nmatches < 15 -> skip)
    f_node = t(node_q.astype(np.int64))

    best = None
    for rank, kf in enumerate(cands[: cfg.tracking.reloc_max_candidates]):
        kf = int(kf)
        mp = m.kf_feat_mp[kf]
        mp_valid = (mp >= 0) & m.mp_valid[np.maximum(mp, 0)]
        mp_pos = m.mp_pos[np.maximum(mp, 0)] * mp_valid[:, None]
        res = reloc_bow_step(
            cfg.camera, t(mp_pos.astype(np.float32)), t(mp_valid), t(m.kf_desc[kf]),
            t(m.kf_angle[kf]), t(db.node[kf].astype(np.int64)), fd, f_node, sigma2,
            hf.frame_id * 131 + rank,
        )
        n_in = int(res.n_inliers)
        if n_in < min_bow_inliers:
            continue
        if best is None or n_in > best[0]:
            best = (n_in, kf, res)
    if best is None:
        return False
    _, kf, res = best

    # Coarse projection re-search around the recovered pose, then a narrow
    # second pass (SearchByProjection coarse -> fine, Tracking.cc:2135-2165),
    # against the candidate's covisible neighbourhood.
    neigh = [kf] + [int(j) for j in m.best_covisible(kf, 10)]
    mp = m.kf_feat_mp[np.asarray(neigh)].reshape(-1)
    mp_ids = np.unique(mp[mp >= 0])
    mp_ids = mp_ids[m.mp_valid[mp_ids]]
    pts = system._point_set(mp_ids, cap=cfg.caps.local_points)
    res2 = track_against_points(cfg.camera, res.T_cw, pts, fd, 10.0, cfg.orb.scale, cfg.orb.levels)
    n_final = int(res2.n_inliers)
    match_point = res2.match_point.cpu().numpy()
    inl = res2.inlier.cpu().numpy()
    T_final = res2.T_cw
    if cfg.tracking.reloc_accept_inliers > n_final >= 30:
        prior = torch.where(res2.match_point >= 0, res2.match_point, -1)
        res3 = track_local_map_step(cfg.camera, res2.T_cw, pts, fd, prior, 3.0,
                                    cfg.orb.scale, cfg.orb.levels)
        if int(res3.n_inliers) > n_final:
            n_final = int(res3.n_inliers)
            match_point = res3.match_point.cpu().numpy()
            inl = res3.inlier.cpu().numpy()
            T_final = res3.T_cw
    if n_final < cfg.tracking.reloc_accept_inliers:
        return False

    hf.T_cw = T_final.cpu().numpy()
    sel = np.flatnonzero((match_point >= 0) & inl)[: len(mp_ids)]
    sel = sel[sel < len(mp_ids)]
    hf.feat_mp[match_point[sel]] = mp_ids[sel]
    system.ref_kf = kf
    system.stats["relocs"] = system.stats.get("relocs", 0) + 1
    return True
