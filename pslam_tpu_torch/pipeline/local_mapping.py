"""Local mapping (backend): BA problem assembly + write-back, epipolar
triangulation, neighbour fuse, point and keyframe culling (port of
``pslam_tpu/pipeline/local_mapping.py``).

The device stages (triangulation, fuse matching, local BA) are dispatched at
one keyframe and committed at the next keyframe event, like the JAX package:
on a CUDA device the kernels run while tracking continues, and the host
reads their results only at commit time.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.ops.match import (
    TH_LOW,
    hamming_matrix,
    level_window_mask,
    mutual_nn_match,
    window_mask,
)
from pslam_tpu_torch.ops.triangulate import KFView, epipolar_triangulate
from pslam_tpu_torch.pipeline.track_ops import (
    PointSet,
    _project_points,
    _scale_visibility,
)
from pslam_tpu_torch.solver.local_ba import BAProblem
from pslam_tpu_torch.utils.config import SlamConfig


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def ba_edges(map_state: MapState, cam_ids, pt_slot, cfg: SlamConfig):
    """The observation edges of a BA problem: every feature of the cameras
    ``cam_ids`` whose map point has a slot in ``pt_slot``. Returns (camera
    slot, point slot, [u, v, ur], inverse octave variance, (kf, feature))
    arrays in camera order, or None when there is no edge."""
    sigma2 = np.asarray(
        [(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32
    )
    e_cam, e_pt, e_obs, e_is2, e_feat = [], [], [], [], []
    for s, k in enumerate(cam_ids):
        mp = map_state.kf_feat_mp[k]
        sel = np.flatnonzero((mp >= 0) & (pt_slot[np.maximum(mp, 0)] >= 0))
        if len(sel) == 0:
            continue
        e_cam.append(np.full(len(sel), s, np.int64))
        e_pt.append(pt_slot[mp[sel]])
        uv = map_state.kf_uv[k, sel]
        ur = map_state.kf_ur[k, sel]
        e_obs.append(np.concatenate([uv, ur[:, None]], axis=1).astype(np.float32))
        e_is2.append(
            1.0 / sigma2[np.clip(map_state.kf_level[k, sel], 0, len(sigma2) - 1)]
        )
        e_feat.append(np.stack([np.full(len(sel), k), sel], axis=1))
    if not e_cam:
        return None
    return tuple(np.concatenate(a) for a in (e_cam, e_pt, e_obs, e_is2, e_feat))


def assemble_local_ba(map_state: MapState, kf_idx: int, cfg: SlamConfig, device):
    """Build a BAProblem around keyframe ``kf_idx``.

    Free cameras: ``kf_idx`` + its best covisible keyframes (1-hop local
    window, Optimizer.cc:2112); fixed: other observers of the local points
    (Optimizer.cc:2125). KF 0 is always fixed (gauge).
    Returns (prob, cam_ids (C,), pt_ids (P,), edge meta, n_edges) or None if
    there is nothing to optimize."""
    caps = cfg.caps
    n_free_cap = caps.ba_free

    covis = map_state.best_covisible(kf_idx, n_free_cap - 1)
    free_ids = [kf_idx] + [int(j) for j in covis if j != kf_idx and j != 0]
    free_ids = free_ids[:n_free_cap]
    free_set = set(free_ids)

    pt_ids = map_state.local_map_points(np.asarray(free_ids), caps.ba_points)
    if len(pt_ids) == 0:
        return None
    pt_slot = np.full(map_state.mp_valid.shape[0], -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    feat_mp = map_state.kf_feat_mp[: map_state.n_kf]
    observes_local = (pt_slot[np.maximum(feat_mp, 0)] >= 0) & (feat_mp >= 0)
    obs_count = observes_local.sum(axis=1)
    fixed_ids = [
        k
        for k in np.flatnonzero(obs_count > 0)
        if k not in free_set and map_state.kf_valid[k]
    ]
    cam_ids = free_ids + fixed_ids[: caps.ba_cams - len(free_ids)]
    if len(free_ids) == len(cam_ids) and len(cam_ids) > 1:
        # No fixed camera at all -> fix the oldest free one for gauge.
        oldest = min(free_ids, key=lambda k: int(map_state.kf_frame_id[k]))
        free_ids = [k for k in free_ids if k != oldest]
        free_set = set(free_ids)

    C = caps.ba_cams
    cam_arr = np.zeros((C, 4, 4), np.float32)
    cam_arr[:] = np.eye(4)
    free_slot = np.full(C, -1, np.int64)
    for s, k in enumerate(cam_ids):
        cam_arr[s] = map_state.kf_pose[k]
    fs = 0
    for s, k in enumerate(cam_ids):
        if k in free_set:
            free_slot[s] = fs
            fs += 1

    edges = ba_edges(map_state, cam_ids, pt_slot, cfg)
    if edges is None:
        return None
    e_cam, e_pt, e_obs, e_is2, e_feat = edges

    E = caps.ba_edges
    n_e = min(len(e_cam), E)
    if len(e_cam) > E:
        logging.getLogger(__name__).warning(
            "local BA edge capacity: dropping %d of %d edges (caps.ba_edges=%d)",
            len(e_cam) - E, len(e_cam), E,
        )
        keep = np.random.default_rng(0).choice(len(e_cam), E, replace=False)
        e_cam, e_pt, e_obs, e_is2, e_feat = (
            e_cam[keep], e_pt[keep], e_obs[keep], e_is2[keep], e_feat[keep],
        )
        n_e = E

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[: len(a)] = a
        return out

    # Shape buckets as in the JAX package: power-of-two capacities that fit.
    E_b = min(max(2048, 1 << int(np.ceil(np.log2(max(n_e, 1))))), E)
    P_b = min(max(1024, 1 << int(np.ceil(np.log2(max(len(pt_ids), 1))))), caps.ba_points)
    prob = BAProblem(
        T_cw=_t(cam_arr, device),
        free_slot=_t(free_slot, device),
        X_w=_t(pad(map_state.mp_pos[pt_ids], (P_b, 3)), device),
        point_valid=_t(pad(np.ones(len(pt_ids), bool), (P_b,)), device),
        cam_idx=_t(pad(e_cam[:E_b], (E_b,)), device),
        pt_idx=_t(pad(e_pt[:E_b], (E_b,)), device),
        obs=_t(pad(e_obs[:E_b], (E_b, 3)), device),
        inv_sigma2=_t(pad(e_is2[:E_b].astype(np.float32), (E_b,), 1.0), device),
        edge_valid=_t(pad(np.ones(min(n_e, E_b), bool), (E_b,)), device),
    )
    return prob, cam_ids, pt_ids, e_feat, n_e


def write_back_ba(map_state: MapState, result, cam_ids, pt_ids, e_feat, n_e, free_slot):
    """Write optimized poses/points into the map and erase outlier
    observations (Optimizer.cc:2482-2532). ``result`` holds numpy arrays."""
    T_opt, X_opt, inlier, _ = result
    for s, k in enumerate(cam_ids):
        if free_slot[s] >= 0:
            map_state.kf_pose[k] = T_opt[s]
    map_state.mp_pos[pt_ids] = X_opt[: len(pt_ids)]
    bad = ~inlier[:n_e]
    if bad.any():
        kf_i = e_feat[:n_e][bad, 0]
        ft_i = e_feat[:n_e][bad, 1]
        mp_ids = map_state.kf_feat_mp[kf_i, ft_i]
        map_state.kf_feat_mp[kf_i, ft_i] = -1
        np.add.at(map_state.mp_n_obs, mp_ids[mp_ids >= 0], -1)


def _kf_view(m: MapState, k: int, free_mask, device) -> KFView:
    """KF ``k``'s features as a device KFView for the triangulator."""
    return KFView(
        T_cw=_t(m.kf_pose[k], device),
        uv=_t(m.kf_uv[k], device),
        ur=_t(m.kf_ur[k], device),
        depth=_t(m.kf_feat_depth[k], device),
        level=_t(m.kf_level[k], device),
        angle=_t(m.kf_angle[k], device),
        desc=_t(m.kf_desc[k], device),
        free=_t(free_mask, device),
    )


def dispatch_triangulation(m: MapState, kf: int, cfg: SlamConfig, device):
    """Start the epipolar triangulation of the new KF against its top-10
    covisible neighbours (LocalMapping::CreateNewMapPoints,
    LocalMapping.cc:275-520) without reading results back: returns a pending
    record committed later by ``commit_triangulation``, or None."""
    C_kf = m.kf_camera_center(kf)
    neighbors = [
        int(nkf)
        for nkf in m.best_covisible(kf, 10)
        # Baseline gate (stereo/RGB-D branch, LocalMapping.cc:325-333).
        if np.linalg.norm(m.kf_camera_center(int(nkf)) - C_kf) >= cfg.camera.baseline
    ]
    if len(neighbors) == 0:
        return None
    free1 = (m.kf_feat_mp[kf] < 0) & m.kf_feat_valid[kf]
    if not free1.any():
        return None
    view1 = _kf_view(m, kf, free1, device)
    handles = []
    for n in neighbors:
        free2 = (m.kf_feat_mp[n] < 0) & m.kf_feat_valid[n]
        handles.append(epipolar_triangulate(
            cfg.camera, view1, _kf_view(m, n, free2, device),
            cfg.orb.scale, cfg.orb.levels,
        ))
    return {
        "kf": kf,
        "kf_seq": int(m.kf_seq[kf]),
        "neighbors": neighbors,
        "nb_seq": [int(m.kf_seq[n]) for n in neighbors],
        "free1": free1,
        "handles": handles,
    }


def commit_triangulation(m: MapState, pend, cfg: SlamConfig) -> int:
    """Read back and apply a dispatched triangulation. Stale bindings are
    guarded by KF sequence checks and a re-check that each feature slot is
    STILL free; per-neighbour results apply greedily (a feature bound by an
    earlier neighbour is skipped for later ones)."""
    kf = pend["kf"]
    if not m.kf_valid[kf] or int(m.kf_seq[kf]) != pend["kf_seq"]:
        return 0
    got = [tuple(t.cpu().numpy() for t in h) for h in pend["handles"]]
    free1 = pend["free1"] & (m.kf_feat_mp[kf] < 0)

    created_ids = []
    for j, nkf in enumerate(pend["neighbors"]):
        if not m.kf_valid[nkf] or int(m.kf_seq[nkf]) != pend["nb_seq"][j]:
            continue  # neighbour culled (and possibly recycled) meanwhile
        idx2, X_w, ok = got[j]
        ok = ok & free1
        ok &= np.where(ok, m.kf_feat_mp[nkf][idx2] < 0, False)
        sel1 = np.flatnonzero(ok)
        if len(sel1) == 0:
            continue
        ids = m.create_points_from_depth(kf, sel1, X_w[sel1])
        m.add_point_obs(nkf, idx2[sel1], ids)
        free1[sel1] = False
        created_ids.append(ids)
    if not created_ids:
        return 0
    ids = np.concatenate(created_ids)
    m._update_covisibility(kf)
    m.update_point_stats(ids)
    return len(ids)


def create_new_map_points(m: MapState, kf: int, cfg: SlamConfig, device="cuda") -> int:
    """Synchronous dispatch+commit wrapper (tests / non-pipelined callers)."""
    pend = dispatch_triangulation(m, kf, cfg, device)
    return 0 if pend is None else commit_triangulation(m, pend, cfg)


def _fuse_match(cam: Camera, T_cw, pts: PointSet, f_uv, f_ur, f_level, f_desc,
                f_valid, scale: float, levels: int):
    """Project candidate points into a KF and match against its features
    (ORBmatcher::Fuse, ORBmatcher.cc:825): radius 3*sigma(predicted level),
    level window [pred-1, pred+1], Hamming <= TH_LOW, chi^2 reprojection.
    Plain PyTorch (the JAX counterpart is plain jnp, not a Pallas kernel)."""
    uvr, _, visible = _project_points(cam, T_cw, pts)
    band_ok, pred_level = _scale_visibility(cam, T_cw, pts, scale, levels)
    visible = visible & band_ok
    sfac = torch.tensor([scale**l for l in range(levels)], dtype=torch.float32,
                        device=T_cw.device)
    r = 3.0 * sfac[torch.clamp(pred_level, 0, levels - 1).to(torch.int64)]
    box = window_mask(uvr[:, :2], f_uv, r)
    lvl_ok = level_window_mask(pred_level, f_level, -1, 1)
    dist = hamming_matrix(pts.desc, f_desc)
    idx, _ = mutual_nn_match(
        dist, valid_a=visible, valid_b=f_valid, max_dist=TH_LOW, ratio=1.0,
        extra_mask=box & lvl_ok,
    )
    # chi^2 reprojection gate (mono 5.99, stereo 7.8; ORBmatcher.cc:886-917).
    fi = torch.clamp(idx, min=0)
    s2 = sfac[torch.clamp(f_level[fi].to(torch.int64), 0, levels - 1)] ** 2
    e_uv = torch.sum((uvr[:, :2] - f_uv[fi]) ** 2, dim=-1)
    e_r = (uvr[:, 2] - f_ur[fi]) ** 2
    chi = torch.where(f_ur[fi] >= 0, (e_uv + e_r) / s2, e_uv / s2)
    chi_th = torch.where(f_ur[fi] >= 0, 7.8, 5.99)
    return torch.where((idx >= 0) & (chi <= chi_th), idx, -1)


def _dispatch_fuse_into_kf(m: MapState, t: int, cand_ids: np.ndarray, cfg: SlamConfig,
                           device):
    """Start the projection-fuse match of candidate map points into KF
    ``t``'s features; returns the device result (len(cand_ids),)."""
    pts = PointSet(
        pos=_t(m.mp_pos[cand_ids], device),
        desc=_t(m.mp_desc[cand_ids], device),
        level=_t(m.mp_level[cand_ids], device),
        angle=torch.zeros(len(cand_ids), dtype=torch.float32, device=device),
        min_dist=_t(m.mp_min_dist[cand_ids], device),
        max_dist=_t(m.mp_max_dist[cand_ids], device),
        normal=_t(m.mp_normal[cand_ids], device),
        valid=_t(m.mp_valid[cand_ids], device),
    )
    return _fuse_match(
        cfg.camera, _t(m.kf_pose[t], device), pts,
        _t(m.kf_uv[t], device), _t(m.kf_ur[t], device), _t(m.kf_level[t], device),
        _t(m.kf_desc[t], device), _t(m.kf_feat_valid[t], device),
        cfg.orb.scale, cfg.orb.levels,
    )


def _apply_fuse(m: MapState, t: int, cand_ids, idx, cand_gen=None):
    """Apply one target's fuse matches: replace-or-add (ORBmatcher::Fuse
    apply rule, ORBmatcher.cc:920-941). ``cand_gen`` guards deferred
    application: a candidate slot culled AND recycled since the match ran
    holds a different landmark and is skipped."""
    n_fused = 0
    for p_slot in np.flatnonzero(idx >= 0):
        p_id = int(cand_ids[p_slot])
        if not m.mp_valid[p_id]:
            continue
        if cand_gen is not None and m.mp_gen[p_id] != cand_gen[p_slot]:
            continue
        f = int(idx[p_slot])
        existing = int(m.kf_feat_mp[t, f])
        if existing == p_id:
            continue
        if existing >= 0 and m.mp_valid[existing]:
            # Keep the better-observed landmark (MapPoint::Replace rule).
            if m.mp_n_obs[existing] > m.mp_n_obs[p_id]:
                m.replace_map_point(p_id, existing)
            else:
                m.replace_map_point(existing, p_id)
        elif p_id in m.kf_feat_mp[t]:
            # A replace for an earlier candidate may have rewritten this KF's
            # row since the match ran: never bind p_id to a second slot.
            continue
        else:
            m.add_point_obs(t, [f], [p_id])
        n_fused += 1
    return n_fused


def dispatch_fuse(m: MapState, kf: int, cfg: SlamConfig, device):
    """Start duplicate-landmark fusion with 1-hop + 2-hop covisible
    neighbours (LocalMapping::SearchInNeighbors, LocalMapping.cc:761-891):
    forward (the new KF's points into each target) and reverse (all target
    points into the new KF). Commit later with ``commit_fuse``; None if there
    is nothing to fuse."""
    targets: list[int] = []
    for t in m.best_covisible(kf, 10):
        t = int(t)
        if t not in targets:
            targets.append(t)
        for t2 in m.best_covisible(t, 5):
            t2 = int(t2)
            if t2 != kf and t2 not in targets:
                targets.append(t2)
    if not targets:
        return None

    mp_kf = m.kf_feat_mp[kf]
    own = np.unique(mp_kf[mp_kf >= 0])
    own = own[m.mp_valid[own]]

    # Forward: the new KF's points into each target, skipping points the
    # target already observes (pMP->IsInKeyFrame in ORBmatcher::Fuse).
    fwd = []
    for t in targets:
        if len(own) == 0:
            break
        row = m.kf_feat_mp[t]
        own_t = own[~np.isin(own, row[row >= 0])]
        if len(own_t):
            fwd.append((t, own_t))
    fwd_handles = [_dispatch_fuse_into_kf(m, t, c, cfg, device) for t, c in fwd]

    # Reverse: candidates from all targets not yet seen by kf.
    cand = m.kf_feat_mp[np.asarray(targets)].reshape(-1)
    cand = np.unique(cand[cand >= 0])
    cand = cand[m.mp_valid[cand]]
    seen = set(int(i) for i in m.kf_feat_mp[kf] if i >= 0)
    cand = np.asarray([c for c in cand if int(c) not in seen], np.int64)
    rev_handle = _dispatch_fuse_into_kf(m, kf, cand, cfg, device) if len(cand) else None
    if not fwd and rev_handle is None:
        return None
    return {
        "kf": kf,
        "kf_seq": int(m.kf_seq[kf]),
        "fwd": fwd,
        "fwd_seq": [int(m.kf_seq[t]) for t, _ in fwd],
        "fwd_gen": [m.mp_gen[c].copy() for _, c in fwd],
        "fwd_handles": fwd_handles,
        "own": own,
        "rev_cand": cand,
        "rev_gen": m.mp_gen[cand].copy() if len(cand) else None,
        "rev_handle": rev_handle,
    }


def commit_fuse(m: MapState, pend, cfg: SlamConfig) -> int:
    """Read back and apply a dispatched fuse, guarded by KF sequence checks
    and per-candidate slot generations."""
    n_fused = 0
    for j, (t, c) in enumerate(pend["fwd"]):
        idx = pend["fwd_handles"][j].cpu().numpy()
        if not m.kf_valid[t] or int(m.kf_seq[t]) != pend["fwd_seq"][j]:
            continue
        n_fused += _apply_fuse(m, t, c, idx, cand_gen=pend["fwd_gen"][j])
    kf = pend["kf"]
    kf_alive = m.kf_valid[kf] and int(m.kf_seq[kf]) == pend["kf_seq"]
    if pend["rev_handle"] is not None and kf_alive:
        rev_idx = pend["rev_handle"].cpu().numpy()
        n_fused += _apply_fuse(m, kf, pend["rev_cand"], rev_idx, cand_gen=pend["rev_gen"])

    if n_fused:
        if kf_alive:
            m._update_covisibility(kf)
        own, cand = pend["own"], pend["rev_cand"]
        touched = np.unique(np.concatenate([own, cand])) if len(cand) else own
        m.update_point_stats(touched)
    return n_fused



def search_in_neighbors(m: MapState, kf: int, cfg: SlamConfig, device="cuda") -> int:
    """Synchronous dispatch+commit wrapper (tests / non-pipelined callers)."""
    pend = dispatch_fuse(m, kf, cfg, device)
    return 0 if pend is None else commit_fuse(m, pend, cfg)

def cull_keyframes(m: MapState, kf: int, cfg: SlamConfig, protect=()) -> list:
    """KeyFrameCulling (LocalMapping.cc:989-1055): a covisible KF whose close
    map points are >= 90% redundantly observed (>= 3 other KFs at the same or
    finer scale) is removed. Returns the KF slots to erase; the caller fixes
    up trajectory references and calls m.erase_keyframe."""
    victims = []
    n = m.n_kf
    protect = set(protect) | {0, kf}
    for k in m.covisible_kfs(kf):
        k = int(k)
        if k in protect:
            continue
        row = m.kf_feat_mp[k]
        feat = np.flatnonzero(row >= 0)
        if len(feat) == 0:
            continue
        depth_k = m.kf_feat_depth[k, feat]
        feat = feat[(depth_k > 0) & (depth_k < cfg.th_depth)]
        ids = row[feat]
        alive = m.mp_valid[ids]
        feat, ids = feat[alive], ids[alive]
        if len(feat) == 0:
            continue
        lvl_req = np.zeros(m.mp_valid.shape[0], np.int32)
        lvl_req[ids] = m.kf_level[k, feat] + 1
        in_sel = np.zeros(m.mp_valid.shape[0], bool)
        in_sel[ids] = True
        obs = m.kf_feat_mp[:n]
        hit = (obs >= 0) & in_sel[np.maximum(obs, 0)] & m.kf_valid[:n, None]
        hit[k] = False
        kk, ff = np.nonzero(hit)
        oid = obs[kk, ff]
        good = m.kf_level[kk, ff] <= lvl_req[oid]
        cnt = np.zeros(m.mp_valid.shape[0], np.int32)
        np.add.at(cnt, oid[good], 1)
        if (cnt[ids] >= 3).sum() > 0.9 * len(feat):
            victims.append(k)
    return victims


def cull_points(map_state: MapState, cfg: SlamConfig):
    """MapPointCulling (LocalMapping.cc:200-235): drop points with a bad
    found/visible ratio or too few observations shortly after creation."""
    mp = map_state.mp_valid
    ratio = map_state.mp_found / np.maximum(map_state.mp_visible, 1)
    # Age in keyframes via the monotonic insertion sequence (slots recycle).
    age = map_state.next_kf_seq - 1 - map_state.mp_first_seq
    bad = mp & (
        ((ratio < 0.25) & (map_state.mp_visible >= 4))
        | ((age >= 2) & (map_state.mp_n_obs <= 1) & (map_state.mp_first_seq > 0))
    )
    ids = np.flatnonzero(bad)
    if len(ids):
        map_state.cull_map_points(ids)
    return len(ids)
