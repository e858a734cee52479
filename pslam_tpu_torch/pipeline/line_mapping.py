"""Host-side line & structural-line bookkeeping (port of
``pslam_tpu/pipeline/line_mapping.py``, host numpy line for line).

The numpy complement of ops/line_match.py + solver/ba_lil.py: map-line/LIL
creation at keyframes (CreateNewKeyFrame line path, Tracking.cc:1516-1605;
insectline.cc ctor), LIL-edge assembly for local BA (Optimizer.cc:2274-2346),
and line/LIL culling (LocalMapping::MapLineCulling, LocalMapping.cc:237-273).
Per-frame plane association and local map-line matching
(Map::AssociatePlanesByBoundary, LSDmatcher::SearchByProjection) live on
the device inside pipeline/frame_step.py.
"""

from __future__ import annotations

import numpy as np

import torch

from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.solver.ba_lil import LILBAEdges
from pslam_tpu_torch.utils.config import SlamConfig


def world_points_of_lil(state_c: np.ndarray, T_cw: np.ndarray) -> np.ndarray:
    """Camera-frame LIL 5-point state (..., 15) -> world frame."""
    pts = state_c.reshape(*state_c.shape[:-1], 5, 3)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    pts_w = (pts - t) @ R  # R^T (X_c - t), row-vector form
    return pts_w.reshape(state_c.shape)


def world_plane(plane_c: np.ndarray, T_cw: np.ndarray) -> np.ndarray:
    """Camera-frame plane(s) (..., 4) [n, d] (n.X + d = 0) -> world frame,
    sign-fixed to d >= 0 (Frame::ComputeWorldPlane + the flip in
    AssociatePlanesByBoundary, Map.cc:231-233)."""
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    n_c = plane_c[..., :3]
    d_c = plane_c[..., 3]
    n_w = n_c @ R  # R^T n_c
    d_w = d_c + n_c @ t
    pl = np.concatenate([n_w, d_w[..., None]], axis=-1)
    flip = pl[..., 3] < 0
    pl[flip] = -pl[flip]
    return pl.astype(np.float32)


def lil_obs8(lil) -> np.ndarray:
    """Pack per-frame LIL measurements [eq1, eq2, cross2d] -> (QF, 8)."""
    return np.concatenate(
        [np.asarray(lil.eq1), np.asarray(lil.eq2), np.asarray(lil.cross2d)],
        axis=-1,
    ).astype(np.float32)


def create_or_attach_lils(m: MapState, kf_idx: int, hf, T_cw) -> int:
    """At keyframe creation: attach associated LIL observations, promote the
    rest to new map InsectLines. Returns number created."""
    lil = hf.lil
    valid = np.asarray(lil.valid)
    obs8 = lil_obs8(lil)
    assoc = hf.lil_il  # (QF,) association from tracking

    attach = np.flatnonzero(valid & (assoc >= 0))
    if len(attach):
        m.attach_lil_observations(kf_idx, attach, assoc[attach], obs8[attach])

    state_c = np.concatenate(
        [
            np.asarray(lil.p1s), np.asarray(lil.p1e),
            np.asarray(lil.p2s), np.asarray(lil.p2e),
            np.asarray(lil.cross3d),
        ],
        axis=-1,
    ).astype(np.float32)
    new = np.flatnonzero(valid & (assoc < 0))
    if len(new):
        st_w = world_points_of_lil(state_c[new], T_cw)
        pl_w = world_plane(np.asarray(lil.plane)[new], T_cw)
        ids = m.create_lils(kf_idx, new, st_w, pl_w, obs8[new])
        hf.lil_il[new] = ids
    return len(new)


def create_or_attach_lines(m: MapState, kf_idx: int, hf, T_cw) -> int:
    """Store line features on the KF; create map lines for 3D-valid lines
    without a map association; attach tracked ones."""
    NL = m.kf_line_sp.shape[1]
    m.kf_line_sp[kf_idx] = hf.line_sp
    m.kf_line_ep[kf_idx] = hf.line_ep
    m.kf_line_desc[kf_idx] = hf.line_desc
    m.kf_line_valid[kf_idx] = hf.line_valid
    m.kf_line_p3s[kf_idx] = hf.line_p3s
    m.kf_line_p3e[kf_idx] = hf.line_p3e
    m.kf_line_ok3d[kf_idx] = hf.line_ok3d
    tracked = hf.line_ml >= 0
    m.kf_line_ml[kf_idx] = np.where(hf.line_valid & tracked, hf.line_ml, -1)
    att = m.kf_line_ml[kf_idx]
    np.add.at(m.ml_n_obs, att[att >= 0], 1)

    new = np.flatnonzero(hf.line_valid & ~tracked & hf.line_ok3d)
    if len(new) == 0:
        return 0
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    sp_w = (hf.line_p3s[new] - t) @ R
    ep_w = (hf.line_p3e[new] - t) @ R
    pos_w = np.concatenate([sp_w, ep_w], axis=-1).astype(np.float32)
    ids = m.create_map_lines(kf_idx, new, pos_w, hf.line_desc[new])
    hf.line_ml[new] = ids
    return len(ids)


def assemble_lil_edges(m: MapState, cam_ids, cfg: SlamConfig, device):
    """Gather LIL states + observation edges for the local BA camera set.

    Returns (lil_state (Q,15), lil_valid (Q,), LILBAEdges, il_ids (Q,)) with
    the first three on ``device`` and ``il_ids`` host numpy, or None if no
    LIL edge involves these cameras. Q = number of distinct LILs observed
    (padded to a power-of-two bucket).
    """
    e_cam, e_il, e_obs = [], [], []
    for s, k in enumerate(cam_ids):
        slots = np.flatnonzero(m.kf_lil_il[k] >= 0)
        for q in slots:
            il = m.kf_lil_il[k, q]
            if not m.il_valid[il]:
                continue
            e_cam.append(s)
            e_il.append(il)
            e_obs.append(m.kf_lil_obs[k, q])
    if not e_cam:
        return None
    e_cam = np.asarray(e_cam, np.int32)
    e_il_global = np.asarray(e_il, np.int32)
    e_obs = np.asarray(e_obs, np.float32)

    il_ids = np.unique(e_il_global)
    slot_of = {int(g): i for i, g in enumerate(il_ids)}
    e_il = np.asarray([slot_of[int(g)] for g in e_il_global], np.int32)

    # Pad to fixed capacities (compile-shape buckets).
    Emax = cfg.caps.ba_lil_edges
    Qmax = max(16, 1 << (len(il_ids) - 1).bit_length())
    n_e = min(len(e_cam), Emax)

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[: min(len(a), shape[0])] = a[: shape[0]]
        return out

    def t(a):
        return torch.from_numpy(a).to(device)

    edges = LILBAEdges(
        cam_idx=t(pad(e_cam, (Emax,)).astype(np.int64)),
        lil_idx=t(pad(e_il, (Emax,)).astype(np.int64)),
        obs=t(pad(e_obs, (Emax, 8))),
        valid=t(pad(np.ones(n_e, bool), (Emax,))),
    )
    lil_state = t(pad(m.il_state[il_ids], (Qmax, 15)).astype(np.float32))
    lil_valid = t(pad(np.ones(len(il_ids), bool), (Qmax,)))
    return lil_state, lil_valid, edges, pad(il_ids, (Qmax,), -1)


def local_map_lines(m: MapState, kf_ids, cap: int = 512) -> np.ndarray:
    """Union of map lines observed by the given KFs (UpdateLocalLines,
    Tracking.cc:1887-1903)."""
    if len(kf_ids) == 0:
        return np.zeros(0, np.int32)
    ml = m.kf_line_ml[np.asarray(kf_ids)].reshape(-1)
    ml = np.unique(ml[ml >= 0])
    ml = ml[m.ml_valid[ml]]
    if len(ml) > cap:
        ml = ml[np.argsort(-m.ml_n_obs[ml])[:cap]]
    return ml.astype(np.int32)


def _desc_dist2_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, Nb) squared-L2 distances between float band descriptors."""
    d = a[:, None, :] - b[None, :, :]
    return np.einsum("abd,abd->ab", d, d)


def _mutual_nn_np(dist, valid_a, valid_b, max_dist, ratio=0.85):
    """Host mutual-NN with ratio test on a float distance matrix.
    Returns (Na,) index into b or -1."""
    BIG = 1e18
    d = np.where(valid_a[:, None] & valid_b[None, :], dist, BIG)
    best_j = np.argmin(d, axis=1)
    best = d[np.arange(d.shape[0]), best_j]
    d2 = d.copy()
    d2[np.arange(d.shape[0]), best_j] = BIG
    second = d2.min(axis=1)
    col_best = np.argmin(d, axis=0)
    mutual = col_best[best_j] == np.arange(d.shape[0])
    ok = (best <= max_dist) & (best < ratio * second) & mutual
    return np.where(ok, best_j, -1)


def _project_ep_np(cam, T_cw, X_w):
    """(N, 3) world points -> (u, v, z) in the view (host numpy)."""
    Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    zs = np.maximum(z, 1e-9)
    u = cam.fx * Xc[:, 0] / zs + cam.cx
    v = cam.fy * Xc[:, 1] / zs + cam.cy
    return u, v, z


def _endpoint_chi2_ok(cam, T_cw, sp_w, ep_w, obs_sp, obs_ep, chi2=5.991):
    """The reference's 4-endpoint reprojection gate in ONE view
    (LocalMapping.cc:662-710): both projected 3D endpoints must fall within
    chi2*sigma^2 of the observed 2D endpoints (sigma = 1, single line
    octave). Endpoint order may be swapped between detections, so the
    swapped pairing is accepted too (the reference's detector guarantees
    ordering; ours does not)."""
    us, vs, zs = _project_ep_np(cam, T_cw, sp_w)
    ue, ve, ze = _project_ep_np(cam, T_cw, ep_w)
    front = (zs > 0) & (ze > 0)
    e_ss = (us - obs_sp[:, 0]) ** 2 + (vs - obs_sp[:, 1]) ** 2
    e_ee = (ue - obs_ep[:, 0]) ** 2 + (ve - obs_ep[:, 1]) ** 2
    e_se = (us - obs_ep[:, 0]) ** 2 + (vs - obs_ep[:, 1]) ** 2
    e_es = (ue - obs_sp[:, 0]) ** 2 + (ve - obs_sp[:, 1]) ** 2
    direct = (e_ss <= chi2) & (e_ee <= chi2)
    swapped = (e_se <= chi2) & (e_es <= chi2)
    return front & (direct | swapped)


def create_new_map_lines(m: MapState, kf: int, cfg: SlamConfig) -> int:
    """CreateNewMapLines2, RGB-D path (LocalMapping.cc:522-759): per
    covisible neighbour, brute-force mutual-NN descriptor matching of
    UNBOUND 2D lines (LSDmatcher::SearchForTriangulation,
    add_src/LSDmatcher.cpp:705-743), 3D endpoints from the depth fit of
    EITHER view (LocalMapping.cc:619-639), then the 4-endpoint reprojection
    chi^2 <= 5.991 sigma^2 gate in BOTH views (:662-710). Survivors become
    map lines observed by both KFs."""
    neighbors = m.best_covisible(kf, 10)
    if len(neighbors) == 0:
        return 0
    cam = cfg.camera
    T1 = m.kf_pose[kf]
    T1_wc = np.linalg.inv(T1)
    C1 = m.kf_camera_center(kf)
    created_ids = []
    for nkf in neighbors:
        nkf = int(nkf)
        # Baseline gate (stereo/RGB-D branch, LocalMapping.cc:560-567).
        if np.linalg.norm(m.kf_camera_center(nkf) - C1) < cam.baseline:
            continue
        free1 = m.kf_line_valid[kf] & (m.kf_line_ml[kf] < 0)
        free2 = m.kf_line_valid[nkf] & (m.kf_line_ml[nkf] < 0)
        if not free1.any() or not free2.any():
            continue
        dist = _desc_dist2_np(m.kf_line_desc[kf], m.kf_line_desc[nkf])
        idx2 = _mutual_nn_np(dist, free1, free2, max_dist=0.8)
        i1 = np.flatnonzero(idx2 >= 0)
        if len(i1) == 0:
            continue
        i2 = idx2[i1]

        # 3D from the depth fit of either view (world frame).
        T2 = m.kf_pose[nkf]
        T2_wc = np.linalg.inv(T2)
        ok1 = m.kf_line_ok3d[kf, i1]
        ok2 = m.kf_line_ok3d[nkf, i2]
        sp_w = np.where(
            ok1[:, None],
            m.kf_line_p3s[kf, i1] @ T1_wc[:3, :3].T + T1_wc[:3, 3],
            m.kf_line_p3s[nkf, i2] @ T2_wc[:3, :3].T + T2_wc[:3, 3],
        )
        ep_w = np.where(
            ok1[:, None],
            m.kf_line_p3e[kf, i1] @ T1_wc[:3, :3].T + T1_wc[:3, 3],
            m.kf_line_p3e[nkf, i2] @ T2_wc[:3, :3].T + T2_wc[:3, 3],
        )
        has3d = ok1 | ok2  # "no stereo and very low parallax" -> skip

        good = (
            has3d
            & _endpoint_chi2_ok(
                cam, T1, sp_w, ep_w,
                m.kf_line_sp[kf, i1], m.kf_line_ep[kf, i1],
            )
            & _endpoint_chi2_ok(
                cam, T2, sp_w, ep_w,
                m.kf_line_sp[nkf, i2], m.kf_line_ep[nkf, i2],
            )
        )
        sel = np.flatnonzero(good)
        if len(sel) == 0:
            continue
        f1, f2 = i1[sel], i2[sel]
        pos_w = np.concatenate([sp_w[sel], ep_w[sel]], axis=1).astype(
            np.float32
        )
        ids = m.create_map_lines(kf, f1, pos_w, m.kf_line_desc[kf, f1])
        m.kf_line_ml[nkf, f2] = ids
        np.add.at(m.ml_n_obs, ids, 1)
        created_ids.append(ids)
    if not created_ids:
        return 0
    ids = np.concatenate(created_ids)
    m.update_line_stats(ids)
    return len(ids)


def _fuse_lines_into_kf(m: MapState, t: int, cand: np.ndarray, cfg: SlamConfig):
    """LSDmatcher::Fuse (add_src/LSDmatcher.cpp:847): project candidate map
    lines into KF ``t``, gate by endpoint-in-image, distance band, viewing
    angle; best descriptor match <= TH; replace-or-add."""
    cam = cfg.camera
    T = m.kf_pose[t]
    C = m.kf_camera_center(t)
    pos = m.ml_pos[cand]
    us, vs, zs = _project_ep_np(cam, T, pos[:, :3])
    ue, ve, ze = _project_ep_np(cam, T, pos[:, 3:])
    in_img = (
        (zs > 0) & (ze > 0)
        & (us >= 0) & (us < cam.width) & (vs >= 0) & (vs < cam.height)
        & (ue >= 0) & (ue < cam.width) & (ve >= 0) & (ve < cam.height)
    )
    mid = 0.5 * (pos[:, :3] + pos[:, 3:])
    om = mid - C[None, :]
    dist = np.linalg.norm(om, axis=1)
    band = (dist >= 0.8 * m.ml_min_dist[cand]) & (
        dist <= 1.2 * m.ml_max_dist[cand]
    )
    viewcos = np.einsum("ij,ij->i", om, m.ml_normal[cand]) / np.maximum(
        dist, 1e-9
    )
    vis = in_img & band & (viewcos > 0.5) & m.ml_valid[cand]
    if not vis.any():
        return 0

    # Segment-proximity + direction + descriptor matching against the KF's
    # line features (GetLinesInArea + descriptor loop of Fuse).
    f_valid = m.kf_line_valid[t]
    f_sp, f_ep = m.kf_line_sp[t], m.kf_line_ep[t]
    proj_sp = np.stack([us, vs], axis=1)
    proj_ep = np.stack([ue, ve], axis=1)

    def seg_dist(p):
        d = f_ep - f_sp  # (NF, 2)
        len2 = np.maximum(np.einsum("fj,fj->f", d, d), 1e-12)
        tpar = np.clip(
            np.einsum("mfj,fj->mf", p[:, None, :] - f_sp[None, :, :], d)
            / len2[None, :],
            0.0, 1.0,
        )
        proj = f_sp[None] + tpar[:, :, None] * d[None]
        return np.linalg.norm(p[:, None, :] - proj, axis=-1)

    radius = 8.0
    near = (seg_dist(proj_sp) <= radius) & (seg_dist(proj_ep) <= radius)
    dir_m = proj_ep - proj_sp
    dir_m /= np.maximum(np.linalg.norm(dir_m, axis=1, keepdims=True), 1e-9)
    dir_f = f_ep - f_sp
    dir_f /= np.maximum(np.linalg.norm(dir_f, axis=1, keepdims=True), 1e-9)
    cos = np.abs(dir_m @ dir_f.T)
    dd = _desc_dist2_np(m.ml_desc[cand], m.kf_line_desc[t])
    mask = near & (cos >= 0.9848) & vis[:, None] & f_valid[None, :]
    dd = np.where(mask, dd, 1e18)
    best_f = np.argmin(dd, axis=1)
    best_d = dd[np.arange(len(cand)), best_f]
    hit = best_d <= 0.8

    n_fused = 0
    for s in np.flatnonzero(hit):
        ml = int(cand[s])
        if not m.ml_valid[ml]:
            continue
        f = int(best_f[s])
        existing = int(m.kf_line_ml[t, f])
        if existing == ml:
            continue
        if existing >= 0 and m.ml_valid[existing]:
            if m.ml_n_obs[existing] > m.ml_n_obs[ml]:
                m.replace_map_line(ml, existing)
            else:
                m.replace_map_line(existing, ml)
        else:
            m.kf_line_ml[t, f] = ml
            m.ml_n_obs[ml] += 1
        n_fused += 1
    return n_fused


def fuse_lines_in_neighbors(m: MapState, kf: int, cfg: SlamConfig) -> int:
    """The line half of SearchInNeighbors (LocalMapping.cc:761-891 calls
    LSDmatcher::Fuse for the 1/2-hop targets): fuse the new KF's map lines
    into each neighbour, then the neighbours' lines back into the new KF."""
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
        return 0

    row = m.kf_line_ml[kf]
    own = np.unique(row[row >= 0])
    own = own[m.ml_valid[own]]
    n_fused = 0
    for t in targets:
        if len(own) == 0:
            break
        trow = m.kf_line_ml[t]
        # IsInKeyFrame skip: never fuse a line into a KF already observing it.
        own_t = own[~np.isin(own, trow[trow >= 0])]
        if len(own_t):
            n_fused += _fuse_lines_into_kf(m, t, own_t, cfg)

    cand = m.kf_line_ml[np.asarray(targets)].reshape(-1)
    cand = np.unique(cand[cand >= 0])
    cand = cand[m.ml_valid[cand]]
    row = m.kf_line_ml[kf]
    cand = cand[~np.isin(cand, row[row >= 0])]
    if len(cand):
        n_fused += _fuse_lines_into_kf(m, kf, cand, cfg)

    if n_fused:
        touched = np.unique(np.concatenate([own, cand]))
        m.update_line_stats(touched)
    return n_fused


def cull_lines(m: MapState, cfg: SlamConfig) -> int:
    """MapLineCulling analogue (LocalMapping.cc:237-273): bad found/visible
    ratio or too few observations shortly after creation."""
    ratio = m.ml_found / np.maximum(m.ml_visible, 1)
    # Monotonic age (see local_mapping.cull_points: slots are recycled).
    age = m.next_kf_seq - 1 - m.ml_first_seq
    bad = m.ml_valid & (
        ((ratio < 0.25) & (m.ml_visible >= 4))
        | ((age >= 2) & (m.ml_n_obs <= 1) & (m.ml_first_seq > 0))
    )
    ids = np.flatnonzero(bad)
    if len(ids):
        m.cull_map_lines(ids)
    return len(ids)


def cull_lils_by_quality(m: MapState, cfg: SlamConfig) -> int:
    """InsectLine probation culling (insectline.cc:22,39-43): a LIL is only
    'good' once plane-associated by > observe_th distinct frames (mbBadPre)
    and observed from >= 2 keyframes (mbBad). The reference merely leaves
    failures flagged bad; here they are reclaimed once their probation
    window (in keyframe insertions) has passed, so the LIL table stays
    bounded by quality rather than capacity."""
    pa = cfg.plane_assoc
    age = m.next_kf_seq - 1 - m.il_first_seq
    immature = (m.il_frame_obs <= pa.observe_th) | (m.il_n_obs < 2)
    bad = m.il_valid & (age >= pa.probation_kfs) & immature
    ids = np.flatnonzero(bad)
    if len(ids):
        m.cull_lils(ids)
    return len(ids)
