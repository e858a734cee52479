"""Loop closing: detection, Sim3 computation, loop correction, global BA (port
of ``pslam_tpu/pipeline/loop_closing.py``).

Re-implements LoopClosing (reference src/LoopClosing.cc), which the reference
ships disabled (``while(0)``, LoopClosing.cc:61) and BASELINE config 4 turns
on:

- ``detect_loop``: BoW candidates below the covisibility min-score with
  3-consecutive consistency groups (LoopClosing.cc:103-229, th=3 at :43);
- ``compute_sim3``: SearchByBoW matches -> fixed-budget Sim3 RANSAC
  (solver/horn.py) -> optimize_sim3 (solver/sim3_graph.py) -> guided
  projection matching, accept at >= 40 matches (LoopClosing.cc:231-401),
  then a metric 3D-3D refine of the corrected pose;
- ``correct_loop``: propagate the corrected Sim3 over the current covisible
  group, retransform their landmarks, fuse duplicates, optimize the
  essential graph with the loop keyframe fixed, then global BA
  (LoopClosing.cc:402-615 + RunGlobalBundleAdjustment 645-750), synchronous.

For RGB-D the Sim3 scale is fixed (mbFixScale for non-mono sensors,
System.cc:95), as in the reference. The RANSAC draws come from CPU
generators seeded with ``kf * 977 + rank`` (Sim3) and ``kf * 1301 + rank``
(3D-3D refine), the integers of the JAX package's PRNG keys.
"""

from __future__ import annotations

import numpy as np
import torch

from pslam_tpu_torch.geometry import Camera, in_image
from pslam_tpu_torch.geometry.camera import project
from pslam_tpu_torch.geometry.lie import (
    Sim3,
    sim3_compose,
    sim3_exp,
    sim3_from_se3,
    sim3_inverse,
    sim3_log,
    sim3_to_se3,
    sim3_transform_points,
)
from pslam_tpu_torch.models.map_state import COVIS_TH
from pslam_tpu_torch.ops.bow import bow_group_mask, score_l1
from pslam_tpu_torch.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
    window_mask,
)
from pslam_tpu_torch.parallel.sharded_ba import solver_ranks
from pslam_tpu_torch.pipeline.global_ba import run_global_ba
from pslam_tpu_torch.solver.horn import ransac_priorities, se3_ransac_3d3d, sim3_ransac
from pslam_tpu_torch.solver.sim3_graph import (
    PoseGraphProblem,
    optimize_essential_graph,
    optimize_sim3,
)

CONSISTENCY_TH = 3  # mnCovisibilityConsistencyTh (LoopClosing.cc:43)
MIN_BOW_MATCHES = 20  # LoopClosing.cc:282
MIN_SIM3_INLIERS = 20  # LoopClosing.cc:333 (OptimizeSim3 >= 20)
MIN_TOTAL_MATCHES = 40  # LoopClosing.cc:392
ESSENTIAL_MIN_WEIGHT = 100  # minFeat covis edges (Optimizer.cc:2673)
SIM3_CAP = 512  # fixed capacity of the Sim3 RANSAC / refine match sets
SIM3_TRIALS = 128
REFINE_TRIALS = 256


def _np(t):
    return t.detach().cpu().numpy()


def _match_kf_bow(desc1, angle1, node1, ok1, desc2, angle2, node2, ok2):
    """SearchByBoW between two keyframes' feature sets (ORBmatcher.cc:522):
    bucket-restricted mutual NN with rotation consistency. Returns idx (N1,)
    -> feature in KF2 or -1."""
    idx, _ = mutual_nn_match(
        hamming_matrix(desc1, desc2), valid_a=ok1, valid_b=ok2, max_dist=TH_LOW,
        ratio=0.75, extra_mask=bow_group_mask(node1, node2),
    )
    keep = rotation_consistency_mask(angle1, angle2[torch.clamp(idx, min=0)], idx >= 0)
    return torch.where(keep, idx, -1)


def _match_by_projection_sim3(cam: Camera, Scw: Sim3, pos_w, desc_p, ok_p, f_uv, f_desc,
                              f_ok, radius):
    """ORBmatcher::SearchByProjection with a Sim3 world->cam (ORBmatcher.cc:290):
    project candidate world points through Scw into a keyframe's features,
    windowed Hamming NN. Returns idx (P,) -> feature or -1."""
    Xc = sim3_transform_points(Scw, pos_w)
    uv = project(cam, Xc)
    vis = ok_p & (Xc[:, 2] > 0.05) & in_image(cam, uv, margin=1.0)
    idx, _ = mutual_nn_match(
        hamming_matrix(desc_p, f_desc), valid_a=vis, valid_b=f_ok, max_dist=TH_LOW,
        ratio=0.99, extra_mask=window_mask(uv, f_uv, radius),
    )
    return idx


class LoopCloser:
    def __init__(self, system):
        self.sys = system
        self.device = system.device
        # Consistency groups hold KF sequence numbers (KeyFrame::mnId), not
        # slot indices: slots are recycled after culling, and a recycled slot
        # would alias a stale group member onto an unrelated new KF.
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_seq = -100  # seq of the last accepted loop KF
        self.loop_edges: list[tuple[int, int]] = []  # (kf, loop_kf) accepted
        self.stats = {"detected": 0, "closed": 0, "gba_runs": 0}

    def _t(self, a):
        return torch.tensor(np.asarray(a), device=self.device)

    def _sim3_of(self, T) -> Sim3:
        """Sim3 (scale 1) of a host SE3 pose, on the device."""
        return sim3_from_se3(self._t(np.asarray(T, np.float32)))

    # -- DetectLoop (LoopClosing.cc:103-229) ---------------------------------

    def detect_loop(self, kf: int) -> list[int]:
        m = self.sys.map
        db = self.sys.kf_db
        # Gate on the monotonic insertion sequence (the reference compares
        # mnId, LoopClosing.cc:110), never the recyclable slot index.
        if db is None or m.kf_seq[kf] < self.last_loop_seq + 10 or int(m.kf_valid.sum()) < 10:
            return []
        covis = m.covisible_kfs(kf)
        if len(covis) == 0:
            return []
        min_score = float(_np(score_l1(self._t(db.bow[kf]), self._t(db.bow[covis]))).min())
        cands = db.detect_loop_candidates(kf, min_score, m)
        if len(cands) == 0:
            self.consistent_groups = []
            return []
        # Consistency groups (LoopClosing.cc:152-211).
        enough = []
        current_groups: list[tuple[set, int]] = []
        for c in cands:
            group = {int(m.kf_seq[c])} | {int(m.kf_seq[j]) for j in m.covisible_kfs(int(c))}
            best_consistency = 0
            for prev_group, n in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, n + 1)
            current_groups.append((group, best_consistency))
            if best_consistency >= CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = current_groups
        return enough

    # -- ComputeSim3 (LoopClosing.cc:231-401) --------------------------------

    def _feat_ok(self, k: int):
        mp = self.sys.map.kf_feat_mp[k]
        return (mp >= 0) & self.sys.map.mp_valid[np.maximum(mp, 0)]

    def compute_sim3(self, kf: int, candidates: list[int]):
        """Returns (loop_kf, Scw_corrected (Sim3), loop_mp_ids (P,), proj_idx,
        sigma_c) or None. loop_mp_ids = map points of the loop neighbourhood
        used for fusion."""
        sys_, m = self.sys, self.sys.map
        cfg = sys_.cfg
        db = sys_.kf_db
        cam = cfg.camera
        sigma2 = np.asarray([(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32)
        for rank, cand in enumerate(candidates):
            idx = _np(_match_kf_bow(
                self._t(m.kf_desc[kf]), self._t(m.kf_angle[kf]),
                self._t(db.node[kf].astype(np.int64)), self._t(self._feat_ok(kf)),
                self._t(m.kf_desc[cand]), self._t(m.kf_angle[cand]),
                self._t(db.node[cand].astype(np.int64)), self._t(self._feat_ok(cand)),
            ))
            pairs = np.flatnonzero(idx >= 0)
            if len(pairs) < MIN_BOW_MATCHES:
                continue
            f1 = pairs
            f2 = idx[pairs]
            mp1 = m.kf_feat_mp[kf, f1]
            mp2 = m.kf_feat_mp[cand, f2]

            # Camera-frame landmark positions for the Horn RANSAC.
            T1 = m.kf_pose[kf]
            T2 = m.kf_pose[cand]
            X1 = m.mp_pos[mp1] @ T1[:3, :3].T + T1[:3, 3]
            X2 = m.mp_pos[mp2] @ T2[:3, :3].T + T2[:3, 3]
            uv1 = m.kf_uv[kf, f1]
            uv2 = m.kf_uv[cand, f2]
            is2_1 = 1.0 / sigma2[np.clip(m.kf_level[kf, f1], 0, len(sigma2) - 1)]
            is2_2 = 1.0 / sigma2[np.clip(m.kf_level[cand, f2], 0, len(sigma2) - 1)]

            # Fixed-capacity padding, as in the JAX package (one shape for
            # every loop attempt).
            n = min(len(f1), SIM3_CAP)

            def pad(a):
                out = np.zeros((SIM3_CAP,) + a.shape[1:], np.float32)
                out[:n] = a[:n]
                return self._t(out)

            vmask = self._t(np.arange(SIM3_CAP) < n)
            args = (pad(X1), pad(X2), pad(uv1), pad(uv2), pad(is2_1), pad(is2_2))
            r = sim3_ransac(
                cam, *args, vmask,
                ransac_priorities(kf * 977 + rank, SIM3_TRIALS, SIM3_CAP, self.device),
                fix_scale=True,  # RGB-D (System.cc:95)
            )
            if int(r.n_inliers) < MIN_SIM3_INLIERS:
                continue
            g12 = Sim3(s=r.s12, R=r.R12, t=r.t12)  # cam2(cand) -> cam1(kf)
            res = optimize_sim3(cam, g12, *args, r.inlier & vmask, fix_scale=True)
            if int(res.n_inliers) < MIN_SIM3_INLIERS:
                continue

            # Corrected current-KF Sim3: Scw = g12 o S(cand world->cam).
            Scw = sim3_compose(res.g12, self._sim3_of(T2))

            # Guided projection matching against the loop neighbourhood's map
            # points (SearchByProjection, LoopClosing.cc:373-395).
            hood = np.unique(np.r_[[cand], m.covisible_kfs(cand)].astype(np.int64))
            mp_ids = m.local_map_points(hood, cfg.caps.local_points)
            if len(mp_ids) == 0:
                continue
            pidx = self._project_hood(kf, Scw, self._hood_arrays(mp_ids), 8.0)[: len(mp_ids)]
            if int((pidx >= 0).sum()) < MIN_TOTAL_MATCHES:
                continue

            # Metric 3D-3D refinement of Scw (RGB-D): reprojection-only Sim3
            # optimization slides along the homography-ambiguity valley of a
            # plane-dominant neighbourhood; aligning the current KF's depth
            # back-projections to the matched hood landmarks in metres breaks
            # that degeneracy.
            sel = np.flatnonzero(pidx >= 0)
            f = pidx[sel]
            z = m.kf_feat_depth[kf, f]
            Xl = np.zeros((SIM3_CAP, 3), np.float32)
            Xc = np.zeros((SIM3_CAP, 3), np.float32)
            vmask3 = np.zeros(SIM3_CAP, bool)
            nr = min(len(sel), SIM3_CAP)
            uvf = m.kf_uv[kf, f[:nr]]
            zf = z[:nr]
            Xc[:nr, 0] = (uvf[:, 0] - cam.cx) / cam.fx * zf
            Xc[:nr, 1] = (uvf[:, 1] - cam.cy) / cam.fy * zf
            Xc[:nr, 2] = zf
            Xl[:nr] = m.mp_pos[mp_ids[sel[:nr]]]
            vmask3[:nr] = (z > 0)[:nr]
            # Constraint noise floor when the metric refinement cannot run.
            sigma_c = 0.03
            if int(vmask3.sum()) >= 30:
                T3, inl3, n3 = se3_ransac_3d3d(
                    self._t(Xl), self._t(Xc), self._t(vmask3),
                    ransac_priorities(kf * 1301 + rank, REFINE_TRIALS, SIM3_CAP, self.device),
                    inlier_th=0.05,
                )
                if int(n3) >= 30:
                    Scw = sim3_from_se3(T3)
                    # Constraint self-noise: RMS of the inlier 3D-3D residuals
                    # in metres (they share the map's structure error, so they
                    # do not average out with n).
                    T3h = _np(T3)
                    resid = (Xl @ T3h[:3, :3].T + T3h[:3, 3]) - Xc
                    im = _np(inl3) & vmask3
                    if im.any():
                        sigma_c = float(np.sqrt(np.mean(np.sum(resid[im] ** 2, -1))))

            self.stats["detected"] += 1
            return cand, Scw, mp_ids, pidx, sigma_c
        return None

    # -- CorrectLoop (LoopClosing.cc:402-615) --------------------------------

    def correct_loop(self, kf: int, loop_kf: int, Scw: Sim3, loop_mp_ids, proj_idx):
        sys_, m = self.sys, self.sys.map
        # InterruptBA (LoopClosing.cc:404-418 RequestStop + mbAbortBA): the
        # in-flight local BA was solved against pre-correction poses, so it
        # is discarded rather than let clobber the corrected map.
        sys_._interrupt_ba()
        cfg = sys_.cfg
        K = m.n_kf

        poses_before = m.kf_pose[:K].copy()
        covis_before = m.covis[:K, :K].copy()

        # Current covisible group + corrected Sim3 propagation
        # (LoopClosing.cc:437-470).
        group = np.unique(np.r_[[kf], m.covisible_kfs(kf)].astype(np.int64))
        T_kf_old_inv = np.linalg.inv(poses_before[kf])
        S_corr = {int(kf): Scw}
        for k in group:
            k = int(k)
            if k != kf:
                S_corr[k] = sim3_compose(self._sim3_of(m.kf_pose[k] @ T_kf_old_inv), Scw)

        # Retransform landmarks seen by the group and update the group poses
        # (LoopClosing.cc:471-514): X <- S_corr^-1 (S_old (X)).
        corrected_pts = set()
        for k, S_k in S_corr.items():
            warp = sim3_compose(sim3_inverse(S_k), self._sim3_of(poses_before[k]))
            mp = m.kf_feat_mp[k]
            ids = np.unique(mp[mp >= 0])
            ids = ids[m.mp_valid[ids]]
            ids = np.asarray([i for i in ids if i not in corrected_pts], np.int64)
            if len(ids):
                m.mp_pos[ids] = _np(sim3_transform_points(warp, self._t(m.mp_pos[ids])))
                corrected_pts.update(int(i) for i in ids)
            self._warp_lines_lils(k, warp)
            m.kf_pose[k] = _np(sim3_to_se3(S_k))

        # SearchAndFuse over the whole corrected group (LoopClosing.cc:516-537
        # + SearchAndFuse at :587): a duplicate is replaced globally
        # (MapPoint::Replace), so every observer switches to the loop point.
        hood = self._hood_arrays(loop_mp_ids)
        for k, S_k in S_corr.items():
            pidx = self._project_hood(k, S_k, hood, 8.0)
            for i in np.flatnonzero(pidx[: len(loop_mp_ids)] >= 0):
                lmp = int(loop_mp_ids[i])
                f = int(pidx[i])
                old = int(m.kf_feat_mp[k, f])
                if old == lmp or not m.mp_valid[lmp]:
                    continue
                if old >= 0 and m.mp_valid[old]:
                    m.replace_map_point(old, lmp)
                else:
                    m.kf_feat_mp[k, f] = lmp
                    m.mp_n_obs[lmp] += 1
        for k in S_corr:
            m._update_covisibility(int(k))

        # New loop connections: covisibility edges between the corrected group
        # and the rest of the graph that appeared only through fusion
        # (LoopClosing.cc:540-563), measured at the corrected states.
        group_set = set(int(g) for g in S_corr)
        new_conn = []
        for a in group_set:
            for b in np.flatnonzero(m.covis[a, :K] >= ESSENTIAL_MIN_WEIGHT):
                b = int(b)
                if b in group_set or covis_before[a, b] >= COVIS_TH:
                    continue
                new_conn.append((a, b))

        # Essential graph (Optimizer.cc:2536): spanning chain + strong covis
        # + loop edges; loop KF fixed.
        self.loop_edges.append((int(kf), int(loop_kf)))
        S_opt = self._run_essential_graph(K, poses_before, S_corr, loop_kf, covis_before, new_conn)

        # Write back poses, then correct each landmark through its reference
        # KF (Optimizer.cc:2759-2797).
        poses_mid = m.kf_pose[:K].copy()
        s_opt, R_opt, t_opt = (_np(a) for a in S_opt)
        for k in range(K):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_opt[k]
            T[:3, 3] = t_opt[k] / max(s_opt[k], 1e-12)
            m.kf_pose[k] = T
        self._correct_landmarks_by_ref_kf(K, poses_mid, S_opt)

        self.last_loop_seq = int(m.kf_seq[kf])
        self.stats["closed"] += 1

        # Global BA (RunGlobalBundleAdjustment, LoopClosing.cc:645).
        if cfg.loop_gba:
            run_global_ba(m, cfg, self.device)
            self.stats["gba_runs"] += 1

    def _warp_lines_lils(self, k: int, warp: Sim3):
        m = self.sys.map
        if not self.sys.cfg.use_lines:
            return
        ml = m.kf_line_ml[k]
        ids = np.unique(ml[ml >= 0])
        ids = ids[m.ml_valid[ids]] if len(ids) else ids
        if len(ids):
            pos = m.ml_pos[ids].reshape(-1, 3)
            m.ml_pos[ids] = _np(sim3_transform_points(warp, self._t(pos))).reshape(-1, 6)
        il = m.kf_lil_il[k]
        ids = np.unique(il[il >= 0])
        ids = ids[m.il_valid[ids]] if len(ids) else ids
        if len(ids):
            st = m.il_state[ids].reshape(-1, 3)
            m.il_state[ids] = _np(sim3_transform_points(warp, self._t(st))).reshape(-1, 15)
            # Refresh plane (n, d) from the warped support points.
            pts = m.il_state[ids].reshape(-1, 5, 3)
            n = (m.il_plane[ids, :3] @ _np(warp.R).T).astype(np.float32)
            d = -np.einsum("qj,qpj->q", n, pts) / 5.0
            flip = d < 0
            m.il_plane[ids] = np.concatenate(
                [np.where(flip[:, None], -n, n), np.abs(d)[:, None]], axis=1
            ).astype(np.float32)

    def _run_essential_graph(self, K, poses_before, S_corr, loop_kf, covis_before, new_conn):
        Kc = self.sys.cfg.caps.max_keyframes
        s = np.ones(Kc, np.float32)
        R = np.tile(np.eye(3, dtype=np.float32), (Kc, 1, 1))
        t = np.zeros((Kc, 3), np.float32)
        for k in range(K):
            if k in S_corr:
                s[k] = float(_np(S_corr[k].s))
                R[k] = _np(S_corr[k].R)
                t[k] = _np(S_corr[k].t)
            else:
                R[k] = poses_before[k][:3, :3]
                t[k] = poses_before[k][:3, 3]

        # Pre-existing structure edges are measured from pre-correction
        # relative poses (Optimizer.cc:2614-2657: spanning tree + covis >=
        # minFeat use NonCorrectedSim3); loop edges and the new post-fusion
        # loop connections at the corrected states (Optimizer.cc:2601-2612).
        ei, ej, ms, mR, mt = [], [], [], [], []
        inserted = set()

        def add_edge(i, j, Ti, Tj):
            # S_ji = S_j o S_i^-1 from SE3 poses (scale 1).
            if (min(i, j), max(i, j)) in inserted:
                return
            inserted.add((min(i, j), max(i, j)))
            Tji = Tj @ np.linalg.inv(Ti)
            ei.append(i)
            ej.append(j)
            ms.append(1.0)
            mR.append(Tji[:3, :3])
            mt.append(Tji[:3, 3])

        def add_corrected_edge(a, b):
            if (min(a, b), max(a, b)) in inserted:
                return
            inserted.add((min(a, b), max(a, b)))
            Sa = Sim3(*(self._t(x[a]) for x in (s, R, t)))
            Sb = Sim3(*(self._t(x[b]) for x in (s, R, t)))
            Sba = sim3_compose(Sb, sim3_inverse(Sa))
            ei.append(a)
            ej.append(b)
            ms.append(float(_np(Sba.s)))
            mR.append(_np(Sba.R))
            mt.append(_np(Sba.t))

        for a, b in self.loop_edges:
            add_corrected_edge(a, b)
        for a, b in new_conn:
            add_corrected_edge(a, b)
        # Spanning chain over valid KFs in temporal order (slot order is not
        # insertion order once culled slots are recycled).
        m = self.sys.map
        alive = np.flatnonzero(m.kf_valid[:K])
        alive = alive[np.argsort(m.kf_frame_id[alive], kind="stable")]
        for a, b in zip(alive[:-1], alive[1:]):
            add_edge(int(a), int(b), poses_before[a], poses_before[b])
        ii, jj = np.nonzero(np.triu(covis_before, 2) >= ESSENTIAL_MIN_WEIGHT)
        for a, b in zip(ii, jj):
            add_edge(int(a), int(b), poses_before[a], poses_before[b])

        fixed = np.zeros(Kc, bool)
        fixed[loop_kf] = True
        vvalid = np.zeros(Kc, bool)
        vvalid[:K] = m.kf_valid[:K]

        # Distributed path: pad the edge set to the world size and shard it
        # (parallel/sharded_graph.py); identity-measurement padding keeps the
        # masked edges' sim3_log finite.
        ranks = solver_ranks(self.sys.cfg)
        n_dev = ranks.size
        E = len(ei)
        Ep = -(-E // n_dev) * n_dev
        e_i = np.zeros(Ep, np.int64)
        e_j = np.zeros(Ep, np.int64)
        e_s = np.ones(Ep, np.float32)
        e_R = np.tile(np.eye(3, dtype=np.float32), (Ep, 1, 1))
        e_t = np.zeros((Ep, 3), np.float32)
        e_ok = np.zeros(Ep, bool)
        e_i[:E], e_j[:E], e_s[:E] = ei, ej, ms
        e_R[:E], e_t[:E] = np.stack(mR), np.stack(mt)
        e_ok[:E] = True
        prob = PoseGraphProblem(
            S=Sim3(self._t(s), self._t(R), self._t(t)),
            fixed=self._t(fixed),
            vertex_valid=self._t(vvalid),
            e_i=self._t(e_i),
            e_j=self._t(e_j),
            e_Sji=Sim3(self._t(e_s), self._t(e_R), self._t(e_t)),
            e_valid=self._t(e_ok),
        )
        S_opt = optimize_essential_graph(prob, n_iters=20, ranks=ranks)
        return Sim3(*(a[:K] for a in S_opt))

    def _correct_landmarks_by_ref_kf(self, K, poses_mid, S_opt):
        """X <- S_opt_ref^-1 (S_mid_ref (X)) per landmark reference KF."""
        m = self.sys.map
        warps = sim3_compose(sim3_inverse(S_opt), self._sim3_of(poses_mid[:K]))
        w_s, w_R, w_t = (_np(a) for a in warps)
        for k in range(K):
            # Identity check to skip untouched KFs.
            if (abs(float(w_s[k]) - 1) < 1e-7 and np.abs(w_R[k] - np.eye(3)).max() < 1e-7
                    and np.abs(w_t[k]).max() < 1e-7):
                continue
            warp = Sim3(*(a[k] for a in warps))
            ids = np.flatnonzero(m.mp_valid & (m.mp_first_kf == k))
            if len(ids):
                m.mp_pos[ids] = _np(sim3_transform_points(warp, self._t(m.mp_pos[ids])))
            if self.sys.cfg.use_lines:
                lids = np.flatnonzero(m.ml_valid & (m.ml_first_kf == k))
                if len(lids):
                    pos = self._t(m.ml_pos[lids].reshape(-1, 3))
                    m.ml_pos[lids] = _np(sim3_transform_points(warp, pos)).reshape(-1, 6)

    # -- Run (one iteration per new KF; LoopClosing.cc:57-88) ----------------

    def on_new_keyframe(self, kf: int) -> bool:
        cands = self.detect_loop(kf)
        if not cands:
            return False
        out = self.compute_sim3(kf, cands)
        if out is None:
            return False
        loop_kf, Scw, loop_mp_ids, proj_idx, sigma_c = out
        if not self._innovation_supported(kf, Scw, loop_mp_ids):
            # The current pose already explains the loop neighbourhood at
            # least as well as the Sim3 constraint: the map has not drifted
            # beyond the constraint's noise floor. Fuse the duplicates and
            # record the loop edge; skip the pose surgery.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        if not self._group_agrees(kf, Scw, loop_mp_ids):
            # Geometric consistency: a second covisible KF, moved by the same
            # correction, must also explain the loop neighbourhood better
            # than its current pose. A place-recognition alias that fits one
            # keyframe fails here.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        Scw, alpha = self._blend_innovation(kf, Scw, sigma_c)
        self.stats["blend_alpha"] = alpha
        if alpha < 0.2:
            # The correction is dominated by the constraint's own noise.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        self.correct_loop(kf, loop_kf, Scw, loop_mp_ids, proj_idx)
        return True

    def _blend_innovation(self, kf: int, Scw: Sim3, sigma_c: float):
        """Scale the loop innovation by a Kalman-style gain alpha = d^2 /
        (d^2 + sigma_c^2): d is the camera-centre displacement the correction
        asks for, sigma_c the constraint's measured self-noise."""
        T_cur = self.sys.map.kf_pose[kf].astype(np.float32)
        S_cur = self._sim3_of(T_cur)
        C_cur = -T_cur[:3, :3].T @ T_cur[:3, 3]
        s = float(_np(Scw.s))
        R = _np(Scw.R)
        t = _np(Scw.t)
        C_corr = -(R.T @ t) / max(s, 1e-12)
        d = float(np.linalg.norm(C_corr - C_cur))
        alpha = d * d / (d * d + sigma_c * sigma_c + 1e-12)
        if alpha >= 0.95:
            return Scw, alpha
        xi = sim3_log(sim3_compose(Scw, sim3_inverse(S_cur)))
        return sim3_compose(sim3_exp(alpha * xi), S_cur), alpha

    def _hood_arrays(self, loop_mp_ids):
        """The loop neighbourhood's points as padded device arrays (pos, desc,
        ok) and their count."""
        m, P = self.sys.map, self.sys.cfg.caps.local_points
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 32), np.uint8)
        okp = np.zeros(P, bool)
        nn = min(len(loop_mp_ids), P)
        pos[:nn] = m.mp_pos[loop_mp_ids[:nn]]
        desc[:nn] = m.mp_desc[loop_mp_ids[:nn]]
        okp[:nn] = m.mp_valid[loop_mp_ids[:nn]]
        return self._t(pos), self._t(desc), self._t(okp), nn

    def _project_hood(self, k: int, S: Sim3, hood, radius: float):
        """Match the hood points projected through S into KF k's features."""
        m = self.sys.map
        pos, desc, okp, _ = hood
        return _np(_match_by_projection_sim3(
            self.sys.cfg.camera, S, pos, desc, okp, self._t(m.kf_uv[k]),
            self._t(m.kf_desc[k]), self._t(m.kf_feat_valid[k]), radius,
        ))

    def _count_hood(self, k: int, S: Sim3, hood, radius: float = 3.0) -> int:
        return int((self._project_hood(k, S, hood, radius)[: hood[3]] >= 0).sum())

    def _group_agrees(self, kf: int, Scw: Sim3, loop_mp_ids) -> bool:
        """>= 2 covisible KFs must agree on the same Sim3: propagate the
        correction to the strongest covisible neighbours (as correct_loop
        will) and require one of them to explain the loop neighbourhood
        better than its current pose. Neighbours with no view of the hood
        (both counts tiny) are skipped; if none has evidence, the single-KF
        gate stands."""
        m = self.sys.map
        nbrs = m.covisible_kfs(kf)
        if len(nbrs) == 0:
            return True
        order = np.argsort(-m.covis[kf, nbrs])
        hood = self._hood_arrays(loop_mp_ids)
        T_kf_inv = np.linalg.inv(m.kf_pose[kf]).astype(np.float32)
        checked = 0
        for k2 in np.asarray(nbrs)[order][:3]:
            k2 = int(k2)
            S_pred = sim3_compose(self._sim3_of(m.kf_pose[k2] @ T_kf_inv), Scw)
            n_corr = self._count_hood(k2, S_pred, hood)
            n_cur = self._count_hood(k2, self._sim3_of(m.kf_pose[k2]), hood)
            if max(n_corr, n_cur) < 20:
                continue
            checked += 1
            if n_corr > max(1.2 * n_cur, n_cur + 10):
                return True
        return checked == 0

    def _innovation_supported(self, kf: int, Scw: Sim3, loop_mp_ids) -> bool:
        """Evidence gate for the loop innovation: project the loop
        neighbourhood's landmarks into the current KF through both the
        corrected Sim3 and the current pose with a tight window; accept the
        correction only where it explains clearly more matches."""
        hood = self._hood_arrays(loop_mp_ids)
        n_corr = self._count_hood(kf, Scw, hood)
        n_cur = self._count_hood(kf, self._sim3_of(self.sys.map.kf_pose[kf]), hood)
        self.stats["gate_corr"] = n_corr
        self.stats["gate_cur"] = n_cur
        return n_corr > max(1.2 * n_cur, n_cur + 10)

    def fuse_only(self, kf: int, loop_kf: int, loop_mp_ids):
        """Low-innovation loop acceptance: merge duplicate landmarks between
        the current covisible group and the loop neighbourhood using the
        current poses (SearchAndFuse without the Sim3 warp), refresh
        covisibility, and record the loop edge for the essential graph and
        KF-culling protection. ``stats['fuse_only']`` rises by 2 a call, as
        in the JAX package (ROADMAP Queue 3)."""
        self.stats["fuse_only"] = self.stats.get("fuse_only", 0) + 1
        m = self.sys.map
        hood = self._hood_arrays(loop_mp_ids)
        nn = hood[3]
        group = np.unique(np.r_[[kf], m.covisible_kfs(kf)].astype(np.int64))
        for k in group:
            k = int(k)
            pidx = self._project_hood(k, self._sim3_of(m.kf_pose[k]), hood, 4.0)
            for i in np.flatnonzero(pidx[:nn] >= 0):
                lmp = int(loop_mp_ids[i])
                f = int(pidx[i])
                old = int(m.kf_feat_mp[k, f])
                if old == lmp or not m.mp_valid[lmp]:
                    continue
                if old >= 0 and m.mp_valid[old]:
                    m.replace_map_point(old, lmp)
                elif lmp in m.kf_feat_mp[k]:
                    # KF k already observes this loop landmark through another
                    # feature slot; a second binding would double-count it.
                    continue
                else:
                    m.kf_feat_mp[k, f] = lmp
                    m.mp_n_obs[lmp] += 1
            m._update_covisibility(k)
        self.loop_edges.append((int(kf), int(loop_kf)))
        self.last_loop_seq = int(m.kf_seq[kf])
        self.stats["fuse_only"] = self.stats.get("fuse_only", 0) + 1
        self.stats["closed"] += 1
