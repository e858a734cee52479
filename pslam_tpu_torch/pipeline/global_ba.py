"""Global bundle adjustment over the whole map (port of
``pslam_tpu/pipeline/global_ba.py``).

Replaces Optimizer::GlobalBundleAdjustemnt (reference src/Optimizer.cc:41-237,
run by LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:645-750): all
keyframes free except the oldest, all map points marginalized. Reuses the
Schur-complement solver of solver/local_ba.py at the global capacities;
keyframes beyond the free capacity stay fixed (the oldest first).
"""

from __future__ import annotations

import numpy as np

from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.parallel.sharded_ba import solver_ranks
from pslam_tpu_torch.pipeline.local_mapping import _t, ba_edges, write_back_ba
from pslam_tpu_torch.solver.local_ba import BAProblem, local_bundle_adjustment
from pslam_tpu_torch.utils.config import SlamConfig


def assemble_global_ba(m: MapState, cfg: SlamConfig, device):
    """Build a BAProblem over all keyframes/points on ``device``. Returns
    (prob, cam_ids, pt_ids, e_feat, n_e) or None."""
    caps = cfg.caps
    K = m.n_kf
    if K < 2:
        return None
    alive = np.flatnonzero(m.kf_valid[:K])
    alive = alive[np.argsort(m.kf_frame_id[alive], kind="stable")]
    cam_ids = [int(k) for k in alive][: caps.gba_cams]
    if len(cam_ids) < 2:
        return None
    # Free: everything except the oldest KF (gauge; Optimizer.cc:119
    # setFixed(id==0)), capped; the newest keyframes get the free slots.
    free = cam_ids[1:]
    if len(free) > caps.gba_free:
        free = free[-caps.gba_free:]
    free_set = set(free)

    pt_ids = m.local_map_points(np.asarray(cam_ids), caps.gba_points)
    if len(pt_ids) == 0:
        return None
    pt_slot = np.full(m.mp_valid.shape[0], -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    edges = ba_edges(m, cam_ids, pt_slot, cfg)
    if edges is None:
        return None
    e_cam, e_pt, e_obs, e_is2, e_feat = edges

    E = caps.gba_edges
    n_e = min(len(e_cam), E)
    if len(e_cam) > E:
        keep = np.random.default_rng(0).choice(len(e_cam), E, replace=False)
        e_cam, e_pt, e_obs, e_is2, e_feat = (
            e_cam[keep], e_pt[keep], e_obs[keep], e_is2[keep], e_feat[keep],
        )

    C = caps.gba_cams
    cam_arr = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    free_slot = np.full(C, -1, np.int64)
    fs = 0
    for s, k in enumerate(cam_ids):
        cam_arr[s] = m.kf_pose[k]
        if k in free_set:
            free_slot[s] = fs
            fs += 1

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[: len(a)] = a
        return out

    P = caps.gba_points
    prob = BAProblem(
        T_cw=_t(cam_arr, device),
        free_slot=_t(free_slot, device),
        X_w=_t(pad(m.mp_pos[pt_ids], (P, 3)), device),
        point_valid=_t(pad(np.ones(len(pt_ids), bool), (P,)), device),
        cam_idx=_t(pad(e_cam, (E,)), device),
        pt_idx=_t(pad(e_pt, (E,)), device),
        obs=_t(pad(e_obs, (E, 3)), device),
        inv_sigma2=_t(pad(e_is2.astype(np.float32), (E,), 1.0), device),
        edge_valid=_t(pad(np.ones(n_e, bool), (E,)), device),
    )
    return prob, cam_ids, pt_ids, e_feat, n_e


def run_global_ba(m: MapState, cfg: SlamConfig, device, schedule=(10, 10)) -> bool:
    """Assemble, solve on ``device`` and write back. Returns True if a solve
    ran."""
    out = assemble_global_ba(m, cfg, device)
    if out is None:
        return False
    prob, cam_ids, pt_ids, e_feat, n_e = out
    # With cfg.distributed and more than one rank the solve is the
    # edge-sharded one (parallel/sharded_ba.py).
    result = local_bundle_adjustment(cfg.camera, prob, cfg.caps.gba_free, schedule=schedule,
                                     ranks=solver_ranks(cfg))
    write_back_ba(m, tuple(t.cpu().numpy() for t in result), cam_ids, pt_ids, e_feat, n_e,
                  prob.free_slot.cpu().numpy())
    return True
