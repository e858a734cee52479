"""Local bundle adjustment with point AND structural-line (LIL) landmarks
(port of ``pslam_tpu/solver/ba_lil.py``).

Extends solver/local_ba.py with the LIL blocks of
Optimizer::LocalBundleAdjustmentAndInseclines (reference
src/Optimizer.cc:2274-2346): marginalized LIL vertices with 6-d composite
edges (info I*0.01, Huber sqrt(11.07)), LM schedule 5 + 10 with the chi2
11.07 / positive-depth gate between phases (Optimizer.cc:2370-2420).

The LIL landmark update is a rigid 3-d translation of the 15-d structure
(see solver/lil.py), so LIL Hessian blocks are 3x3: the landmark axis of the
Schur system is points ++ LILs and ``_schur_step`` is reused unchanged. The
LIL blocks are summed with the same fixed-order tables as the point blocks,
so the solve is deterministic on the card too. (Map lines get no vertices in
the reference's active BA, and none here.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.solver import local_ba
from pslam_tpu_torch.solver.lil import CHI2_LIL, lil_residual_jac, lil_weights
from pslam_tpu_torch.solver.local_ba import (
    ONE_DEVICE,
    BAProblem,
    _apply,
    _assemble,
    _edge_depth,
    _edge_shard,
    _edge_terms,
    _gates,
    _problem_plan,
    _schur_step,
    assembly_plan,
    graphs_engage,
    lm_loop,
)


class LILBAEdges(NamedTuple):
    """Fixed-capacity LIL observation edges for local BA."""

    cam_idx: torch.Tensor  # (El,) int64 into prob.T_cw
    lil_idx: torch.Tensor  # (El,) int64 into lil_state
    obs: torch.Tensor  # (El, 8) [l1, l2, uv_ins]
    valid: torch.Tensor  # (El,) bool


def _lil_edge_terms(cam, T_all, lil_state, ledges: LILBAEdges, active, use_huber: bool):
    r, Jc, Jl, min_z = lil_residual_jac(
        cam, T_all[ledges.cam_idx], lil_state[ledges.lil_idx], ledges.obs
    )
    chi2, w_eff, cost = lil_weights(r, active, use_huber)
    return chi2, w_eff, r, Jc, Jl, min_z, cost


def local_bundle_adjustment_lil(
    cam: Camera,
    prob: BAProblem,
    lil_state,  # (Q, 15)
    lil_valid,  # (Q,)
    ledges: LILBAEdges,
    n_free: int,
    schedule=(5, 10),
    ranks=ONE_DEVICE,
):
    """Joint point + LIL local BA.

    With a process group's ``ranks`` (parallel/sharded_ba.py) point edges
    and LIL edges are both sharded by rank, and the point blocks and the LIL
    blocks are each reduce-scattered over their own landmark axis: a rank's
    owned points ++ owned LILs form its part of the reduced camera system.

    Returns (T_opt, X_opt, lil_state_opt, point_edge_inlier,
    lil_edge_inlier). On one CUDA device the solve goes through
    ``local_ba.BA_GRAPHS``; every CUDA solve sums over fixed-width tables
    (``local_ba._problem_plan``)."""
    if graphs_engage(prob.T_cw, ranks):
        plans = _plans(prob, prob, ledges, n_free, lil_state.shape[0])

        def solve(prob, lil_state, lil_valid, ledges, plans):
            return _solve(cam, prob, lil_state, lil_valid, ledges, n_free, schedule,
                          ONE_DEVICE, plans)

        return local_ba.BA_GRAPHS.run(("lil", cam, n_free, tuple(schedule)), solve,
                                      prob, lil_state, lil_valid, ledges, plans)
    return _solve(cam, prob, lil_state, lil_valid, ledges, n_free, schedule, ranks)


def _plans(prob: BAProblem, shard: BAProblem, lshard: LILBAEdges, n_free: int, Q: int):
    """The point and LIL tables of a rank's edge shards, of fixed widths on
    CUDA as ``local_ba._problem_plan``'s."""
    return (_problem_plan(shard, n_free),
            assembly_plan(prob.free_slot, lshard.cam_idx, lshard.lil_idx, lshard.valid, n_free,
                          Q, fixed=lshard.cam_idx.is_cuda))


def _solve(cam, prob, lil_state, lil_valid, ledges, n_free, schedule, ranks, plans=None):
    """The solve of ``local_bundle_adjustment_lil``. Given the point and
    LIL tables ``plans`` it reads nothing back to the host, so a CUDA graph
    can hold it; without, it builds them for this rank's edge shards."""
    Q = lil_state.shape[0]
    esl = ranks.shard(prob.cam_idx.shape[0], "edge")
    lsl = ranks.shard(ledges.cam_idx.shape[0], "LIL edge")
    psl = ranks.shard(prob.X_w.shape[0], "point")
    qsl = ranks.shard(Q, "LIL")
    shard = _edge_shard(prob, esl)
    lshard = LILBAEdges(*(a[lsl] for a in ledges))
    plan_p, plan_l = _plans(prob, shard, lshard, n_free, Q) if plans is None else plans
    lm_valid_own = torch.cat([prob.point_valid[psl], lil_valid[qsl]], dim=0)
    n_p_own = psl.stop - psl.start

    def normal_eqs(active_p, active_l, use_huber):
        def at(state):
            T_all, X_all, lst = state
            _, w_p, r_p, Jc_p, Jp_p, cost_p = _edge_terms(cam, shard, T_all, X_all,
                                                          active_p[esl], use_huber)
            Hcc, bc, Hpp, bp, G = _assemble(plan_p, n_free, w_p, r_p, Jc_p, Jp_p)
            _, w_l, r_l, Jc_l, Jl_l, _, cost_l = _lil_edge_terms(cam, T_all, lst, lshard,
                                                                 active_l[lsl], use_huber)
            Hcc_l, bc_l, Hll, bl, Gl = _assemble(plan_l, n_free, w_l, r_l, Jc_l, Jl_l)
            Hcc, bc, cost = ranks.all_reduce(Hcc + Hcc_l, bc + bc_l, cost_p + cost_l)
            Hpp, bp, G = ranks.reduce_scatter(Hpp, bp, G)
            Hll, bl, Gl = ranks.reduce_scatter(Hll, bl, Gl)
            return (Hcc, bc, torch.cat([Hpp, Hll]), torch.cat([bp, bl]),
                    torch.cat([G, Gl])), cost
        return at

    def step(state, blocks, lam):
        T_all, X_all, lst = state
        dx_c, dx_own = _schur_step(ranks, blocks, lm_valid_own, lam)
        (dx_p,) = ranks.all_gather(dx_own[:n_p_own])
        (dx_l,) = ranks.all_gather(dx_own[n_p_own:])
        T_new, X_new = _apply(prob, T_all, X_all, dx_c, dx_p)
        shift = dx_l * lil_valid[:, None]  # (Q, 3)
        return T_new, X_new, lst + shift.repeat(1, 5)

    _, gate = _gates(prob)

    def classify(T_all, X_all, lst):
        chi2_p, *_ = _edge_terms(cam, shard, T_all, X_all, shard.edge_valid, False)
        chi2_p, z = ranks.all_gather(chi2_p, _edge_depth(shard, T_all, X_all))
        in_p = prob.edge_valid & (chi2_p <= gate) & (z > 0.0)
        chi2_l, *_, min_z, _ = _lil_edge_terms(cam, T_all, lst, lshard, lshard.valid, False)
        chi2_l, min_z = ranks.all_gather(chi2_l, min_z)
        in_l = ledges.valid & (chi2_l <= CHI2_LIL) & (min_z > 0.0)
        return in_p, in_l

    state = lm_loop(normal_eqs(prob.edge_valid, ledges.valid, True), step,
                    (prob.T_cw, prob.X_w, lil_state), schedule[0])
    active_p, active_l = classify(*state)
    state = lm_loop(normal_eqs(active_p, active_l, False), step, state, schedule[1])
    return (*state, *classify(*state))
