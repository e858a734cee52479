"""Local bundle adjustment with point AND structural-line (LIL) landmarks
(port of ``pslam_tpu/solver/ba_lil.py``).

Extends solver/local_ba.py with the LIL blocks of
Optimizer::LocalBundleAdjustmentAndInseclines (reference
src/Optimizer.cc:2274-2346): marginalized LIL vertices with 6-d composite
edges (info I*0.01, Huber sqrt(11.07)), LM schedule 5 + 10 with the chi2
11.07 / positive-depth gate between phases (Optimizer.cc:2370-2420).

The LIL landmark update is a rigid 3-d translation of the 15-d structure
(see solver/lil.py), so LIL Hessian blocks are 3x3: the landmark axis of the
Schur system is points ++ LILs and ``_solve_schur`` is reused unchanged. The
LIL blocks are summed with the same fixed-order tables as the point blocks,
so the solve is deterministic on the card too. (Map lines get no vertices in
the reference's active BA, and none here.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.solver.lil import CHI2_LIL, lil_residual_jac, lil_weights
from pslam_tpu_torch.solver.local_ba import (
    BAProblem,
    _apply,
    _assemble,
    _edge_depth,
    _edge_terms,
    _gates,
    _problem_plan,
    _solve_schur,
    assembly_plan,
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
):
    """Joint point + LIL local BA.

    Returns (T_opt, X_opt, lil_state_opt, point_edge_inlier,
    lil_edge_inlier)."""
    Q = lil_state.shape[0]
    P = prob.X_w.shape[0]
    plan_p = _problem_plan(prob, n_free)
    plan_l = assembly_plan(prob.free_slot, ledges.cam_idx, ledges.lil_idx,
                           ledges.valid, n_free, Q)
    lm_valid = torch.cat([prob.point_valid, lil_valid], dim=0)

    def normal_eqs(T_all, X_all, lst, active_p, active_l, use_huber):
        _, w_p, r_p, Jc_p, Jp_p, cost_p = _edge_terms(cam, prob, T_all, X_all, active_p,
                                                      use_huber)
        Hcc, bc, Hpp, bp, G = _assemble(plan_p, n_free, w_p, r_p, Jc_p, Jp_p)
        _, w_l, r_l, Jc_l, Jl_l, _, cost_l = _lil_edge_terms(cam, T_all, lst, ledges,
                                                             active_l, use_huber)
        Hcc_l, bc_l, Hll, bl, Gl = _assemble(plan_l, n_free, w_l, r_l, Jc_l, Jl_l)
        blocks = (Hcc + Hcc_l, bc + bc_l, torch.cat([Hpp, Hll]), torch.cat([bp, bl]),
                  torch.cat([G, Gl]))
        return blocks, cost_p + cost_l

    def apply(T_all, X_all, lst, dx_c, dx_p):
        T_new, X_new = _apply(prob, T_all, X_all, dx_c, dx_p[:P])
        shift = dx_p[P:] * lil_valid[:, None]  # (Q, 3)
        return T_new, X_new, lst + shift.repeat(1, 5)

    def lm_phase(T_all, X_all, lst, active_p, active_l, n_iters, use_huber):
        # One normal-equation assembly per LM iteration: the blocks at the
        # current estimate ride along (see solver/local_ba.py lm_phase).
        blocks, cost = normal_eqs(T_all, X_all, lst, active_p, active_l, use_huber)
        lam = torch.full((), 1e-4, dtype=T_all.dtype, device=T_all.device)
        for _ in range(n_iters):
            dx_c, dx_p = _solve_schur(*blocks, lm_valid, lam)
            T_new, X_new, l_new = apply(T_all, X_all, lst, dx_c, dx_p)
            blocks_new, cost_new = normal_eqs(T_new, X_new, l_new, active_p, active_l,
                                              use_huber)
            accept = cost_new < cost
            T_all = torch.where(accept, T_new, T_all)
            X_all = torch.where(accept, X_new, X_all)
            lst = torch.where(accept, l_new, lst)
            blocks = tuple(torch.where(accept, a, b) for a, b in zip(blocks_new, blocks))
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            cost = torch.where(accept, cost_new, cost)
        return T_all, X_all, lst

    _, gate = _gates(prob)

    def classify(T_all, X_all, lst):
        chi2_p, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
        z = _edge_depth(prob, T_all, X_all)
        in_p = prob.edge_valid & (chi2_p <= gate) & (z > 0.0)
        chi2_l, *_, min_z, _ = _lil_edge_terms(cam, T_all, lst, ledges, ledges.valid, False)
        in_l = ledges.valid & (chi2_l <= CHI2_LIL) & (min_z > 0.0)
        return in_p, in_l

    T_all, X_all, lst = prob.T_cw, prob.X_w, lil_state
    T_all, X_all, lst = lm_phase(T_all, X_all, lst, prob.edge_valid, ledges.valid,
                                 schedule[0], True)
    active_p, active_l = classify(T_all, X_all, lst)
    T_all, X_all, lst = lm_phase(T_all, X_all, lst, active_p, active_l, schedule[1], False)
    in_p, in_l = classify(T_all, X_all, lst)
    return T_all, X_all, lst, in_p, in_l
