"""Local bundle adjustment with Schur-complement reduction (port of
``pslam_tpu/solver/local_ba.py``, point edges).

Optimizer::LocalBundleAdjustment (reference src/Optimizer.cc:1968-2534):

- free keyframes + fixed observer keyframes in one pose array; fixed cameras
  are pinned by leaving them out of the reduced system (g2o setFixed);
- marginalized point landmarks: per-point 3x3 blocks inverted in closed
  form; the reduced camera system ``S = Hcc - sum_p G_p Hpp_p^-1 G_p^T`` is
  assembled by summing per-edge blocks into their targets (the JAX package's
  scatter path; its TPU one-hot matmul assembly is not carried over) and
  solved dense;
- LM schedule 5 robust iterations -> chi2 + depth outlier gate -> 10
  iterations, matching Optimizer.cc:2356-2420;
- returns updated poses, points and the per-edge inlier classification the
  host uses to erase outlier observations (Optimizer.cc:2482-2503).

The block sums are deterministic on every device: the edge -> block maps are
fixed for a whole problem, so ``segment_table`` sorts the edges by target
once and every LM iteration sums each target's edges in that fixed order
(a gather plus a sum over a padded axis). A float ``index_add_`` on CUDA adds
in atomic order and would make two runs of one input differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera, se3_exp, transform_points
from pslam_tpu_torch.solver.linalg import inv3x3
from pslam_tpu_torch.solver.reproj import stereo_residual_jac
from pslam_tpu_torch.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-capacity local BA problem.

    Cameras: ``T_cw`` (C, 4, 4) with ``free_slot`` (C,) mapping each camera
    to a compact slot in [0, n_free) or -1 if fixed/padding.
    Points: ``X_w`` (P, 3) with ``point_valid`` (P,).
    Edges: arrays of length E; ``obs`` rows [u, v, ur] (ur < 0 = mono)."""

    T_cw: torch.Tensor  # (C, 4, 4)
    free_slot: torch.Tensor  # (C,) int64; -1 = fixed
    X_w: torch.Tensor  # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    cam_idx: torch.Tensor  # (E,) int64
    pt_idx: torch.Tensor  # (E,) int64
    obs: torch.Tensor  # (E, 3)
    inv_sigma2: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,) bool


def _gates(prob: BAProblem):
    is_stereo = prob.obs[..., 2] >= 0.0
    return is_stereo, torch.where(
        is_stereo,
        torch.tensor(CHI2_STEREO, device=is_stereo.device),
        torch.tensor(CHI2_MONO, device=is_stereo.device),
    )


def _edge_terms(cam: Camera, prob: BAProblem, T_all, X_all, active, use_huber: bool):
    T_e = T_all[prob.cam_idx]
    X_e = X_all[prob.pt_idx]
    r, Jc, Jp = stereo_residual_jac(cam, T_e, X_e, prob.obs)
    is_stereo, _ = _gates(prob)
    ones = torch.ones_like(is_stereo)
    row_mask = torch.stack([ones, ones, is_stereo], dim=-1).to(r.dtype)
    r = r * row_mask
    Jc = Jc * row_mask[..., None]
    Jp = Jp * row_mask[..., None]
    chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
    delta = torch.where(
        is_stereo,
        torch.tensor(CHI2_STEREO, dtype=r.dtype, device=r.device).sqrt(),
        torch.tensor(CHI2_MONO, dtype=r.dtype, device=r.device).sqrt(),
    )
    w_rob = huber_weight(chi2, delta) if use_huber else torch.ones_like(chi2)
    a = active.to(r.dtype)
    w_eff = w_rob * prob.inv_sigma2 * a
    cost = torch.sum(chi2 * w_rob * a)
    return chi2, w_eff, r, Jc, Jp, cost


def segment_table(target, n_targets: int):
    """Fixed-order gather table for summing edge rows into targets.

    ``target`` (E,) int64 holds each edge's target in [0, n_targets); any
    other value drops the edge. Returns (n_targets, K) int64 edge indices,
    each row in increasing edge order and padded with E (a zero row), K the
    largest count. One host read of K per table."""
    E = target.shape[0]
    dev = target.device
    keep = (target >= 0) & (target < n_targets)
    t = torch.where(keep, target, n_targets)
    order = torch.sort(t, stable=True).indices
    t_sorted = t[order]
    counts = torch.bincount(t, minlength=n_targets + 1)
    K = max(int(counts[:n_targets].max()) if n_targets else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(E, device=dev) - start[t_sorted]
    real = t_sorted < n_targets
    table = torch.full((n_targets + 1, K), E, dtype=torch.int64, device=dev)
    table[t_sorted[real], pos[real]] = order[real]
    return table[:n_targets]


def segment_sum(vals, table):
    """(E, ...) edge rows -> (n_targets, ...) sums, in the table's order."""
    padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    return padded[table].sum(dim=1)


class AssemblyPlan(NamedTuple):
    """Gather tables of one BA problem's edge -> block maps."""

    cam: torch.Tensor  # (F, Kc) edges per free camera
    lm: torch.Tensor  # (P, Kp) edges per landmark
    lm_cam: torch.Tensor  # (P * F, Kg) edges per (landmark, free camera)


def assembly_plan(free_slot, cam_idx, lm_idx, valid, n_free: int, n_lm: int):
    """Tables for ``_assemble``. Edges that are not ``valid`` carry zero
    weight and are left out; edges of fixed cameras reach no camera block."""
    slot_e = torch.where(valid, free_slot[cam_idx], -1)
    lm_e = torch.where(valid, lm_idx, -1)
    lm_cam = torch.where(slot_e >= 0, lm_e * n_free + slot_e, -1)
    return AssemblyPlan(
        cam=segment_table(slot_e, n_free),
        lm=segment_table(lm_e, n_lm),
        lm_cam=segment_table(lm_cam, n_lm * n_free),
    )


def _problem_plan(prob: BAProblem, n_free: int) -> AssemblyPlan:
    return assembly_plan(prob.free_slot, prob.cam_idx, prob.pt_idx, prob.edge_valid,
                         n_free, prob.X_w.shape[0])


def _assemble(plan: AssemblyPlan, n_free: int, w_eff, r, Jc, Jp):
    """Blocks of the normal equations from per-edge terms:
    (Hcc (F, 6, 6), bc (F, 6), Hpp (L, 3, 3), bp (L, 3), G (L, F, 6, 3)) for
    L landmarks with 3-d updates (points, or LILs in solver/ba_lil.py)."""
    w = w_eff[..., None, None]
    Hcc_e = torch.einsum("eij,eik->ejk", Jc, Jc) * w
    Hpp_e = torch.einsum("eij,eik->ejk", Jp, Jp) * w
    Hcp_e = torch.einsum("eij,eik->ejk", Jc, Jp) * w
    bc_e = -torch.einsum("eij,ei->ej", Jc, r) * w_eff[..., None]
    bp_e = -torch.einsum("eij,ei->ej", Jp, r) * w_eff[..., None]
    Hcc = segment_sum(Hcc_e, plan.cam)
    bc = segment_sum(bc_e, plan.cam)
    Hpp = segment_sum(Hpp_e, plan.lm)
    bp = segment_sum(bp_e, plan.lm)
    G = segment_sum(Hcp_e, plan.lm_cam).reshape(-1, n_free, 6, 3)
    return Hcc, bc, Hpp, bp, G


def _solve_schur(Hcc, bc, Hpp, bp, G, point_valid, lam):
    """One damped Schur step. Returns (dx_c (F, 6), dx_p (P, 3))."""
    F = Hcc.shape[0]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # LM damping on landmark blocks + lift empty/invalid blocks to identity.
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + (lam * tr3 / 3.0 + 1e-6)[..., None, None] * eye3
    pv = point_valid[..., None, None].to(Hpp.dtype)
    Hpp_d = Hpp_d * pv + (1.0 - pv) * eye3
    Hpp_inv = inv3x3(Hpp_d)

    M = torch.einsum("pfij,pjk->pfik", G, Hpp_inv)  # (P, F, 6, 3)
    S_red = torch.einsum("pfij,pgkj->fgik", M, G)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + (lam * tr6 / 6.0 + 1e-8)[..., None, None] * eye6
    S = -S_red
    ar = torch.arange(F, device=S.device)
    S[ar, ar] += Hcc_d
    b_red = bc - torch.einsum("pfij,pj->fi", M, bp)

    S_mat = S.permute(0, 2, 1, 3).reshape(F * 6, F * 6)
    S_mat = S_mat + 1e-6 * torch.eye(F * 6, dtype=S_mat.dtype, device=S_mat.device)
    dx_c = torch.linalg.solve_ex(S_mat, b_red.reshape(-1, 1))[0].reshape(F, 6)

    # Back-substitute landmarks: dx_p = Hpp^-1 (bp - G^T dx_c).
    rhs_p = bp - torch.einsum("pfij,fi->pj", G, dx_c)
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, rhs_p) * point_valid[..., None]
    return dx_c, dx_p


def _apply(prob: BAProblem, T_all, X_all, dx_c, dx_p):
    slot = torch.clamp(prob.free_slot, min=0)
    dx_cam = dx_c[slot] * (prob.free_slot >= 0)[..., None]
    return se3_exp(dx_cam) @ T_all, X_all + dx_p


def _edge_depth(prob: BAProblem, T_all, X_all):
    """Per-edge landmark depth in its observing camera."""
    return transform_points(T_all[prob.cam_idx], X_all[prob.pt_idx])[..., 2]


def local_bundle_adjustment(
    cam: Camera,
    prob: BAProblem,
    n_free: int,
    schedule=(5, 10),
):
    """Run local BA. ``n_free`` is the number of free-camera slots.

    Returns (T_opt (C, 4, 4), X_opt (P, 3), edge_inlier (E,), chi2 (E,))."""

    plan = _problem_plan(prob, n_free)

    def lm_phase(T_all, X_all, active, n_iters, use_huber):
        # One edge-term evaluation per iteration: the terms at the current
        # estimate ride along; each step solves from them, evaluates the
        # proposal once and keeps the proposal's terms on acceptance.
        def terms_of(T, X):
            _, w_eff, r, Jc, Jp, cost = _edge_terms(cam, prob, T, X, active, use_huber)
            return (w_eff, r, Jc, Jp), cost

        terms, cost = terms_of(T_all, X_all)
        lam = torch.tensor(1e-4, dtype=T_all.dtype, device=T_all.device)
        for _ in range(n_iters):
            Hcc, bc, Hpp, bp, G = _assemble(plan, n_free, *terms)
            dx_c, dx_p = _solve_schur(Hcc, bc, Hpp, bp, G, prob.point_valid, lam)
            T_new, X_new = _apply(prob, T_all, X_all, dx_c, dx_p)
            terms_new, cost_new = terms_of(T_new, X_new)
            accept = cost_new < cost
            T_all = torch.where(accept, T_new, T_all)
            X_all = torch.where(accept, X_new, X_all)
            terms = tuple(torch.where(accept, a, b) for a, b in zip(terms_new, terms))
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            cost = torch.where(accept, cost_new, cost)
        return T_all, X_all

    T_all, X_all = prob.T_cw, prob.X_w
    _, gate = _gates(prob)

    # Phase 1: 5 robustified iterations (Optimizer.cc:2356-2357).
    T_all, X_all = lm_phase(T_all, X_all, prob.edge_valid, schedule[0], True)

    # Outlier gate between phases (Optimizer.cc:2370-2414): chi2 over gate or
    # negative depth -> drop edge.
    chi2, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
    z = _edge_depth(prob, T_all, X_all)
    active = prob.edge_valid & (chi2 <= gate) & (z > 0.0)

    # Phase 2: 10 non-robust iterations on inliers (Optimizer.cc:2419-2420).
    T_all, X_all = lm_phase(T_all, X_all, active, schedule[1], False)

    chi2, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
    z = _edge_depth(prob, T_all, X_all)
    inlier = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    return T_all, X_all, inlier, chi2
