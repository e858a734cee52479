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

import functools
from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera, se3_exp, transform_points
from pslam_tpu_torch.solver.linalg import inv3x3
from pslam_tpu_torch.solver.reproj import stereo_residual_jac
from pslam_tpu_torch.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from pslam_tpu_torch.utils.cuda_graph import GraphCache


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


@functools.cache
def _huber_delta(chi2: float, dtype: torch.dtype) -> float:
    """sqrt(chi2) rounded as ``dtype`` rounds it, as a Python float: a kernel
    argument, where a device scalar would be a host-to-device copy a call
    (one that waits, and that a CUDA graph capture refuses)."""
    return float(torch.tensor(chi2, dtype=dtype).sqrt())


def _gates(prob: BAProblem):
    is_stereo = prob.obs[..., 2] >= 0.0
    return is_stereo, torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)


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
    delta = torch.where(is_stereo, torch.full_like(chi2, _huber_delta(CHI2_STEREO, r.dtype)),
                        _huber_delta(CHI2_MONO, r.dtype))
    w_rob = huber_weight(chi2, delta) if use_huber else torch.ones_like(chi2)
    a = active.to(r.dtype)
    w_eff = w_rob * prob.inv_sigma2 * a
    cost = torch.sum(chi2 * w_rob * a)
    return chi2, w_eff, r, Jc, Jp, cost


def pow2_width(k: int, least: int = 1) -> int:
    """``k`` rounded up to a power of two, and at least ``least`` (a power
    of two)."""
    return max(least, 1 << (max(k, 1) - 1).bit_length())


def segment_table(target, n_targets: int, least: int | None = None):
    """Fixed-order gather table for summing edge rows into targets.

    ``target`` (E,) int64 holds each edge's target in [0, n_targets); any
    other value drops the edge. Returns (n_targets, K) int64 edge indices,
    each row in increasing edge order and padded with E (a zero row), K the
    largest count, or given ``least`` the largest count rounded up to a
    power of two and at least ``least`` (``pow2_width``). One host read of
    the largest count per table."""
    E = target.shape[0]
    dev = target.device
    keep = (target >= 0) & (target < n_targets)
    t = torch.where(keep, target, n_targets)
    order = torch.sort(t, stable=True).indices
    t_sorted = t[order]
    counts = torch.bincount(t, minlength=n_targets + 1)
    K = int(counts[:n_targets].max()) if n_targets else 0
    K = max(K, 1) if least is None else pow2_width(K, least)
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


def assembly_plan(free_slot, cam_idx, lm_idx, valid, n_free: int, n_lm: int,
                  fixed: bool = False):
    """Tables for ``_assemble``. Edges that are not ``valid`` carry zero
    weight and are left out; edges of fixed cameras reach no camera block.

    ``fixed`` pads every width to a power of two, so that the widths take
    few values across problems and a CUDA graph keyed on them is seen
    again, and two tables wider still: a free camera's to at least its
    share of the edges E / n_free, a landmark's to at least the cameras C,
    the most edges a landmark has when a keyframe observes it once (both
    rounded up). The added columns point at the zero row: the tables list
    the same edges in the same order, but a ``sum``'s order of additions
    may change with the width (on the CPU as on CUDA), so a sum over them
    agrees with the plain tables' to rounding."""
    slot_e = torch.where(valid, free_slot[cam_idx], -1)
    lm_e = torch.where(valid, lm_idx, -1)
    lm_cam = torch.where(slot_e >= 0, lm_e * n_free + slot_e, -1)
    least = ((pow2_width(cam_idx.shape[0] // n_free), pow2_width(free_slot.shape[0]), 1)
             if fixed else (None, None, None))
    return AssemblyPlan(
        cam=segment_table(slot_e, n_free, least[0]),
        lm=segment_table(lm_e, n_lm, least[1]),
        lm_cam=segment_table(lm_cam, n_lm * n_free, least[2]),
    )


def _problem_plan(prob: BAProblem, n_free: int) -> AssemblyPlan:
    """The tables of ``prob``'s edges: of fixed widths on CUDA, where a
    solve on one device is a captured graph keyed on them, and every other
    CUDA solve (the sharded ones, and the eager first sight of a key) sums
    over the same widths and so agrees with it bit for bit; of exact widths
    on the CPU."""
    return assembly_plan(prob.free_slot, prob.cam_idx, prob.pt_idx, prob.edge_valid,
                         n_free, prob.X_w.shape[0], fixed=prob.cam_idx.is_cuda)


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


def _schur_landmarks(Hpp, bp, G, point_valid, lam):
    """The landmark side of one damped Schur step: (Hpp_inv (L, 3, 3),
    S_part (F, F, 6, 6) = sum_p G_p Hpp_p^-1 G_p^T, b_part (F, 6) =
    sum_p G_p Hpp_p^-1 bp_p) over the landmarks given (all of them, or the
    ones a rank owns in parallel/sharded_ba.py)."""
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # LM damping on landmark blocks + lift empty/invalid blocks to identity.
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + (lam * tr3 / 3.0 + 1e-6)[..., None, None] * eye3
    pv = point_valid[..., None, None].to(Hpp.dtype)
    Hpp_d = Hpp_d * pv + (1.0 - pv) * eye3
    Hpp_inv = inv3x3(Hpp_d)
    M = torch.einsum("pfij,pjk->pfik", G, Hpp_inv)  # (P, F, 6, 3)
    return Hpp_inv, torch.einsum("pfij,pgkj->fgik", M, G), torch.einsum("pfij,pj->fi", M, bp)


def _schur_cameras(Hcc, bc, S_red, b_sub, lam):
    """Solve the damped reduced camera system (Hcc - S_red) dx_c = bc - b_sub."""
    F = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + (lam * tr6 / 6.0 + 1e-8)[..., None, None] * eye6
    S = -S_red
    ar = torch.arange(F, device=S.device)
    S[ar, ar] += Hcc_d
    b_red = bc - b_sub
    S_mat = S.permute(0, 2, 1, 3).reshape(F * 6, F * 6)
    S_mat = S_mat + 1e-6 * torch.eye(F * 6, dtype=S_mat.dtype, device=S_mat.device)
    return torch.linalg.solve_ex(S_mat, b_red.reshape(-1, 1))[0].reshape(F, 6)


def _back_substitute(Hpp_inv, bp, G, point_valid, dx_c):
    """Landmark updates dx_p = Hpp^-1 (bp - G^T dx_c)."""
    rhs_p = bp - torch.einsum("pfij,fi->pj", G, dx_c)
    return torch.einsum("pij,pj->pi", Hpp_inv, rhs_p) * point_valid[..., None]


class OneDevice:
    """The collectives of a solve on one device, each the identity. The
    solvers take a ``ranks`` object: this one by default, or
    parallel/sharded_ba.py's ``Ranks`` of a process group, which shards the
    edges and landmarks and sums the partial blocks over the ranks."""

    size, rank = 1, 0

    @staticmethod
    def shard(n: int, what: str) -> slice:
        return slice(0, n)

    @staticmethod
    def all_reduce(*ts):
        return ts

    reduce_scatter = all_gather = all_reduce


ONE_DEVICE = OneDevice()


def _schur_step(ranks, blocks, lm_valid, lam):
    """One damped Schur step from the landmark blocks this rank owns (all of
    them on one device) -> (dx_c (F, 6), dx_lm (L, 3)) for those landmarks."""
    Hcc, bc, Hpp, bp, G = blocks
    Hpp_inv, S_part, b_part = _schur_landmarks(Hpp, bp, G, lm_valid, lam)
    S_red, b_sub = ranks.all_reduce(S_part, b_part)
    dx_c = _schur_cameras(Hcc, bc, S_red, b_sub, lam)
    return dx_c, _back_substitute(Hpp_inv, bp, G, lm_valid, dx_c)


def lm_loop(normal_eqs, step, state, n_iters: int):
    """Levenberg-Marquardt with one normal-equation assembly an iteration.

    ``normal_eqs(state) -> (blocks, cost)`` and ``step(state, blocks, lam)
    -> proposal``; states and blocks are tuples of tensors. Each proposal is
    assembled once and its blocks replace the current ones on acceptance,
    so the current estimate's blocks ride along. lambda halves on accept and
    quadruples on reject, within [1e-10, 1e6]."""
    blocks, cost = normal_eqs(state)
    lam = torch.full((), 1e-4, dtype=state[0].dtype, device=state[0].device)
    for _ in range(n_iters):
        new = step(state, blocks, lam)
        blocks_new, cost_new = normal_eqs(new)
        accept = cost_new < cost
        state = tuple(torch.where(accept, a, b) for a, b in zip(new, state))
        blocks = tuple(torch.where(accept, a, b) for a, b in zip(blocks_new, blocks))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        cost = torch.where(accept, cost_new, cost)
    return state


def _apply(prob: BAProblem, T_all, X_all, dx_c, dx_p):
    slot = torch.clamp(prob.free_slot, min=0)
    dx_cam = dx_c[slot] * (prob.free_slot >= 0)[..., None]
    return se3_exp(dx_cam) @ T_all, X_all + dx_p


def _edge_depth(prob: BAProblem, T_all, X_all):
    """Per-edge landmark depth in its observing camera."""
    return transform_points(T_all[prob.cam_idx], X_all[prob.pt_idx])[..., 2]


def _edge_shard(prob: BAProblem, sl: slice) -> BAProblem:
    return prob._replace(cam_idx=prob.cam_idx[sl], pt_idx=prob.pt_idx[sl], obs=prob.obs[sl],
                         inv_sigma2=prob.inv_sigma2[sl], edge_valid=prob.edge_valid[sl])


def graphs_engage(t: torch.Tensor, ranks) -> bool:
    """Whether a solve on ``t``'s device with ``ranks`` goes through
    ``BA_GRAPHS``: on one CUDA device only. The sharded solvers and every
    CPU solve run eagerly, as they always have."""
    return ranks is ONE_DEVICE and BA_GRAPHS.takes(t)


# The local BA solves' graphs: one a problem shape, solver and camera
# (utils/cuda_graph.py). A shape seen once (the global BA of one loop) runs
# eagerly; from its second sight a solve is one replay in place of ~5,600
# launches.
BA_GRAPHS = GraphCache()


def local_bundle_adjustment(
    cam: Camera,
    prob: BAProblem,
    n_free: int,
    schedule=(5, 10),
    ranks=ONE_DEVICE,
):
    """Run local BA. ``n_free`` is the number of free-camera slots.

    With a process group's ``ranks`` (parallel/sharded_ba.py) each rank
    assembles its contiguous edge shard, the camera blocks and the cost are
    all-reduced, the landmark blocks reduce-scattered over the point axis,
    and every rank returns the same full arrays. On one CUDA device the
    solve goes through ``BA_GRAPHS``; every CUDA solve sums over
    fixed-width tables (``_problem_plan``).

    Returns (T_opt (C, 4, 4), X_opt (P, 3), edge_inlier (E,), chi2 (E,))."""
    if graphs_engage(prob.T_cw, ranks):
        return BA_GRAPHS.run(("points", cam, n_free, tuple(schedule)),
                             lambda prob, plan: _solve(cam, prob, n_free, schedule, ONE_DEVICE,
                                                       plan),
                             prob, _problem_plan(prob, n_free))
    return _solve(cam, prob, n_free, schedule, ranks)


def _solve(cam: Camera, prob: BAProblem, n_free: int, schedule, ranks, plan=None):
    """The solve of ``local_bundle_adjustment``. Given the tables ``plan``
    it reads nothing back to the host, so a CUDA graph can hold it; without,
    it builds them for this rank's edge shard."""
    esl = ranks.shard(prob.cam_idx.shape[0], "edge")
    psl = ranks.shard(prob.X_w.shape[0], "point")
    shard = _edge_shard(prob, esl)
    if plan is None:
        plan = _problem_plan(shard, n_free)
    pv_own = prob.point_valid[psl]

    def normal_eqs(active, use_huber):
        def at(state):
            _, w_eff, r, Jc, Jp, cost = _edge_terms(cam, shard, *state, active[esl],
                                                    use_huber)
            Hcc, bc, Hpp, bp, G = _assemble(plan, n_free, w_eff, r, Jc, Jp)
            Hcc, bc, cost = ranks.all_reduce(Hcc, bc, cost)
            return (Hcc, bc) + ranks.reduce_scatter(Hpp, bp, G), cost
        return at

    def step(state, blocks, lam):
        dx_c, dx_p = _schur_step(ranks, blocks, pv_own, lam)
        return _apply(prob, *state, dx_c, *ranks.all_gather(dx_p))

    def classify(T_all, X_all):
        # Outlier gate (Optimizer.cc:2370-2414): chi2 over gate or negative
        # depth -> drop edge.
        chi2, *_ = _edge_terms(cam, shard, T_all, X_all, shard.edge_valid, False)
        chi2, z = ranks.all_gather(chi2, _edge_depth(shard, T_all, X_all))
        return prob.edge_valid & (chi2 <= gate) & (z > 0.0), chi2

    _, gate = _gates(prob)
    # Phase 1: 5 robustified iterations (Optimizer.cc:2356-2357).
    state = lm_loop(normal_eqs(prob.edge_valid, True), step, (prob.T_cw, prob.X_w),
                    schedule[0])
    active, _ = classify(*state)
    # Phase 2: 10 non-robust iterations on inliers (Optimizer.cc:2419-2420).
    T_all, X_all = lm_loop(normal_eqs(active, False), step, state, schedule[1])
    inlier, chi2 = classify(T_all, X_all)
    return T_all, X_all, inlier, chi2
