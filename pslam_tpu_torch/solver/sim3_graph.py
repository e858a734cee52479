"""Sim3 relative-pose optimization + essential graph (port of
``pslam_tpu/solver/sim3_graph.py``).

- ``optimize_sim3``: Optimizer::OptimizeSim3 (src/Optimizer.cc:2801-2999):
  LM on the relative Sim3 between two keyframes with bidirectional
  reprojection residuals, Huber, a chi2 = 10 gate between the phases
  (5 iterations -> gate -> 10 more, Optimizer.cc:2924-2957).
- ``optimize_essential_graph``: Optimizer::OptimizeEssentialGraph
  (src/Optimizer.cc:2536-2799): the Sim3 pose graph over all keyframes as a
  dense (7K, 7K) damped Gauss-Newton solve.

Jacobians are forward-mode derivatives at a zero tangent update, as the JAX
package takes them from ``jax.jacfwd``: one dual-number pass with the n
tangent directions as a leading batch dimension (``_jac``). The LM loops run a
fixed number of iterations on the host with accept/reject on the device.
The (K, K, 7, 7) block assembly sums each block's edge terms in a fixed
order (``solver/local_ba.segment_table``), so two runs on the card agree
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from pslam_tpu_torch.geometry.camera import Camera, project
from pslam_tpu_torch.geometry.lie import (
    Sim3,
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
    sim3_transform_points,
)
from pslam_tpu_torch.solver.local_ba import ONE_DEVICE, lm_loop, segment_sum, segment_table
from pslam_tpu_torch.solver.robust import huber_weight

CHI2_SIM3 = 10.0  # th2 in OptimizeSim3 (Optimizer.cc:2801 signature)


def _jac(f, n: int, batch_dims: int, ref):
    """Jacobian at 0 of ``f``, a function of an (n,) tangent update that
    broadcasts over leading dimensions, with ``batch_dims`` batch dimensions
    in its output ahead of the (m,) residual. Returns (*batch, m, n), in the
    dtype and on the device of ``ref``."""
    eye = torch.eye(n, dtype=ref.dtype, device=ref.device)
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.zeros_like(eye), eye)
        out = fwAD.unpack_dual(f(x.reshape((n,) + (1,) * batch_dims + (n,)))).tangent
    return out.movedim(0, -1)


def _select(accept, a: Sim3, b: Sim3) -> Sim3:
    return Sim3(*(torch.where(accept, x, y) for x, y in zip(a, b)))


def _lm_lambda(accept, lam):
    return torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


class Sim3OptResult(NamedTuple):
    g12: Sim3
    inlier: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _sim3_residuals(cam: Camera, g12: Sim3, X1, X2, uv1, uv2):
    """Bidirectional reprojection residuals (N, 4): image-1 error of
    g12-mapped X2 and image-2 error of g21-mapped X1 (EdgeSim3ProjectXYZ /
    EdgeInverseSim3ProjectXYZ)."""
    g21 = sim3_inverse(g12)
    e1 = uv1 - project(cam, sim3_transform_points(g12, X2))
    e2 = uv2 - project(cam, sim3_transform_points(g21, X1))
    return torch.cat([e1, e2], dim=-1)


def optimize_sim3(
    cam: Camera,
    g12_init: Sim3,
    X1,
    X2,
    uv1,
    uv2,
    inv_sigma2_1,
    inv_sigma2_2,
    valid,
    fix_scale: bool = False,
    schedule=(5, 10),
) -> Sim3OptResult:
    """LM on the relative Sim3 (7-DoF; 6 when fix_scale). X1/X2 are matched
    landmark positions in the two camera frames, uv1/uv2 their observations.
    Two phases with the chi2 > 10 edge gate in both directions between them
    (Optimizer.cc:2924-2946)."""
    dtype, dev = X1.dtype, X1.device
    def edge_chi2(g12):
        r = _sim3_residuals(cam, g12, X1, X2, uv1, uv2)
        return r, torch.sum(r[:, :2] ** 2, -1) * inv_sigma2_1, torch.sum(r[:, 2:] ** 2, -1) * inv_sigma2_2

    def cost_terms(g12, active, use_huber: bool):
        r, chi2_1, chi2_2 = edge_chi2(g12)
        delta = CHI2_SIM3**0.5
        w1 = huber_weight(chi2_1, delta) if use_huber else torch.ones_like(chi2_1)
        w2 = huber_weight(chi2_2, delta) if use_huber else torch.ones_like(chi2_2)
        a = active.to(dtype)
        cost = torch.sum((chi2_1 * w1 + chi2_2 * w2) * a)
        w_rows = torch.cat([
            (w1 * inv_sigma2_1 * a)[:, None].repeat(1, 2),
            (w2 * inv_sigma2_2 * a)[:, None].repeat(1, 2),
        ], dim=-1)
        return r, w_rows, cost

    def lm_phase(g12, active, n_iters: int, use_huber: bool):
        *_, cost = cost_terms(g12, active, use_huber)
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        eye7 = torch.eye(7, dtype=dtype, device=dev)
        for _ in range(n_iters):
            r, w_rows, _ = cost_terms(g12, active, use_huber)
            J = _jac(lambda d: _sim3_residuals(
                cam, sim3_compose(sim3_exp(d), g12), X1[None], X2[None], uv1, uv2),
                7, 1, X1)  # (N, 4, 7)
            H = torch.einsum("nri,nrj,nr->ij", J, J, w_rows)
            b = -torch.einsum("nri,nr,nr->i", J, r, w_rows)
            if fix_scale:
                # Pin the scale tangent (VertexSim3Expmap _fix_scale).
                H = H.clone()
                H[6, :] = 0.0
                H[:, 6] = 0.0
                H[6, 6] = 1.0
                b = b.clone()
                b[6] = 0.0
            H = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye7
            dx = torch.linalg.solve(H, b)
            g_new = sim3_compose(sim3_exp(dx), g12)
            *_, cost_new = cost_terms(g_new, active, use_huber)
            accept = cost_new < cost
            g12 = _select(accept, g_new, g12)
            lam = _lm_lambda(accept, lam)
            cost = torch.where(accept, cost_new, cost)
        return g12

    g12 = lm_phase(g12_init, valid, schedule[0], True)
    _, c1, c2 = edge_chi2(g12)
    active = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    g12 = lm_phase(g12, active, schedule[1], False)
    _, c1, c2 = edge_chi2(g12)
    inlier = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    return Sim3OptResult(g12=g12, inlier=inlier, n_inliers=torch.sum(inlier.to(torch.int32)))


# ---------------------------------------------------------------------------
# OptimizeEssentialGraph
# ---------------------------------------------------------------------------


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose graph.

    Vertices: (K,) Sim3 (world->camera, Scw). Edges carry the relative
    measurement S_ji with error log(S_ji * S_i * S_j^-1) (g2o EdgeSim3).
    """

    S: Sim3  # vertex estimates: s (K,), R (K,3,3), t (K,3)
    fixed: torch.Tensor  # (K,) bool: the loop KF (Optimizer.cc:2594)
    vertex_valid: torch.Tensor  # (K,) bool
    e_i: torch.Tensor  # (E,) int64
    e_j: torch.Tensor  # (E,) int64
    e_Sji: Sim3  # measurements: s (E,), R (E,3,3), t (E,3)
    e_valid: torch.Tensor  # (E,) bool


def _edge_error(Si: Sim3, Sj: Sim3, Sji: Sim3):
    return sim3_log(sim3_compose(Sji, sim3_compose(Si, sim3_inverse(Sj))))


def _edge_error_delta(d_i, d_j, Si, Sj, Sji):
    return _edge_error(sim3_compose(sim3_exp(d_i), Si), sim3_compose(sim3_exp(d_j), Sj), Sji)


def _gather(S: Sim3, idx) -> Sim3:
    return Sim3(*(a[idx] for a in S))


def graph_normal_equations(K: int, e_i, e_j, e_Sji: Sim3, e_valid):
    """``assemble(S) -> (H (K, K, 7, 7), b (K, 7), cost)`` of the Sim3 pose
    graph over the edges given (all of them, or one rank's shard in
    parallel/sharded_graph.py), each block summed in a fixed order."""
    dtype, dev = e_Sji.t.dtype, e_Sji.t.device
    w = e_valid.to(dtype)
    # Block (a, b) of the (K, K) lattice gathers, in edge order, the blocks
    # Hii (a = b = i), Hjj, Hij (i, j) and Hij^T (j, i) of every edge.
    blk = torch.cat([e_i * K + e_i, e_j * K + e_j, e_i * K + e_j, e_j * K + e_i])
    blk_ids, blk_of = torch.unique(blk, return_inverse=True)
    blk_table = segment_table(blk_of, blk_ids.shape[0])
    vtx_table = segment_table(torch.cat([e_i, e_j]), K)

    def assemble(S):
        Si, Sj = _gather(S, e_i), _gather(S, e_j)
        r = _edge_error(Si, Sj, e_Sji)  # (E, 7)
        J = _jac(lambda d: _edge_error_delta(d[..., :7], d[..., 7:], Si, Sj, e_Sji),
                 14, 1, r)  # (E, 7, 14)
        Ji, Jj = J[..., :7], J[..., 7:]
        Hii = torch.einsum("eri,erj,e->eij", Ji, Ji, w)
        Hjj = torch.einsum("eri,erj,e->eij", Jj, Jj, w)
        Hij = torch.einsum("eri,erj,e->eij", Ji, Jj, w)
        bi = -torch.einsum("eri,er,e->ei", Ji, r, w)
        bj = -torch.einsum("eri,er,e->ei", Jj, r, w)
        H = torch.zeros((K * K, 7, 7), dtype=dtype, device=dev)
        H[blk_ids] = segment_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), blk_table)
        b = segment_sum(torch.cat([bi, bj]), vtx_table)
        return H.reshape(K, K, 7, 7), b, torch.sum(torch.sum(r * r, -1) * w)

    return assemble


def graph_step(prob: PoseGraphProblem, S: Sim3, H, b, lam) -> Sim3:
    """One damped Gauss-Newton proposal from the normal equations at S:
    fixed and invalid vertices pinned (identity rows, zero rhs)."""
    K = prob.fixed.shape[0]
    dtype, dev = S.t.dtype, S.t.device
    fm = (prob.vertex_valid & ~prob.fixed).to(dtype)
    diag_fix = ((1.0 - fm)[:, None] * torch.ones(7, dtype=dtype, device=dev)).reshape(-1)
    H = H * fm[:, None, None, None] * fm[None, :, None, None]
    b = b * fm[:, None]
    Hm = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    Hm = Hm + torch.diag(diag_fix)
    damp = lam * torch.diag(torch.diag(Hm)) + 1e-8 * torch.eye(K * 7, dtype=dtype, device=dev)
    dx = torch.linalg.solve(Hm + damp, b.reshape(-1)).reshape(K, 7) * fm[:, None]
    return sim3_compose(sim3_exp(dx), S)


def optimize_essential_graph(prob: PoseGraphProblem, n_iters: int = 20,
                             ranks=ONE_DEVICE) -> Sim3:
    """Damped Gauss-Newton on the Sim3 pose graph (Optimizer.cc:2536-2799;
    the reference runs optimizer.optimize(20) at Optimizer.cc:2755).

    With a process group's ``ranks`` (parallel/sharded_ba.py) each rank
    assembles its contiguous edge shard and one ``all_reduce`` of H, b and
    the cost gives every rank the full normal equations; the solve runs
    replicated.

    Returns the optimized vertex Sim3s (corrected Scw per keyframe)."""
    sl = ranks.shard(prob.e_i.shape[0], "edge")
    local = graph_normal_equations(prob.fixed.shape[0], prob.e_i[sl], prob.e_j[sl],
                                   _gather(prob.e_Sji, sl), prob.e_valid[sl])
    def normal_eqs(S):
        H, b, cost = ranks.all_reduce(*local(Sim3(*S)))
        return (H, b), cost

    def step(S, blocks, lam):
        return graph_step(prob, Sim3(*S), *blocks, lam)

    return Sim3(*lm_loop(normal_eqs, step, prob.S, n_iters))
