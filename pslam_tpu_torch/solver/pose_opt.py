"""Pose-only optimization (port of ``pslam_tpu/solver/pose_opt.py``).

Optimizer::PoseOptimization (reference src/Optimizer.cc:239-1023) as a
Levenberg-Marquardt loop over a fixed-capacity masked edge list: 4 rounds x
10 LM iterations; between rounds edges are re-classified inlier/outlier by
the chi2 gates (5.991 mono / 7.815 stereo) and outliers leave the next
round; Huber is on in rounds 0-1 only; outliers are re-admitted when their
chi2 drops back under the gate.

The loop follows the JAX package's fused path (``_pose_optimization_fused``):
each iteration evaluates ``ops.fused_pose.pose_terms`` once at the proposal
(kernel K2 on CUDA tensors), so a solve is 4 x (1 + 10) + 4 + 1 = 49 calls.
Everything else of an iteration is one ``ops.fused_pose.lm_step`` (the LM
step kernel on CUDA tensors): accept/reject, lambda, the damped 6x6 solve
and the next proposal, written straight into the parameter row K2 reads
next. The state (pose, lambda, cost, H, b) stays on the device, so the loop
never waits for the host: a round is K2, step, K2, step, ... 11 of each.

Structural-line (LIL) edges (solver/lil.py) join the same normal equations
through the optional ``lil`` argument, as in the JAX package's fused path
(Optimizer.cc:619-694: LIL vertices fixed, info I*0.01, Huber sqrt(11.07),
per-round chi2 gate 11.07). Their terms are plain torch beside each K2 call
and join K2's inside the LM step; K2 itself and its 49 calls per solve do
not change.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops.fused_pose import lm_rows, lm_step, pack_pose_data, pose_terms
from pslam_tpu_torch.solver.lil import (
    CHI2_LIL,
    LILPoseObs,
    lil_residual_jac,
    lil_weights,
)
from pslam_tpu_torch.solver.reproj import stereo_residual_jac
from pslam_tpu_torch.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for one frame's pose solve. ``obs``
    rows are [u, v, ur]; ur < 0 marks a mono observation."""

    X_w: torch.Tensor  # (N, 3) world points (fixed)
    obs: torch.Tensor  # (N, 3) [u, v, ur]
    inv_sigma2: torch.Tensor  # (N,) per-octave information scale
    valid: torch.Tensor  # (N,) bool


def _edge_terms(cam: Camera, T, po: PoseObs, use_huber: bool, active):
    """Residuals/Jacobians + weights for all edges at pose T.

    Returns (chi2 (N,), w_eff (N,), r (N, 3), J (N, 3, 6), row_mask (N, 3),
    cost ())."""
    r, J, _ = stereo_residual_jac(cam, T[None], po.X_w, po.obs)
    is_stereo = po.obs[..., 2] >= 0.0
    ones = torch.ones_like(is_stereo)
    row_mask = torch.stack([ones, ones, is_stereo], dim=-1).to(r.dtype)
    r = r * row_mask
    chi2 = torch.sum(r * r, dim=-1) * po.inv_sigma2
    delta = torch.where(
        is_stereo,
        torch.tensor(CHI2_STEREO, dtype=r.dtype, device=r.device).sqrt(),
        torch.tensor(CHI2_MONO, dtype=r.dtype, device=r.device).sqrt(),
    )
    w_rob = huber_weight(chi2, delta) if use_huber else torch.ones_like(chi2)
    a = active.to(r.dtype)
    w_eff = w_rob * po.inv_sigma2 * a
    cost = torch.sum(chi2 * w_rob * a)
    return chi2, w_eff, r, J, row_mask, cost


def _gn_system(w_eff, r, J, row_mask):
    Jm = J * row_mask[..., None]
    H = torch.einsum("nij,nik,n->jk", Jm, Jm, w_eff)
    b = -torch.einsum("nij,ni,n->j", Jm, r, w_eff)
    return H, b


def _lil_terms(cam: Camera, T, lil: LILPoseObs, use_huber: bool, active):
    """H (6, 6), b (6,), cost, chi2 (N,) of the LIL edges at pose T
    (landmarks fixed, Optimizer.cc:650)."""
    r, J, _, _ = lil_residual_jac(cam, T[None], lil.state, lil.obs)
    chi2, w_eff, cost = lil_weights(r, active, use_huber)
    H = torch.einsum("nij,nik,n->jk", J, J, w_eff)
    b = -torch.einsum("nij,ni,n->j", J, r, w_eff)
    return H, b, cost, chi2


def pose_optimization(
    cam: Camera,
    T_init,
    po: PoseObs,
    rounds: int = 4,
    iters_per_round: int = 10,
    lil: LILPoseObs | None = None,
):
    """Optimize a single camera pose against fixed world points, plus fixed
    structural-line landmarks when ``lil`` is given.

    Returns (T_opt (4, 4), inlier_mask (N,), chi2 (N,), lil_inlier (Nl,) or
    None)."""
    N = po.valid.shape[0]
    E = -(-N // 128) * 128
    data0 = pack_pose_data(po)  # row 7 = po.valid: the classify block
    if E != N:
        data0 = torch.nn.functional.pad(data0, (0, E - N))
    # The LM block, row 7 the round's active edges. Its unmatched and padding
    # slots are parked 1 m down T_init's optical axis: a slot at the camera
    # centre (an empty map slot at the origin, seen from the identity pose a
    # new map starts at) overflows K2's Jacobian products to inf, and its zero
    # weight turns them into NaN in H.
    R, t = T_init[:3, :3], T_init[:3, 3]
    park = R[2] - t @ R  # R^T (e_z - t)
    data = data0.clone()
    data[0:3] = torch.where(data0[7] > 0.5, data0[0:3], park[:, None])
    rows = lm_rows(cam, T_init)
    state, par_huber, par_plain = rows[0], rows[1:2], rows[2:3]
    gate = torch.where(po.obs[..., 2] >= 0.0, CHI2_STEREO, CHI2_MONO)

    def classify():
        *_, chi2 = pose_terms(data0, par_plain)
        return chi2[:N]

    active = po.valid
    lil_active = None if lil is None else lil.valid
    for rnd in range(rounds):
        use_huber = rnd < 2
        par = par_huber if use_huber else par_plain
        data[7, :N] = active & po.valid
        for it in range(iters_per_round + 1):
            H, b, cost, _ = pose_terms(data, par)
            terms = None
            if lil is not None:
                Hx, bx, cost_x, _ = _lil_terms(cam, par[0, :16].view(4, 4), lil, use_huber,
                                               lil_active)
                terms = (Hx, bx, cost_x)
            if it < iters_per_round:
                lm_step(state, H, b, cost, par, par, lil=terms)
            else:
                lm_step(state, H, b, cost, par, par_plain, lil=terms, close=True)
        chi2 = classify()
        active = po.valid & (chi2 <= gate)
        if lil is not None:
            *_, lchi2 = _lil_terms(cam, par_plain[0, :16].view(4, 4), lil, False, lil.valid)
            lil_active = lil.valid & (lchi2 <= CHI2_LIL)
    chi2 = classify()
    return state[:16].view(4, 4), active, chi2, lil_active
