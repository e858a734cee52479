"""Parity of kernel K2's plain version (``ops/fused_pose.pose_terms``) against
the JAX package's ``pose_terms_fused(..., interpret=True)`` on the inputs of
tests/test_pallas_pose.py, and of the port's ``pose_optimization`` against
the JAX one (CPU jnp path) on the same ``PoseObs``; the LM step's plain
version and the solve against an inline copy of the plain LM loop, bit for
bit, and the solve's 49 K2 calls.

Tolerances (f32 sums over 512 edges in another order): H rtol 2e-4 / atol
1e-3, b atol 1e-2, cost rtol 1e-5, chi2 1e-4 (those of
tests/test_pallas_pose.py). Pose: rotation <= 1e-4 rad, translation <= 1e-4
m, inlier masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam, se3_exp as j_se3_exp
from pslam_tpu.ops.pallas_pose import (
    pack_pose_data as j_pack_data,
    pack_pose_params as j_pack_params,
    pose_terms_fused as j_pose_terms,
)
from pslam_tpu.solver.pose_opt import PoseObs as JPoseObs
from pslam_tpu.solver.pose_opt import pose_optimization as j_pose_opt
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.geometry import se3_exp as t_se3_exp
from pslam_tpu_torch.ops import fused_pose
from pslam_tpu_torch.solver.lil import LILPoseObs as TLIL
from pslam_tpu_torch.solver.pose_opt import PoseObs as TPoseObs
from pslam_tpu_torch.solver.pose_opt import pose_optimization as t_pose_opt

CAM_KW = dict(fx=500.0, fy=505.0, cx=320.0, cy=240.0, bf=40.0)


def _edges(seed, E=512, outliers=0.0, noise=2.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (E, 3)).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray(
        np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)].astype(np.float32))))
    Xc = X @ T[:3, :3].T + T[:3, 3]
    cam = CAM_KW
    u = cam["fx"] * Xc[:, 0] / Xc[:, 2] + cam["cx"] + rng.normal(0, noise, E)
    v = cam["fy"] * Xc[:, 1] / Xc[:, 2] + cam["cy"] + rng.normal(0, noise, E)
    ur = u - cam["bf"] / Xc[:, 2] + rng.normal(0, noise / 2, E)
    ur[rng.uniform(size=E) < 0.3] = -1.0  # mono edges
    bad = rng.uniform(size=E) < outliers
    u[bad] += rng.uniform(-60, 60, bad.sum())
    v[bad] += rng.uniform(-60, 60, bad.sum())
    obs = np.stack([u, v, ur], axis=1).astype(np.float32)
    inv_s2 = rng.uniform(0.3, 1.0, E).astype(np.float32)
    valid = rng.uniform(size=E) > 0.15
    active = valid & (rng.uniform(size=E) > 0.1)
    return X, T, obs, inv_s2, valid, active


@pytest.mark.parametrize("seed,use_huber", [(0, True), (1, False)])
def test_pose_terms_plain_matches_pallas(seed, use_huber):
    X, T, obs, inv_s2, valid, active = _edges(seed)
    po = JPoseObs(X_w=jnp.asarray(X), obs=jnp.asarray(obs),
                  inv_sigma2=jnp.asarray(inv_s2), valid=jnp.asarray(valid))
    data = j_pack_data(po).at[7].set(jnp.asarray(active, jnp.float32))
    par = j_pack_params(JCam(**CAM_KW), jnp.asarray(T),
                        jnp.asarray(1.0 if use_huber else 0.0))
    H_j, b_j, cost_j, chi2_j = j_pose_terms(data, par, interpret=True)

    tpo = TPoseObs(X_w=torch.from_numpy(X), obs=torch.from_numpy(obs),
                   inv_sigma2=torch.from_numpy(inv_s2), valid=torch.from_numpy(valid))
    t_data = fused_pose.pack_pose_data(tpo)
    t_data[7] = torch.from_numpy(active.astype(np.float32))
    tail = fused_pose.pose_param_tail(TCam(**CAM_KW), use_huber, "cpu")
    t_par = fused_pose.pack_pose_params(torch.from_numpy(T.copy()), tail)
    # The same packing on both sides.
    np.testing.assert_array_equal(t_data.numpy(), np.asarray(data))
    np.testing.assert_array_equal(t_par.numpy(), np.asarray(par))
    before = fused_pose.LAUNCHES
    H_t, b_t, cost_t, chi2_t = fused_pose.pose_terms(t_data, t_par)
    assert fused_pose.LAUNCHES == before  # CPU tensors take the plain path
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-5)
    np.testing.assert_allclose(chi2_t.numpy(), np.asarray(chi2_j), rtol=1e-4, atol=1e-4)


def _rot_err(Ra, Rb):
    """Small rotation angle between two nearly orthonormal f32 matrices, from
    the skew part of Ra^T Rb (the trace form loses ~sqrt(eps) near 0)."""
    D = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.linalg.norm(w))


@pytest.mark.parametrize("seed,N", [(2, 300), (3, 1000)])
def test_pose_optimization_matches_jax(seed, N):
    X, T_true, obs, inv_s2, valid, _ = _edges(seed, E=N, outliers=0.1, noise=1.0)
    rng = np.random.default_rng(100 + seed)
    dT = np.asarray(j_se3_exp(jnp.asarray(
        np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.03, 3)].astype(np.float32))))
    T0 = (dT @ T_true).astype(np.float32)
    T_j, in_j, chi2_j, _ = j_pose_opt(
        JCam(**CAM_KW), jnp.asarray(T0),
        JPoseObs(X_w=jnp.asarray(X), obs=jnp.asarray(obs),
                 inv_sigma2=jnp.asarray(inv_s2), valid=jnp.asarray(valid)),
    )
    T_t, in_t, chi2_t, lil_t = t_pose_opt(
        TCam(**CAM_KW), torch.from_numpy(T0),
        TPoseObs(X_w=torch.from_numpy(X), obs=torch.from_numpy(obs),
                 inv_sigma2=torch.from_numpy(inv_s2), valid=torch.from_numpy(valid)),
    )
    assert lil_t is None  # no LIL edges given
    T_j, T_t = np.asarray(T_j), T_t.numpy()
    assert _rot_err(T_j[:3, :3], T_t[:3, :3]) <= 1e-4
    assert np.abs(T_j[:3, 3] - T_t[:3, 3]).max() <= 1e-4
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    # The solve really moved the pose back onto the truth.
    assert np.abs(T_t[:3, 3] - T_true[:3, 3]).max() < np.abs(T0[:3, 3] - T_true[:3, 3]).max()
    assert in_t.numpy().sum() > 0.6 * valid.sum()


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only CPU tensors run the plain version; a meta tensor goes to the
    kernel's checks, which refuse it."""
    data = torch.empty((8, 128), dtype=torch.float32, device="meta")
    par = torch.empty((1, 128), dtype=torch.float32, device="meta")
    before = fused_pose.LAUNCHES
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fused_pose.pose_terms(data, par)
    assert fused_pose.LAUNCHES == before


# ---------------------------------------------------------------------------
# The LM step (``fused_pose.lm_step``): its plain version against an inline
# copy of the pose solve's LM loop body as it stood before the step became
# one function, bit for bit.


def _loop_accept(T, lam, cost, H, b, T_new, H_new, b_new, cost_new):
    """Accept or reject the evaluation of T_new (the loop body's tail)."""
    accept = cost_new < cost
    T = torch.where(accept, T_new, T)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
    cost = torch.where(accept, cost_new, cost)
    H = torch.where(accept, H_new, H)
    b = torch.where(accept, b_new, b)
    return T, lam, cost, H, b


def _loop_propose(H, b, lam, T):
    """The next proposal (the loop body's head)."""
    eye = torch.eye(6, dtype=H.dtype)
    Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye
    dx = torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
    return t_se3_exp(dx) @ T


def _random_terms(rng, scale):
    J = (rng.normal(size=(40, 6)) * np.array([500, 500, 500, 100, 100, 100]) * scale)
    H = torch.from_numpy((J.T @ J).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=6) * 1e3 * scale).astype(np.float32))
    cost = torch.tensor(rng.uniform(50, 500) * scale, dtype=torch.float32)
    return H, b, cost


def _random_pose(rng, sigma=(0.05, 0.2)):
    xi = np.r_[rng.normal(0, sigma[0], 3), rng.normal(0, sigma[1], 3)].astype(np.float32)
    return t_se3_exp(torch.from_numpy(xi))


LM_CASES = ["first", "first_nan", "accept", "reject", "nan_cost", "close_accept",
            "close_reject"]


@pytest.mark.parametrize("with_lil", [False, True], ids=["points", "lil"])
@pytest.mark.parametrize("case", LM_CASES)
def test_lm_step_plain_matches_the_loop_body(case, with_lil):
    rng = np.random.default_rng(LM_CASES.index(case) + 10 * with_lil)
    H, b, cost = _random_terms(rng, 1.0)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2), dtype=torch.float32)
    T = _random_pose(rng)
    T_new = _random_pose(rng, (0.01, 0.03)) @ T
    H_new, b_new, cost_new = _random_terms(rng, 1.0)
    if case in ("accept", "close_accept"):
        cost_new = cost * 0.5
    elif case in ("reject", "close_reject"):
        cost_new = cost * 2.0
    elif case in ("first_nan", "nan_cost"):
        cost_new = torch.tensor(float("nan"))
    lil = _random_terms(rng, 0.01) if with_lil else None
    # What the loop body adds before it compares.
    H_e, b_e, cost_e = (H_new, b_new, cost_new) if lil is None else (
        H_new + lil[0], b_new + lil[1], cost_new + lil[2])

    first = case.startswith("first")
    close = case.startswith("close")
    rows = fused_pose.lm_rows(TCam(**CAM_KW), T)
    state, par, par_cls = rows[0], rows[1:2], rows[2:3]
    if first:
        # H, b, cost = all_terms(T); lam = 1e-4; then the first proposal.
        T_exp, cost_x, H_x, b_x = T, cost_e, H_e, b_e
        lam_x = torch.tensor(1e-4, dtype=torch.float32)
    else:
        state[fused_pose.LM_LAM] = lam
        state[fused_pose.LM_COST] = cost
        state[fused_pose.LM_H:fused_pose.LM_H + 36] = H.reshape(36)
        state[fused_pose.LM_B:fused_pose.LM_B + 6] = b
        state[fused_pose.LM_FIRST] = 0.0
        par[0, :16] = T_new.reshape(16)
        T_exp, lam_x, cost_x, H_x, b_x = _loop_accept(T, lam, cost, H, b, T_new, H_e, b_e,
                                                      cost_e)
    before = fused_pose.LM_LAUNCHES
    if close:
        fused_pose.lm_step(state, H_new, b_new, cost_new, par, par_cls, lil=lil, close=True)
    else:
        fused_pose.lm_step(state, H_new, b_new, cost_new, par, par, lil=lil)
    assert fused_pose.LM_LAUNCHES == before  # CPU tensors take the plain path

    def field(at, n):
        return state[at:at + n]

    assert torch.equal(field(fused_pose.LM_T, 16), T_exp.reshape(16))
    assert torch.equal(field(fused_pose.LM_H, 36), H_x.reshape(36))
    assert torch.equal(field(fused_pose.LM_B, 6), b_x)
    np.testing.assert_array_equal(state[fused_pose.LM_COST].numpy(), cost_x.numpy())
    if close:
        # The round's pose in the classify row and the next round's row;
        # lambda and the first-evaluation flag reset for that round.
        assert torch.equal(par_cls[0, :16], T_exp.reshape(16))
        assert torch.equal(par[0, :16], T_exp.reshape(16))
        assert float(state[fused_pose.LM_LAM]) == np.float32(1e-4)
        assert float(state[fused_pose.LM_FIRST]) == 1.0
    else:
        assert torch.equal(state[fused_pose.LM_LAM], lam_x)
        assert float(state[fused_pose.LM_FIRST]) == 0.0
        assert torch.equal(par[0, :16], _loop_propose(H_x, b_x, lam_x, T_exp).reshape(16))
    if case == "accept":
        assert not torch.equal(T_exp, T)
    if case in ("reject", "nan_cost"):
        assert torch.equal(T_exp, T) and float(lam_x) == min(float(lam) * 4, 1e6)
    if case == "first_nan":
        assert torch.isnan(state[fused_pose.LM_COST])  # kept, as the loop keeps it


def _old_pose_optimization(cam, T_init, po, lil=None, rounds=4, iters_per_round=10):
    """The pose solve as it was before the LM step: lm_round's loop in plain
    torch (K2's plain version for the point terms)."""
    from pslam_tpu_torch.solver.lil import CHI2_LIL
    from pslam_tpu_torch.solver.pose_opt import _lil_terms
    from pslam_tpu_torch.solver.robust import CHI2_MONO, CHI2_STEREO

    N = po.valid.shape[0]
    E = -(-N // 128) * 128
    data0 = torch.nn.functional.pad(fused_pose.pack_pose_data(po), (0, E - N))
    tails = {h: fused_pose.pose_param_tail(cam, h, "cpu") for h in (False, True)}
    gate = torch.where(po.obs[..., 2] >= 0.0, torch.tensor(CHI2_STEREO),
                       torch.tensor(CHI2_MONO))

    def lm_round(T, active, lil_active, use_huber):
        data = data0.clone()
        data[7, :N] = (active & po.valid).to(torch.float32)

        def all_terms(T):
            H, b, cost, _ = fused_pose.pose_terms_plain(
                data, fused_pose.pack_pose_params(T, tails[use_huber]))
            if lil is not None:
                Hx, bx, cost_x, _ = _lil_terms(cam, T, lil, use_huber, lil_active)
                H, b, cost = H + Hx, b + bx, cost + cost_x
            return H, b, cost

        H, b, cost = all_terms(T)
        lam = torch.tensor(1e-4, dtype=T.dtype)
        for _ in range(iters_per_round):
            T_new = _loop_propose(H, b, lam, T)
            H_new, b_new, cost_new = all_terms(T_new)
            T, lam, cost, H, b = _loop_accept(T, lam, cost, H, b, T_new, H_new, b_new,
                                              cost_new)
        return T

    def classify(T):
        data = data0.clone()
        data[7, :N] = po.valid.to(torch.float32)
        return fused_pose.pose_terms_plain(
            data, fused_pose.pack_pose_params(T, tails[False]))[3][:N]

    active, T = po.valid, T_init
    lil_active = None if lil is None else lil.valid
    for rnd in range(rounds):
        T = lm_round(T, active, lil_active, rnd < 2)
        active = po.valid & (classify(T) <= gate)
        if lil is not None:
            *_, lchi2 = _lil_terms(cam, T, lil, False, lil.valid)
            lil_active = lil.valid & (lchi2 <= CHI2_LIL)
    return T, active, classify(T), lil_active


def _solve_inputs(seed, N, with_lil):
    X, T_true, obs, inv_s2, valid, _ = _edges(seed, E=N, outliers=0.1, noise=1.0)
    rng = np.random.default_rng(200 + seed)
    T0 = _random_pose(rng, (0.01, 0.03)) @ torch.from_numpy(T_true.copy())
    po = TPoseObs(X_w=torch.from_numpy(X), obs=torch.from_numpy(obs),
                  inv_sigma2=torch.from_numpy(inv_s2), valid=torch.from_numpy(valid))
    lil = None
    if with_lil:
        state = rng.uniform(-1.0, 1.0, (8, 15)).astype(np.float32)
        state[:, 2::3] += 4.0
        lobs = rng.normal(0, 1, (8, 8)).astype(np.float32)
        lobs[:, 6:] = rng.uniform(150, 350, (8, 2))
        lil = TLIL(state=torch.from_numpy(state), obs=torch.from_numpy(lobs),
                   valid=torch.from_numpy(rng.uniform(size=8) > 0.2))
    return T0, po, lil


@pytest.mark.parametrize("with_lil", [False, True], ids=["points", "lil"])
def test_pose_optimization_matches_the_plain_loop_bit_for_bit(with_lil):
    T0, po, lil = _solve_inputs(5, 300, with_lil)
    cam = TCam(**CAM_KW)
    got = t_pose_opt(cam, T0, po, lil=lil)
    want = _old_pose_optimization(cam, T0, po, lil=lil)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("with_lil", [False, True], ids=["points", "lil"])
def test_pose_optimization_calls_k2_49_times(monkeypatch, with_lil):
    """49 ``pose_terms`` calls a solve (what ``k2_roofline`` wraps and
    ``utils/profile.K2_CALLS_A_SOLVE`` assumes) and 44 LM steps, 4 of them
    closing a round, with or without LIL terms."""
    from pslam_tpu_torch.solver import pose_opt
    from pslam_tpu_torch.utils.profile import K2_CALLS_A_SOLVE

    calls, steps = [], []
    real_terms, real_step = pose_opt.pose_terms, pose_opt.lm_step

    def spy_terms(data, par):
        calls.append(int(par[0, 21]))
        return real_terms(data, par)

    def spy_step(*args, **kwargs):
        steps.append(bool(kwargs.get("close", False)))
        return real_step(*args, **kwargs)

    monkeypatch.setattr(pose_opt, "pose_terms", spy_terms)
    monkeypatch.setattr(pose_opt, "lm_step", spy_step)
    T0, po, lil = _solve_inputs(6, 200, with_lil)
    pose_opt.pose_optimization(TCam(**CAM_KW), T0, po, lil=lil)
    assert len(calls) == K2_CALLS_A_SOLVE == 49
    # Rounds 0-1 with Huber (11 calls each), 2-3 without, a classify a round
    # and a final one without.
    assert calls == [1] * 11 + [0] + [1] * 11 + [0] + ([0] * 12) * 2 + [0]
    assert len(steps) == 44 and steps == ([False] * 10 + [True]) * 4


def test_lm_step_non_cpu_tensor_never_takes_the_plain_path():
    """Only CPU tensors run the plain LM step; a meta tensor goes to the
    kernel's checks, which refuse it."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    before = fused_pose.LM_LAUNCHES
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fused_pose.lm_step(meta(128), meta(6, 6), meta(6), meta(), meta(1, 128),
                           meta(1, 128))
    assert fused_pose.LM_LAUNCHES == before


def _k2_order_H(data, par):
    """H as csrc/fused_pose.cu sums it, in f32: w (J0i J0j + J1i J1j + J2i
    J2j) an edge (the robust weight, finite and at most 1, left out). Unlike
    the plain version's einsum, a zero weight times an overflowed product is
    NaN here."""
    d = data.numpy()
    p = par.numpy().reshape(-1)
    T = p[:16].reshape(4, 4)
    fx, fy, bf = p[16], p[17], p[20]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        x, y, z = T[:3, :3] @ d[0:3] + T[:3, 3:4]
        iz = np.float32(1.0) / np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
        iz2 = iz * iz
        a, b, c, e = fx * iz, -fx * x * iz2, fy * iz, -fy * y * iz2
        be = b + bf * iz2
        sm = (d[5] >= 0).astype(np.float32)
        o = np.zeros_like(z)
        J = np.stack([
            np.stack([-(b * y), -(a * z - b * x), a * y, -a, o, -b]),
            np.stack([-(e * y - c * z), e * x, -(c * x), o, -c, -e]),
            np.stack([-(be * y) * sm, -(a * z - be * x) * sm, a * y * sm, -a * sm, o, -be * sm]),
        ])  # (3, 6, E)
        JJ = (J[:, :, None] * J[:, None, :]).sum(0)  # (6, 6, E)
        return (d[6] * d[7] * JJ).sum(-1)


def test_lm_evaluations_are_finite_from_the_identity(monkeypatch):
    """The first frame after a map's initialization solves from the identity,
    and the unmatched slots of its local map hold the origin, the camera
    centre: summed K2's way their zero weights times inf would make H NaN.
    Every LM evaluation of the solve must stay finite summed that way."""
    from pslam_tpu_torch.solver import pose_opt

    X, T_true, obs, inv_s2, valid, _ = _edges(7, E=300, noise=1.0)
    X[~valid] = 0.0
    po = TPoseObs(X_w=torch.from_numpy(X), obs=torch.from_numpy(obs),
                  inv_sigma2=torch.from_numpy(inv_s2), valid=torch.from_numpy(valid))
    seen, real_terms = [], pose_opt.pose_terms

    def spy_terms(data, par):
        if not seen or data.data_ptr() == seen[0][0]:  # the LM block, not classify's
            seen.append((data.data_ptr(), _k2_order_H(data, par)))
        return real_terms(data, par)

    monkeypatch.setattr(pose_opt, "pose_terms", spy_terms)
    T, inl, *_ = pose_opt.pose_optimization(TCam(**CAM_KW), torch.eye(4), po)
    assert len(seen) == 44
    assert all(np.isfinite(H).all() for _, H in seen)
    assert np.abs(T.numpy()[:3, 3] - T_true[:3, 3]).max() < 1e-2
    assert inl.numpy().sum() > 0.6 * valid.sum()
