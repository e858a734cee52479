"""Parity of the structural-line (LIL) solver: ``lil_residual_jac`` (values
against the JAX package, Jacobians against ``torch.autograd`` as
tests/test_lil.py checks them against JAX autodiff), ``pose_optimization``
with LIL edges, and the joint point + LIL ``local_bundle_adjustment_lil``;
plus the fixed-order block sums that make the local BA deterministic.

Bars: residuals and Jacobians within 1e-4 relative of JAX's; analytic
Jacobians within 1e-3 of autograd (the bar of tests/test_lil.py); pose
rotation and translation within 1e-4 of JAX's and equal point and LIL inlier
masks; BA poses, points and LIL states within 1e-4 and equal inlier masks.
The JAX BA runs its scatter assembly (``PSLAM_BA_ONEHOT=0``, fresh jit
caches), as in tests/test_torch_local_ba.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam, se3_exp as j_se3_exp
from pslam_tpu.solver.ba_lil import LILBAEdges as JEdges
from pslam_tpu.solver.ba_lil import local_bundle_adjustment_lil as j_ba_lil
from pslam_tpu.solver.lil import LILPoseObs as JLIL
from pslam_tpu.solver.lil import lil_residual_jac as j_lil_rj
from pslam_tpu.solver.local_ba import BAProblem as JBAProblem
from pslam_tpu.solver.pose_opt import PoseObs as JPoseObs
from pslam_tpu.solver.pose_opt import pose_optimization as j_pose_opt
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam, se3_exp
from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil as t_ba_lil
from pslam_tpu_torch.solver.lil import lil_residual_jac as t_lil_rj
from pslam_tpu_torch.solver.local_ba import segment_sum, segment_table
from pslam_tpu_torch.solver.pose_opt import PoseObs as TPoseObs
from pslam_tpu_torch.solver.pose_opt import pose_optimization as t_pose_opt

CAM_KW = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, bf=40.0)
JC, TC = JCam(**CAM_KW), TCam(**CAM_KW)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes, and torch's default of a thread a
    core in each of them oversubscribes the host and slows these tests up
    to tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _se3(xi):
    return np.asarray(j_se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([CAM_KW["fx"] * Xc[..., 0] / Xc[..., 2] + CAM_KW["cx"],
                     CAM_KW["fy"] * Xc[..., 1] / Xc[..., 2] + CAM_KW["cy"]], -1)


def _line_eq(a, b):
    la, lb = a[1] - b[1], b[0] - a[0]
    lc = a[0] * b[1] - a[1] * b[0]
    n = np.hypot(la, lb)
    return np.array([la / n, lb / n, lc / n])


def _lils(rng, n):
    """Random LIL states (world): two segments crossing at X."""
    out = []
    for _ in range(n):
        X = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0])
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = rng.normal(size=3)
        d2 -= d1 * (d1 @ d2)
        d2 /= np.linalg.norm(d2)
        out.append(np.concatenate([X - 0.5 * d1, X + 0.7 * d1, X - 0.6 * d2, X + 0.4 * d2, X]))
    return np.asarray(out, np.float32)


def _observe(T, states):
    """Exact 8-d observations [l1, l2, uv_ins] of LIL states from pose T."""
    obs = []
    for st in states:
        uv = _project(T.astype(np.float64), st.reshape(5, 3).astype(np.float64))
        obs.append(np.concatenate([_line_eq(uv[0], uv[1]), _line_eq(uv[2], uv[3]), uv[4]]))
    return np.asarray(obs, np.float32)


def test_residual_and_jacobians_match_jax():
    rng = np.random.default_rng(0)
    T = _se3([0.03, -0.02, 0.05, 0.1, -0.2, 0.15])
    states = _lils(rng, 6)
    obs = _observe(_se3([0.0, 0.01, 0.0, 0.02, 0.0, 0.0]) @ T, states)  # r != 0
    ref = j_lil_rj(JC, jnp.asarray(T)[None], jnp.asarray(states), jnp.asarray(obs))
    got = t_lil_rj(TC, _t(T)[None], _t(states), _t(obs))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
    assert np.abs(np.asarray(ref[0])).max() > 0.1


def test_pose_jacobian_matches_autograd():
    rng = np.random.default_rng(1)
    T = _t(_se3([0.03, -0.02, 0.05, 0.1, -0.2, 0.15]))
    states, obs = _t(_lils(rng, 4)), None
    obs = _t(_observe(T.numpy(), states.numpy()))
    _, J_pose, _, _ = t_lil_rj(TC, T[None], states, obs)

    def res_of_xi(xi):
        return t_lil_rj(TC, (se3_exp(xi) @ T)[None], states, obs)[0]

    J_auto = torch.autograd.functional.jacobian(res_of_xi, torch.zeros(6))  # (n, 6, 6)
    err = (J_pose - J_auto).abs().max().item()
    assert err < 1e-3, err


def test_landmark_jacobian_matches_autograd():
    rng = np.random.default_rng(2)
    T = _t(_se3([0.02, 0.04, -0.03, -0.1, 0.2, 0.1]))
    states = _t(_lils(rng, 3))
    obs = _t(_observe(T.numpy(), states.numpy()))
    _, _, J_lm, _ = t_lil_rj(TC, T[None], states, obs)

    def res_of_shift(s):
        return t_lil_rj(TC, T[None], states + s.repeat(5)[None, :], obs)[0]

    J_auto = torch.autograd.functional.jacobian(res_of_shift, torch.zeros(3))
    err = (J_lm - J_auto).abs().max().item()
    assert err < 1e-3, err


def _pose_problem(seed, bad_lil: bool):
    rng = np.random.default_rng(seed)
    T_true = _se3([0.05, 0.02, -0.04, 0.2, -0.1, 0.3])
    n = 80
    X = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (n, 3)).astype(np.float32)
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = _project(T_true, X) + rng.normal(0, 0.4, (n, 2))
    ur = uv[:, 0] - CAM_KW["bf"] / Xc[:, 2]
    ur[rng.uniform(size=n) < 0.3] = -1.0
    obs = np.c_[uv, ur].astype(np.float32)
    states = _lils(rng, 8)
    lobs = _observe(T_true, states)
    if bad_lil:
        lobs[0, 6:8] += 300.0  # gross crosspoint outlier
    valid = np.r_[np.ones(7, bool), False]  # one padding slot
    T0 = _se3([0.02, -0.02, 0.02, 0.1, 0.1, -0.1]) @ T_true
    return T_true, T0, X, obs, states, lobs, valid


@pytest.mark.parametrize("seed,bad_lil", [(3, False), (4, True)])
def test_pose_optimization_with_lils_matches_jax(seed, bad_lil):
    T_true, T0, X, obs, states, lobs, lvalid = _pose_problem(seed, bad_lil)
    n = len(X)
    ones = np.ones(n, np.float32)
    T_j, in_j, _, lin_j = j_pose_opt(
        JC, jnp.asarray(T0),
        JPoseObs(X_w=jnp.asarray(X), obs=jnp.asarray(obs), inv_sigma2=jnp.asarray(ones),
                 valid=jnp.ones(n, bool)),
        lil=JLIL(state=jnp.asarray(states), obs=jnp.asarray(lobs), valid=jnp.asarray(lvalid)),
    )
    T_t, in_t, _, lin_t = t_pose_opt(
        TC, _t(T0),
        TPoseObs(X_w=_t(X), obs=_t(obs), inv_sigma2=_t(ones), valid=torch.ones(n, dtype=torch.bool)),
        lil=interop.lil_pose_obs_from_numpy(JLIL(state=states, obs=lobs, valid=lvalid), device="cpu"),
    )
    T_j, T_t = np.asarray(T_j), T_t.numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    np.testing.assert_array_equal(lin_t.numpy(), np.asarray(lin_j))
    assert lin_t.numpy()[0] != bad_lil and lin_t.numpy()[1:7].all()
    assert not lin_t.numpy()[7]  # padding never becomes an inlier
    assert np.abs(T_t[:3, 3] - T_true[:3, 3]).max() < 2e-2


def _ba_problem(seed=5):
    rng = np.random.default_rng(seed)
    C, P, Q, n_free = 4, 120, 6, 2
    X = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (P, 3)).astype(np.float32)
    T_true = np.stack([_se3(np.r_[rng.normal(0, 0.02, 3), [0.3 * i - 0.45, 0, 0.02 * i]])
                       for i in range(C)])
    cam_idx = np.repeat(np.arange(C), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), C).astype(np.int32)
    Xc = np.einsum("eij,ej->ei", T_true[cam_idx, :3, :3], X[pt_idx]) + T_true[cam_idx, :3, 3]
    uv = _project(np.eye(4), Xc) + rng.normal(0, 0.3, (len(Xc), 2))
    obs = np.c_[uv, uv[:, 0] - CAM_KW["bf"] / Xc[:, 2]].astype(np.float32)
    bad = rng.uniform(size=len(obs)) < 0.03
    obs[bad, :2] += 40.0
    states = _lils(rng, Q)
    le_cam = np.repeat(np.arange(C), Q).astype(np.int32)
    le_lil = np.tile(np.arange(Q), C).astype(np.int32)
    le_obs = np.concatenate([_observe(T_true[c], states) for c in range(C)])
    le_obs[3, 6:8] += 200.0  # one LIL edge outlier
    El, Qp = 32, 8  # padded like line_mapping.assemble_lil_edges
    pad = El - len(le_cam)
    free_slot = np.full(C, -1, np.int32)
    free_slot[1: 1 + n_free] = np.arange(n_free)
    T0 = T_true.copy()
    for c in range(1, 1 + n_free):
        T0[c] = _se3(rng.normal(0, 0.02, 6)) @ T0[c]
    lil0 = states + np.tile(rng.normal(0, 0.05, (Q, 3)).astype(np.float32), (1, 5))
    prob = dict(
        T_cw=T0.astype(np.float32), free_slot=free_slot,
        X_w=(X + rng.normal(0, 0.03, X.shape)).astype(np.float32),
        point_valid=np.ones(P, bool), cam_idx=cam_idx, pt_idx=pt_idx, obs=obs,
        inv_sigma2=np.ones(len(obs), np.float32), edge_valid=np.ones(len(obs), bool),
    )
    edges = dict(
        cam_idx=np.r_[le_cam, np.zeros(pad, np.int32)],
        lil_idx=np.r_[le_lil, np.zeros(pad, np.int32)],
        obs=np.r_[le_obs, np.zeros((pad, 8), np.float32)],
        valid=np.r_[np.ones(len(le_cam), bool), np.zeros(pad, bool)],
    )
    lil_state = np.r_[lil0, np.zeros((Qp - Q, 15), np.float32)].astype(np.float32)
    lil_valid = np.r_[np.ones(Q, bool), np.zeros(Qp - Q, bool)]
    return prob, edges, lil_state, lil_valid, n_free, states


def test_local_ba_lil_matches_jax():
    prob, edges, lil_state, lil_valid, n_free, states = _ba_problem()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        out_j = jax.device_get(j_ba_lil(
            JC, JBAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}),
            jnp.asarray(lil_state), jnp.asarray(lil_valid),
            JEdges(**{k: jnp.asarray(v) for k, v in edges.items()}), n_free))
    jax.clear_caches()
    out_t = [o.numpy() for o in t_ba_lil(
        TC, interop.ba_problem_from_numpy(JBAProblem(**prob), device="cpu"), _t(lil_state), _t(lil_valid),
        interop.lil_ba_edges_from_numpy(JEdges(**edges), device="cpu"), n_free)]
    T_j, X_j, l_j, inp_j, inl_j = out_j
    T_t, X_t, l_t, inp_t, inl_t = out_t
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(l_t, l_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inp_t, inp_j)
    np.testing.assert_array_equal(inl_t, inl_j)
    # The solve moved the LIL crosspoints toward the truth and gated the
    # planted outlier edge; padding LIL slots stay where they were.
    err0 = np.linalg.norm(lil_state[:6, 12:15] - states[:, 12:15], axis=1).mean()
    err1 = np.linalg.norm(l_t[:6, 12:15] - states[:, 12:15], axis=1).mean()
    assert err1 < 0.4 * err0
    assert not inl_t[3] and inl_t[:24].sum() >= 20 and not inl_t[24:].any()
    np.testing.assert_array_equal(l_t[6:], lil_state[6:])


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_matches_index_add(seed):
    """The fixed-order block sums equal an ``index_add_`` scatter (to f32
    rounding), drop out-of-range targets, and list each target's edges in
    increasing order."""
    rng = np.random.default_rng(seed)
    E, n = 500, 37
    target = torch.from_numpy(rng.integers(-3, n + 3, E))
    vals = torch.from_numpy(rng.normal(size=(E, 6, 3)).astype(np.float32))
    table = segment_table(target, n)
    got = segment_sum(vals, table)
    keep = (target >= 0) & (target < n)
    ref = torch.zeros((n + 1, 6, 3)).index_add_(0, torch.where(keep, target, n), vals)[:n]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    rows = table.numpy()
    for t in range(n):
        r = rows[t][rows[t] < E]
        np.testing.assert_array_equal(r, np.flatnonzero(target.numpy() == t))
    assert torch.equal(segment_sum(vals, segment_table(target, n)), got)
