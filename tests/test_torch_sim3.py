"""Sim3 group operations and the Sim3 solvers: the JAX package against the
port on the same numpy inputs (CPU).

Bars: exp/log/compose/inverse/transform within 1e-6 (each branch of
sim3_exp: generic, small sigma, small theta, both small); optimize_sim3 and
optimize_essential_graph on the problems of tests/test_sim3_graph.py within
1e-4 (the port's Jacobians are forward-mode derivatives, as JAX's jacfwd),
with the same inlier sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import lie as jlie
from pslam_tpu.geometry import se3_exp as j_se3_exp
from pslam_tpu.geometry.camera import Camera as JCam, project as j_project
from pslam_tpu.solver import sim3_graph as jsg
from pslam_tpu_torch.geometry import lie as tlie
from pslam_tpu_torch.geometry.camera import Camera as TCam
from pslam_tpu_torch.solver import sim3_graph as tsg

CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
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


def _tangents(seed=0):
    """Tangents covering every branch of sim3_exp, batched."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 0.3, (16, 7)).astype(np.float32)
    z[4:8, 6] = rng.normal(0, 1e-8, 4)  # sigma ~ 0
    z[8:12, :3] = rng.normal(0, 1e-8, (4, 3))  # theta ~ 0
    z[12:16, :3] = rng.normal(0, 1e-8, (4, 3))  # both ~ 0
    z[12:16, 6] = rng.normal(0, 1e-8, 4)
    return z


def _j(g):
    return [np.asarray(a) for a in g]


def _t(g):
    return [a.numpy() for a in g]


def _tsim(z):
    return tlie.Sim3(*(torch.from_numpy(np.asarray(a, np.float32)) for a in z))


def test_sim3_exp_log_compose_inverse_transform():
    z = _tangents()
    gj, gt = jlie.sim3_exp(jnp.asarray(z)), tlie.sim3_exp(torch.from_numpy(z))
    for a, b in zip(_j(gj), _t(gt)):
        np.testing.assert_allclose(b, a, atol=1e-6)
    np.testing.assert_allclose(tlie.sim3_log(gt).numpy(), np.asarray(jlie.sim3_log(gj)), atol=1e-6)

    hj = jlie.sim3_exp(jnp.asarray(z[::-1].copy()))
    ht = tlie.sim3_exp(torch.from_numpy(z[::-1].copy()))
    for a, b in zip(_j(jlie.sim3_compose(gj, hj)), _t(tlie.sim3_compose(gt, ht))):
        np.testing.assert_allclose(b, a, atol=1e-6)
    for a, b in zip(_j(jlie.sim3_inverse(gj)), _t(tlie.sim3_inverse(gt))):
        np.testing.assert_allclose(b, a, atol=1e-6)
    X = np.random.default_rng(1).normal(0, 1, (16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.sim3_transform_points(gt, torch.from_numpy(X)).numpy(),
        np.asarray(jlie.sim3_transform_points(gj, jnp.asarray(X))), atol=1e-5,
    )
    T = np.array(j_se3_exp(jnp.asarray(z[:, :6])))
    np.testing.assert_allclose(
        tlie.sim3_to_se3(gt).numpy(), np.asarray(jlie.sim3_to_se3(gj)), atol=1e-6
    )
    for a, b in zip(_j(jlie.sim3_from_se3(jnp.asarray(T))),
                    _t(tlie.sim3_from_se3(torch.from_numpy(T)))):
        np.testing.assert_array_equal(b, a)


def _sim3_problem(fix_scale, noise=0.3, outliers=False):
    """tests/test_sim3_graph.py TestOptimizeSim3._problem (+ its outlier case)."""
    rng = np.random.default_rng(0)
    N = 80
    X2 = rng.uniform([-2, -2, 2], [2, 2, 6], (N, 3)).astype(np.float32)
    s = 1.0 if fix_scale else 1.4
    xi = np.array([0.1, -0.05, 0.15, 0.3, -0.2, 0.1], np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray(xi)))
    X1 = s * (X2 @ T[:3, :3].T) + T[:3, 3]
    uv1 = np.array(j_project(JC, jnp.asarray(X1)))
    uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 = np.asarray(j_project(JC, jnp.asarray(X2)))
    g_true = (np.float32(s), T[:3, :3], T[:3, 3])
    if outliers:
        bad = rng.choice(N, 15, replace=False)
        uv1[bad] += rng.uniform(30, 80, (15, 2)).astype(np.float32)
        g_init = g_true
    else:
        dz = np.zeros(7, np.float32)
        dz[:6] = rng.normal(0, 0.03, 6)
        if not fix_scale:
            dz[6] = 0.05
        g_init = _j(jlie.sim3_compose(jlie.sim3_exp(jnp.asarray(dz)),
                                      jlie.Sim3(*(jnp.asarray(a) for a in g_true))))
    return X1, X2, uv1.astype(np.float32), uv2, g_init


@pytest.mark.parametrize("fix_scale,outliers", [(False, False), (True, False), (False, True)],
                         ids=["sim3", "fixed_scale", "outliers"])
def test_optimize_sim3_matches_jax(fix_scale, outliers):
    X1, X2, uv1, uv2, g0 = _sim3_problem(fix_scale, noise=0.2 if outliers else 0.3,
                                         outliers=outliers)
    N = len(X1)
    ones = np.ones(N, np.float32)
    valid = np.ones(N, bool)
    args = (X1, X2, uv1, uv2, ones, ones, valid)
    rj = jsg.optimize_sim3(JC, jlie.Sim3(*(jnp.asarray(a) for a in g0)),
                           *(jnp.asarray(a) for a in args), fix_scale=fix_scale)
    rt = tsg.optimize_sim3(TC, _tsim(g0), *(torch.from_numpy(np.asarray(a)) for a in args),
                           fix_scale=fix_scale)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= N - 20
    for a, b in zip(_j(rj.g12), _t(rt.g12)):
        np.testing.assert_allclose(b, a, atol=1e-4)


def test_optimize_essential_graph_matches_jax():
    """tests/test_sim3_graph.py's circle: a drifting odometry chain of 12
    keyframes and one loop edge to the fixed first one."""
    rng = np.random.default_rng(1)
    K = 12
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        xi = np.array([0.0, a, 0.0, np.cos(a), 0.0, np.sin(a)], np.float32)
        T = np.asarray(j_se3_exp(jnp.asarray(xi)))
        gt.append(jlie.Sim3(s=jnp.float32(1.0), R=jnp.asarray(T[:3, :3]), t=jnp.asarray(T[:3, 3])))
    meas = [jlie.sim3_compose(gt[i + 1], jlie.sim3_inverse(gt[i])) for i in range(K - 1)]
    est = [gt[0]]
    for i in range(K - 1):
        dz = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3),
                   rng.normal(0, 0.005)].astype(np.float32)
        est.append(jlie.sim3_compose(jlie.sim3_compose(jlie.sim3_exp(jnp.asarray(dz)), meas[i]),
                                     est[i]))
    all_meas = meas + [jlie.sim3_compose(gt[0], jlie.sim3_inverse(gt[K - 1]))]

    def stack(gs):
        return [np.stack([np.asarray(getattr(g, f)) for g in gs]) for f in ("s", "R", "t")]

    S0, Sm = stack(est), stack(all_meas)
    e_i = np.r_[np.arange(K - 1), [K - 1]]
    e_j = np.r_[np.arange(1, K), [0]]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    pj = jsg.PoseGraphProblem(
        S=jlie.Sim3(*(jnp.asarray(a) for a in S0)), fixed=jnp.asarray(fixed),
        vertex_valid=jnp.ones(K, bool), e_i=jnp.asarray(e_i, jnp.int32),
        e_j=jnp.asarray(e_j, jnp.int32), e_Sji=jlie.Sim3(*(jnp.asarray(a) for a in Sm)),
        e_valid=jnp.ones(K, bool),
    )
    pt = tsg.PoseGraphProblem(
        S=_tsim(S0), fixed=torch.from_numpy(fixed), vertex_valid=torch.ones(K, dtype=torch.bool),
        e_i=torch.from_numpy(e_i), e_j=torch.from_numpy(e_j), e_Sji=_tsim(Sm),
        e_valid=torch.ones(K, dtype=torch.bool),
    )
    oj = jsg.optimize_essential_graph(pj, n_iters=20)
    ot = tsg.optimize_essential_graph(pt, n_iters=20)
    for a, b in zip(_j(oj), _t(ot)):
        np.testing.assert_allclose(b, a, atol=1e-4)
