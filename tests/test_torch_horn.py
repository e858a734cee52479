"""Horn alignment and the three RANSACs (Sim3, SE3 3D-3D, PnP 2D-3D): the
JAX package against the port on the same numpy inputs (CPU).

Each port RANSAC takes its hypotheses as an argument. The tests draw them
the JAX way (``jax.random.uniform(key, (T, N))`` priorities; ``pnp``'s split
+ categorical sample indices) and feed them to the port, so one hypothesis
set gives one answer in both packages. Bars: the same inlier mask,
``n_inliers`` exact, R and t within 1e-5 (R as a product, whatever sign the
eigen/SVD solvers give their vectors). The port's own draws (CPU
``torch.Generator``) are held to determinism and to what they sample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import se3_exp as j_se3_exp
from pslam_tpu.geometry.camera import Camera as JCam, project as j_project
from pslam_tpu.solver import horn as jh
from pslam_tpu.solver import pnp as jp
from pslam_tpu_torch.geometry.camera import Camera as TCam
from pslam_tpu_torch.solver import horn as th
from pslam_tpu_torch.solver import pnp as tp

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


def _T(xi):
    return np.array(j_se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _tt(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_align_matches_jax(fix_scale):
    rng = np.random.default_rng(6)
    P = rng.normal(0, 1, (32, 5, 3)).astype(np.float32)
    T = _T([0.1, -0.2, 0.3, 0.2, -0.1, 0.4])
    Q = (1.0 if fix_scale else 1.7) * (P @ T[:3, :3].T) + T[:3, 3]
    Q += rng.normal(0, 0.01, Q.shape).astype(np.float32)
    sj, Rj, tj = jh.horn_align(jnp.asarray(P), jnp.asarray(Q), fix_scale=fix_scale)
    st, Rt, tt = th.horn_align(_tt(P), _tt(Q), fix_scale=fix_scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def _sim3_case():
    """tests/test_place_recognition.py TestRansac.test_sim3_ransac."""
    rng = np.random.default_rng(10)
    N = 96
    X1 = rng.uniform([-2, -2, 2], [2, 2, 8], (N, 3)).astype(np.float32)
    T = _T([0.02, -0.05, 0.08, 0.4, 0.1, -0.2])
    X2 = 1.3 * (X1 @ T[:3, :3].T) + T[:3, 3]
    uv1 = np.asarray(j_project(JC, jnp.asarray(X1)))
    uv2 = np.asarray(j_project(JC, jnp.asarray(X2)))
    oi = rng.choice(N, 24, replace=False)
    X2[oi] += rng.uniform(0.5, 1.5, (24, 3)).astype(np.float32)
    valid = np.arange(N) < 90  # a padded tail, as the loop closer pads
    ones = np.ones(N, np.float32)
    return X1, X2.astype(np.float32), uv1, uv2, ones, ones, valid


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_fed_the_jax_draws(fix_scale):
    args = _sim3_case()
    key = jax.random.PRNGKey(977)
    rj = jh.sim3_ransac(JC, *(jnp.asarray(a) for a in args), key, fix_scale=fix_scale)
    prio = np.asarray(jax.random.uniform(key, (128, len(args[0]))))
    rt = th.sim3_ransac(TC, *(_tt(a) for a in args), _tt(prio), fix_scale=fix_scale)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 0
    np.testing.assert_allclose(float(rt.s12), float(rj.s12), atol=1e-5)
    np.testing.assert_allclose(rt.R12.numpy(), np.asarray(rj.R12), atol=1e-5)
    np.testing.assert_allclose(rt.t12.numpy(), np.asarray(rj.t12), atol=1e-5)


def _se3_case():
    """tests/test_place_recognition.py TestRansac.test_se3_ransac_with_outliers."""
    rng = np.random.default_rng(9)
    N = 128
    X_w = rng.uniform([-2, -2, 1], [2, 2, 6], (N, 3)).astype(np.float32)
    T = _T([0.05, -0.03, 0.1, 0.3, -0.2, 0.15])
    X_c = X_w @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.005, (N, 3)).astype(np.float32)
    out = rng.choice(N, 38, replace=False)
    X_c[out] += rng.uniform(0.5, 2.0, (38, 3)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return X_w, X_c.astype(np.float32), valid


def test_se3_ransac_3d3d_fed_the_jax_draws():
    X_w, X_c, valid = _se3_case()
    key = jax.random.PRNGKey(131)
    Tj, inj, nj = jh.se3_ransac_3d3d(jnp.asarray(X_w), jnp.asarray(X_c), jnp.asarray(valid), key)
    prio = np.asarray(jax.random.uniform(key, (256, len(X_w))))
    Tt, int_, nt = th.se3_ransac_3d3d(_tt(X_w), _tt(X_c), _tt(valid), _tt(prio))
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 0
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)


def test_pnp_ransac_fed_the_jax_draws():
    rng = np.random.default_rng(3)
    N = 120
    X_w = rng.uniform([-2, -2, 2], [2, 2, 7], (N, 3)).astype(np.float32)
    T = _T([0.03, 0.05, -0.02, 0.1, -0.2, 0.3])
    uv = np.asarray(j_project(JC, jnp.asarray(X_w @ T[:3, :3].T + T[:3, 3])))
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:20] += rng.uniform(20, 60, (20, 2)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.2
    key = jax.random.PRNGKey(7)
    Tj, inj, nj = jp.pnp_ransac_2d3d(JC, jnp.asarray(X_w), jnp.asarray(uv), jnp.asarray(valid),
                                     key, n_trials=64)
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(tp.N_SAMPLE,)))(
        jax.random.split(key, 64))
    Tt, int_, nt = tp.pnp_ransac_2d3d(TC, _tt(X_w), _tt(uv), _tt(valid), _tt(np.asarray(idx)))
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 60
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)


def test_the_ports_draws_are_deterministic_and_sample_valid_entries():
    a = th.ransac_priorities(1301, 256, 50, "cpu")
    assert torch.equal(a, th.ransac_priorities(1301, 256, 50, "cpu"))
    assert not torch.equal(a, th.ransac_priorities(1302, 256, 50, "cpu"))
    assert a.shape == (256, 50) and float(a.min()) >= 0.0 and float(a.max()) < 1.0

    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 18, 40]] = True
    idx = tp.pnp_sample_indices(tp.pnp_draws(131, 256, "cpu"), valid)
    assert set(idx.unique().tolist()) == {3, 17, 18, 40}
    assert torch.equal(idx, tp.pnp_sample_indices(tp.pnp_draws(131, 256, "cpu"), valid))
    none = tp.pnp_sample_indices(tp.pnp_draws(131, 256, "cpu"), torch.zeros(50, dtype=torch.bool))
    assert int(none.min()) >= 0 and int(none.max()) < 50
