"""Parity of the monocular two-view initializer: the port's
``initialize_two_view`` against the JAX package's on the planar and the
general pair of tests/test_initializer.py.

The port takes its RANSAC samples as an argument. Fed the samples JAX draws
(rebuilt here from ``jax.random.split`` / ``categorical`` as its
``_ransac_models`` does), both packages must agree: the same ``ok`` and
``used_H``, ``n_good`` within 2, R and t within 1e-4, and triangulated masks
differing in at most 1% of the pairs. The candidate motions are compared by
the one each package chooses, never by index: the null vectors of the SVDs
and ``eigh`` are defined up to sign, and the candidates' order follows those
signs. With its own draws (``two_view_draws``, a CPU ``torch.Generator``) the
port must meet tests/test_initializer.py's bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.solver.initializer import N_TRIALS, initialize_two_view as j_init
from pslam_tpu_torch.solver.initializer import initialize_two_view as t_init, two_view_draws
from test_initializer import CX, CY, FX, FY, _make_pair


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


def _jax_picks(key, valid):
    """The (N_TRIALS, 4) and (N_TRIALS, 8) sample indices JAX's
    ``initialize_two_view`` draws from ``key``."""
    kH, kF = jax.random.split(key)
    logits = jnp.where(valid, 0.0, -1e9)

    def picks(k, n):
        return np.asarray(jax.vmap(
            lambda kk: jax.random.categorical(kk, logits, shape=(n,))
        )(jax.random.split(k, N_TRIALS)))

    return picks(kH, 4), picks(kF, 8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(uv1, uv2, valid, h_idx, f_idx):
    res = t_init(_t(uv1), _t(uv2), _t(valid), _t(h_idx).long(), _t(f_idx).long(),
                 FX, FY, CX, CY)
    return type(res)(*(a.numpy() for a in res))


@pytest.mark.parametrize("planar", [False, True])
def test_fed_the_jax_draws(planar):
    uv1, uv2, valid, _, _, _ = _make_pair(planar)
    key = jax.random.PRNGKey(0)
    rj = jax.device_get(j_init(uv1, uv2, valid, key, FX, FY, CX, CY))
    rt = _port(uv1, uv2, valid, *_jax_picks(key, valid))
    differ = int((rt.triangulated != np.asarray(rj.triangulated)).sum())
    print(f"planar={planar}: n_good {int(rt.n_good)} vs JAX {int(rj.n_good)}; max |R| "
          f"difference {np.abs(rt.R21 - np.asarray(rj.R21)).max():.3e}, max |t| difference "
          f"{np.abs(rt.t21 - np.asarray(rj.t21)).max():.3e}; triangulated masks differ in "
          f"{differ} of {len(rt.triangulated)}")
    assert bool(rt.ok) == bool(rj.ok) is True
    assert bool(rt.used_H) == bool(rj.used_H) == planar
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 2, (int(rt.n_good), int(rj.n_good))
    np.testing.assert_allclose(rt.R21, np.asarray(rj.R21), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.t21, np.asarray(rj.t21), atol=1e-4, rtol=0)
    assert differ <= 0.01 * len(rt.triangulated), differ


@pytest.mark.parametrize("planar", [False, True])
def test_own_draws_meet_the_jax_bounds(planar):
    """tests/test_initializer.py::test_recovers_motion, through the port's
    own draws."""
    uv1, uv2, valid, R_gt, t_gt, X = _make_pair(planar)
    h_idx, f_idx = two_view_draws(0, _t(valid))
    res = _port(uv1, uv2, valid, h_idx.numpy(), f_idx.numpy())
    assert bool(res.ok), f"init failed (planar={planar}, n_good={int(res.n_good)})"
    assert bool(res.used_H) == planar
    cos_r = (np.trace(R_gt.T @ res.R21) - 1) / 2
    rot_err = np.degrees(np.arccos(np.clip(cos_r, -1, 1)))
    t_dot = abs(float(t_gt / np.linalg.norm(t_gt) @ res.t21))
    print(f"planar={planar}, own draws: rotation error {rot_err:.4f} deg, translation "
          f"direction dot {t_dot:.6f}, n_good {int(res.n_good)}")
    assert rot_err < 1.0
    assert t_dot > 0.995
    g = res.triangulated
    assert g.sum() > 150
    X1, Xg = res.X1[g], X[g]
    s = np.median(Xg[:, 2] / np.maximum(X1[:, 2], 1e-9))
    assert np.median(np.linalg.norm(X1 * s - Xg, axis=1)) < 0.08


def test_draws_sample_the_valid_matches():
    valid = np.zeros(300, bool)
    valid[::3] = True
    h1, f1 = two_view_draws(7, _t(valid))
    h2, f2 = two_view_draws(7, _t(valid))
    assert h1.shape == (N_TRIALS, 4) and f1.shape == (N_TRIALS, 8)
    assert torch.equal(h1, h2) and torch.equal(f1, f2)
    assert valid[h1.numpy()].all() and valid[f1.numpy()].all()
    # Uniform among the valid entries: all 100 are drawn.
    assert len(np.unique(np.r_[h1.numpy().ravel(), f1.numpy().ravel()])) == 100
