"""Parity of the Schur local bundle adjustment: the port's
``local_bundle_adjustment`` against the JAX package's on one numpy
``BAProblem`` carried across with ``interop``.

The port assembles the normal equations with scatters (``index_add_``), the
JAX package's scatter path. The JAX package defaults to a one-hot matmul
assembly (``PSLAM_BA_ONEHOT=1``) that rounds the scattered Hessian blocks to
bf16; the parity test selects its scatter path (``PSLAM_BA_ONEHOT=0``, with
fresh jit caches) so both run the same arithmetic. Bars: poses and points
within 1e-4, inlier classification equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam, se3_exp as j_se3_exp
from pslam_tpu.solver.local_ba import BAProblem as JBAProblem
from pslam_tpu.solver.local_ba import local_bundle_adjustment as j_lba
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment as t_lba

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=40.0,
              width=320, height=240)
N_FREE = 4


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


def _problem(seed=0, C=6, P=256, E=1024):
    rng = np.random.default_rng(seed)
    cam = CAM_KW
    xi = np.zeros((C, 6), np.float32)
    xi[:, 3] = np.linspace(-0.3, 0.3, C)
    xi[:, 1] = np.linspace(-0.05, 0.05, C)
    T_true = np.asarray(j_se3_exp(jnp.asarray(xi)))
    n_pts = P - 16
    X_true = rng.uniform([-1.5, -1.0, 2], [1.5, 1.0, 4], (n_pts, 3)).astype(np.float32)
    cam_idx, pt_idx, obs, spare = [], [], [], []
    for p in range(n_pts):
        # >= 3 views per point; only views beyond the third may be outliers,
        # so every point stays well constrained after the outlier gate.
        for k, c in enumerate(rng.choice(C, size=rng.integers(3, 6), replace=False)):
            spare.append(k >= 3)
            Xc = T_true[c, :3, :3] @ X_true[p] + T_true[c, :3, 3]
            u = cam["fx"] * Xc[0] / Xc[2] + cam["cx"]
            v = cam["fy"] * Xc[1] / Xc[2] + cam["cy"]
            ur = u - cam["bf"] / Xc[2]
            cam_idx.append(c)
            pt_idx.append(p)
            obs.append([u, v, ur])
    n_e = min(len(cam_idx), E)
    obs = np.asarray(obs[:n_e], np.float64)
    obs += rng.normal(0, 0.15, obs.shape)
    obs[rng.uniform(size=n_e) < 0.3, 2] = -1.0  # mono edges
    bad = np.asarray(spare[:n_e]) & (rng.uniform(size=n_e) < 0.3)
    obs[bad, :2] += rng.uniform(-25, 25, (bad.sum(), 2))

    def pad(a, n, fill=0):
        out = np.full((n,) + np.asarray(a).shape[1:], fill, np.asarray(a).dtype)
        out[: len(a)] = a
        return out

    # Free cameras and points start off the truth; cameras 4, 5 are fixed.
    dxi = np.r_[[rng.normal(0, [0.005] * 3 + [0.02] * 3) for _ in range(N_FREE)]]
    T0 = T_true.copy()
    T0[:N_FREE] = np.asarray(j_se3_exp(jnp.asarray(dxi.astype(np.float32)))) @ T_true[:N_FREE]
    X0 = X_true + rng.normal(0, 0.03, X_true.shape).astype(np.float32)
    return dict(
        T_cw=T0.astype(np.float32),
        free_slot=np.r_[np.arange(N_FREE), -np.ones(C - N_FREE)].astype(np.int32),
        X_w=pad(X0, P),
        point_valid=pad(np.ones(n_pts, bool), P),
        cam_idx=pad(np.asarray(cam_idx[:n_e], np.int32), E),
        pt_idx=pad(np.asarray(pt_idx[:n_e], np.int32), E),
        obs=pad(obs.astype(np.float32), E),
        inv_sigma2=pad(rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n_e).astype(np.float32), E, 1.0),
        edge_valid=pad(np.ones(n_e, bool), E),
    ), T_true, X_true


@pytest.fixture(scope="module")
def solved():
    prob_np, T_true, X_true = _problem()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        prob_j = JBAProblem(**{k: jnp.asarray(v) for k, v in prob_np.items()})
        out_j = jax.device_get(j_lba(JCam(**CAM_KW), prob_j, N_FREE))
    jax.clear_caches()
    prob_t = interop.ba_problem_from_numpy(JBAProblem(**prob_np), device="cpu")
    out_t = [o.numpy() for o in t_lba(TCam(**CAM_KW), prob_t, N_FREE)]
    return prob_np, T_true, X_true, out_j, out_t


def test_poses_and_points_match(solved):
    prob, T_true, X_true, out_j, out_t = solved
    T_j, X_j, in_j, chi2_j = out_j
    T_t, X_t, in_t, chi2_t = out_t
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-4)
    n = int(prob["point_valid"].sum())
    np.testing.assert_allclose(X_t[:n], X_j[:n], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(in_t, in_j)
    # Fixed cameras stay exactly where they were.
    np.testing.assert_array_equal(T_t[N_FREE:], prob["T_cw"][N_FREE:])


def test_solve_converges_and_gates_outliers(solved):
    prob, T_true, X_true, out_j, out_t = solved
    T_t, X_t, in_t, _ = out_t
    n = len(X_true)
    err0 = np.abs(prob["X_w"][:n] - X_true).mean()
    err1 = np.abs(X_t[:n] - X_true).mean()
    assert err1 < 0.5 * err0, (err0, err1)
    ev = prob["edge_valid"]
    assert 0.8 * ev.sum() < in_t[ev].sum() < ev.sum()  # the outliers go
