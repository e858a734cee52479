"""Parity of kernel K2's plain version (``ops/fused_pose.pose_terms``) against
the JAX package's ``pose_terms_fused(..., interpret=True)`` on the inputs of
tests/test_pallas_pose.py, and of the port's ``pose_optimization`` against
the JAX one (CPU jnp path) on the same ``PoseObs``.

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
from pslam_tpu_torch.ops import fused_pose
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
