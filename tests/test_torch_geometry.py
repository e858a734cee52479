"""Parity: the port's SO3/SE3 and camera functions against the JAX package on
the same random inputs (cases follow tests/test_geometry.py). Tolerance atol
1e-5 (f32 arithmetic in both; the JAX package's own round-trip cases use
1e-5 to 2e-4, which this test keeps for the round trips it mirrors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu import geometry as jgeo
from pslam_tpu_torch import geometry as tgeo

ATOL = 1e-5


def rng(seed=0):
    return np.random.default_rng(seed)


def both(fn_name, *args):
    j = np.asarray(getattr(jgeo, fn_name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tgeo, fn_name)(*[torch.from_numpy(np.array(a)) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.0])
def test_so3_exp(scale):
    w = (rng(1).normal(size=(64, 3)) * scale).astype(np.float32)
    j, t = both("so3_exp", w)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_so3_log():
    w = rng(2).normal(size=(128, 3)).astype(np.float32)
    w = w / np.maximum(1.0, np.linalg.norm(w, axis=-1, keepdims=True) / 3.0)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    j, t = both("so3_log", R)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_so3_log_small_and_near_pi():
    w = np.array([[0.0, 0.0, 0.0], [1e-7, -2e-7, 1e-7]], np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    j, t = both("so3_log", R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    axes = rng(3).normal(size=(32, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    R = np.asarray(jgeo.so3_exp(jnp.asarray((axes * (np.pi - 1e-3)).astype(np.float32))))
    j, t = both("so3_log", R)
    # Near pi the axis sign may flip: compare the rotations they encode.
    np.testing.assert_allclose(
        tgeo.so3_exp(torch.from_numpy(t)).numpy(),
        np.asarray(jgeo.so3_exp(jnp.asarray(j))), atol=1e-3,
    )


def test_se3_exp_log_inverse():
    xi = (rng(4).normal(size=(64, 6)) * 0.8).astype(np.float32)
    j, t = both("se3_exp", xi)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j2, t2 = both("se3_log", j)
    # Round-trip tolerance of tests/test_geometry.py (the log's series
    # switch amplifies f32 rounding of the exp).
    np.testing.assert_allclose(t2, j2, atol=1e-4)
    j3, t3 = both("se3_inverse", j)
    np.testing.assert_allclose(t3, j3, atol=ATOL)


def test_transform_points_and_left_update():
    T = np.asarray(jgeo.se3_exp(jnp.asarray(rng(6).normal(size=(6,)).astype(np.float32))))
    X = rng(7).normal(size=(100, 3)).astype(np.float32)
    j, t = both("transform_points", T, X)
    np.testing.assert_allclose(t, j, atol=ATOL)
    Tb = np.broadcast_to(T, (100, 4, 4)).copy()
    j, t = both("transform_points", Tb, X)
    np.testing.assert_allclose(t, j, atol=ATOL)
    xi = np.array([0.1, 0.2, -0.1, 5.0, -3.0, 2.0], np.float32)
    T = tgeo.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(
        T[:3, :3], tgeo.so3_exp(torch.from_numpy(xi[:3])).numpy(), atol=1e-6
    )


CAM_KW = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)


def test_camera_project_backproject():
    jc, tc = jgeo.Camera(**CAM_KW), tgeo.Camera(**CAM_KW)
    uv = rng(13).uniform([0, 0], [640, 480], size=(50, 2)).astype(np.float32)
    z = rng(14).uniform(0.5, 5.0, size=(50,)).astype(np.float32)
    Xj = np.asarray(jgeo.backproject(jc, jnp.asarray(uv), jnp.asarray(z)))
    Xt = tgeo.backproject(tc, torch.from_numpy(uv), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=ATOL)
    pj = np.asarray(jgeo.project_stereo(jc, jnp.asarray(Xj)))
    pt = tgeo.project_stereo(tc, torch.from_numpy(Xj)).numpy()
    # Pixel coordinates of a few hundred: 1e-5 absolute is below f32 spacing.
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=ATOL)
    uvq = np.array([[0.0, 0.0], [639.5, 479.5], [-1.0, 10.0], [640.0, 10.0]], np.float32)
    mj = np.asarray(jgeo.in_image(jc, jnp.asarray(uvq)))
    mt = tgeo.in_image(tc, torch.from_numpy(uvq)).numpy()
    assert mt.tolist() == mj.tolist() == [True, True, False, False]


def test_camera_undistort():
    kw = dict(CAM_KW, k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)
    jc, tc = jgeo.Camera(**kw), tgeo.Camera(**kw)
    uv = rng(15).uniform([100, 100], [540, 380], size=(40, 2)).astype(np.float32)
    j = np.asarray(jgeo.undistort_points(jc, jnp.asarray(uv), iters=20))
    t = tgeo.undistort_points(tc, torch.from_numpy(uv), iters=20).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-4)
