"""Parity of the frame frontend: synthetic rendering, constant tables,
pyramid, blur, bf16 FAST and ``make_frame`` against the JAX package.

JAX's ``lax.approx_max_k`` (the keypoint top-k) falls back on the CPU to an
unstable sort, so its order among equal bf16 FAST scores is
implementation-defined. The port takes ties lowest index first (the
``lax.top_k`` order). The exact-parity tests pin the JAX side to
``lax.top_k`` (same exact top-k, defined tie order), with fresh jit caches;
``test_unpinned_tie_order_deviation`` measures what the unpinned reference
does differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io import synthetic as jsyn
from pslam_tpu.ops import image as jimage
from pslam_tpu.ops import orb as jorb
from pslam_tpu.ops.fast import fast_score_dual as j_fast
from pslam_tpu.pipeline.frame_ops import make_frame as j_make_frame
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.io import synthetic as tsyn
from pslam_tpu_torch.ops import image as timage
from pslam_tpu_torch.ops import orb as torb
from pslam_tpu_torch.ops.fast import fast_score_dual as t_fast
from pslam_tpu_torch.pipeline.frame_ops import make_frame as t_make_frame

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
N_FEAT = 500


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


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.arc_trajectory(24)[:3]
    return jsyn.render_sequence(JCam(**CAM_KW), poses=poses, seed=0)


@pytest.fixture(scope="module")
def pinned_topk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        jax.clear_caches()
        yield
    jax.clear_caches()


def test_synthetic_frames_identical():
    cam_j, cam_t = JCam(**CAM_KW), TCam(**CAM_KW)
    poses = jsyn.arc_trajectory(10)[:2]
    gj, dj, pj = jsyn.render_sequence(cam_j, poses=poses, seed=3)
    gt, dt, pt = tsyn.render_sequence(cam_t, poses=poses, seed=3)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(tsyn.arc_trajectory(7), jsyn.arc_trajectory(7))


def test_constant_tables_identical():
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(torb.bin_sample_indices(), jorb._bin_sample_indices())
    Rj, Cj = jimage._pyramid_matrices(240, 320, 8, 1.2)
    Rt, Ct = timage.pyramid_matrices(240, 320, 8, 1.2)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(Ct, Cj)
    np.testing.assert_array_equal(
        timage._gaussian_kernel1d(7, 2.0), jimage._gaussian_kernel1d(7, 2.0)
    )
    assert torb.OrbConfig().level_quota == jorb.OrbConfig().level_quota


def test_pyramid_blur_fast_bit_exact(frames):
    """Pyramid, blur and the bf16 FAST pass agree bit for bit (exact)."""
    img = frames[0][1]
    sj, _, _ = jimage.build_pyramid(jnp.asarray(img))
    st, _ = timage.build_pyramid(torch.from_numpy(img))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    bj = jimage.gaussian_blur(sj)
    bt = timage.gaussian_blur(st)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    fj = j_fast(sj.astype(jnp.bfloat16), 20, 7)
    ft = t_fast(st.to(torch.bfloat16), 20, 7)
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_make_frame_parity(frames, pinned_topk):
    grays, depths, _ = frames
    orb_j, orb_t = jorb.OrbConfig(n_features=N_FEAT), torb.OrbConfig(n_features=N_FEAT)
    for i in (0, 1):
        fj = jax.device_get(j_make_frame(
            jnp.asarray(grays[i]), jnp.asarray(depths[i]), JCam(**CAM_KW), orb_j))
        ft = t_make_frame(torch.from_numpy(grays[i]), torch.from_numpy(depths[i]),
                          TCam(**CAM_KW), orb_t)
        # Keypoint selection: identical positions, octaves and validity.
        np.testing.assert_array_equal(ft.uv.numpy(), fj.uv)
        np.testing.assert_array_equal(ft.level.numpy(), fj.level)
        np.testing.assert_array_equal(ft.valid.numpy(), fj.valid)
        np.testing.assert_array_equal(ft.depth.numpy(), fj.depth)
        # ur / xyz_c: XLA:CPU contracts uv*scale - bf/z into an FMA, the port
        # rounds the product first: 1 f32 ulp at ~300 px (3e-5).
        np.testing.assert_allclose(ft.ur.numpy(), fj.ur, rtol=0, atol=1e-4)
        np.testing.assert_allclose(ft.xyz_c.numpy(), fj.xyz_c, rtol=0, atol=1e-5)
        # IC angle: the 1024-term moment sums run in another order (Eigen vs
        # ATen matmul): a few f32 ulps of the angle.
        np.testing.assert_allclose(ft.angle.numpy(), fj.angle, rtol=0, atol=1e-4)
        # Descriptors: bit-flip rate over valid keypoints < 0.5% (the bar of
        # tests/test_round5.py); measured 0 on these frames.
        v = fj.valid
        bits_j = np.unpackbits(fj.desc[v], axis=1)
        bits_t = np.unpackbits(ft.desc.numpy()[v], axis=1)
        flip = float((bits_j != bits_t).mean())
        assert flip < 0.005, f"descriptor bit-flip rate {flip:.4%}"
        assert v.sum() > 300


def test_unpinned_tie_order_deviation(frames):
    """Against JAX's own CPU top-k (unstable sort), the selected keypoint
    SETS still agree but for the ties at each level's cut-off: measured 4 of
    ~470 valid keypoints swapped on frame 1 (8 in the symmetric difference).
    Bound: symmetric difference <= 3% of valid keypoints."""
    jax.clear_caches()
    img, dep = frames[0][1], frames[1][1]
    fj = jax.device_get(j_make_frame(
        jnp.asarray(img), jnp.asarray(dep), JCam(**CAM_KW),
        jorb.OrbConfig(n_features=N_FEAT)))
    ft = t_make_frame(torch.from_numpy(img), torch.from_numpy(dep), TCam(**CAM_KW),
                      torb.OrbConfig(n_features=N_FEAT))

    def keyset(uv, level, valid):
        return {(float(u), float(w), int(lv)) for (u, w), lv, ok in zip(uv, level, valid) if ok}

    sj = keyset(fj.uv, fj.level, fj.valid)
    st = keyset(ft.uv.numpy(), ft.level.numpy(), ft.valid.numpy())
    assert len(sj ^ st) <= 0.03 * len(sj), len(sj ^ st)
