"""Parity of the line frontend: ``detect_lines``, ``line_descriptors``,
``fit_lines_3d``, ``build_lils``, the line matchers and ``make_frame_lines``
against the JAX package, on rendered 320x240 frames of the box scene and on
planted line sets that force ties.

Each module gets the JAX package's outputs of the stage before it, so its
tolerance is its own. Bars: identical ``valid`` / ``ok3d`` masks, LIL
``line_idx`` and match indices; 2D endpoints within 1e-3 px; descriptors
within 1e-5; 3D endpoints within 1e-4 m. Float results are compared on the
valid entries (padding rows hold arbitrary values in both packages).

Two bars are wider, for arithmetic reasons. The offset c of a line
equation is a difference of products of pixel coordinates (~1e5) in f32
divided by the length, so 1e-4 px of endpoint difference moves it by up to
~2e-3 px: c is held to 5e-3 px, (a, b) to 1e-5. End to end
(``make_frame_lines``), such endpoint differences occasionally round a
descriptor sample to the neighbouring pixel: descriptors are held to a
squared-L2 distance of 1e-4 per line there (measured 1.6e-5; the match gates
are 0.8 and 1.2), and to 1e-5 per element when both get the same segments.

The line tiles are 8 px at 320x240 (the default 16 px is for 640x480), so
the small frames carry enough lines and LILs; the default tile runs too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import arc_trajectory, render_sequence
from pslam_tpu.ops import fans as jfans
from pslam_tpu.ops import lbd as jlbd
from pslam_tpu.ops import line3d as jl3
from pslam_tpu.ops import line_match as jlm
from pslam_tpu.ops import lines as jlines
from pslam_tpu.pipeline.frame_ops import make_frame_lines as j_make_frame_lines
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops import fans as tfans
from pslam_tpu_torch.ops import lbd as tlbd
from pslam_tpu_torch.ops import line3d as tl3
from pslam_tpu_torch.ops import line_match as tlm
from pslam_tpu_torch.ops import lines as tlines
from pslam_tpu_torch.pipeline.frame_ops import make_frame_lines as t_make_frame_lines

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
JCAM, TCAM = JCam(**CAM_KW), TCam(**CAM_KW)
PX, DESC, M3D = 1e-3, 1e-5, 1e-4


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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def frames():
    poses = arc_trajectory(24)[:6:2]
    grays, depths, _ = render_sequence(JCAM, poses=poses, seed=0)
    return grays, depths, poses


def _j_lines(gray, tile):
    lf = jlines.detect_lines(jnp.asarray(gray), jlines.LineConfig(tile=tile))
    return {k: np.asarray(v) for k, v in lf._asdict().items()}


@pytest.mark.parametrize("tile", [8, 16])
def test_detect_lines_matches_jax(frames, tile):
    grays = frames[0]
    n_valid = 0
    for g in grays:
        ref = _j_lines(g, tile)
        got = tlines.detect_lines(_t(g), tlines.LineConfig(tile=tile))
        v = ref["valid"]
        np.testing.assert_array_equal(_np(got.valid), v)
        for f in ("sp", "ep", "length"):
            np.testing.assert_allclose(_np(getattr(got, f))[v], ref[f][v], rtol=0, atol=PX)
        _check_eq2d(_np(got.eq2d)[v], ref["eq2d"][v])
        np.testing.assert_allclose(_np(got.angle)[v], ref["angle"][v], rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(got.response)[v], ref["response"][v], rtol=1e-5)
        n_valid += int(v.sum())
    assert n_valid >= (100 if tile == 8 else 5)


def _check_eq2d(got, ref):
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=5e-3)


def test_image_gradients_match_jax(frames):
    g = frames[0][1]
    for a, b in zip(tlines.image_gradients(_t(g)), jlines.image_gradients(jnp.asarray(g))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_line_descriptors_match_jax(frames):
    for g in frames[0]:
        ref = _j_lines(g, 8)
        d_j = np.asarray(jlbd.line_descriptors(
            jnp.asarray(g), jnp.asarray(ref["sp"]), jnp.asarray(ref["ep"]),
            jnp.asarray(ref["valid"])))
        d_t = _np(tlbd.line_descriptors(_t(g), _t(ref["sp"]), _t(ref["ep"]),
                                        _t(ref["valid"])))
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=DESC)
        v = ref["valid"]
        assert np.allclose(np.linalg.norm(d_t[v], axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            _np(tlbd.line_dist_matrix(_t(d_j), _t(d_j))),
            np.asarray(jlbd.line_dist_matrix(jnp.asarray(d_j), jnp.asarray(d_j))),
            rtol=0, atol=1e-5)


def test_trial_pairs_identical():
    np.testing.assert_array_equal(tl3._PAIRS, jl3._PAIRS)


def _j_fit(depth, lines):
    out = jl3.fit_lines_3d(JCAM, jnp.asarray(depth), jnp.asarray(lines["sp"]),
                           jnp.asarray(lines["ep"]), jnp.asarray(lines["valid"]))
    return [np.asarray(o) for o in out]


def test_fit_lines_3d_matches_jax(frames):
    grays, depths, _ = frames
    n_ok = 0
    for g, d in zip(grays, depths):
        ref = _j_lines(g, 8)
        p3s_j, p3e_j, dir_j, ok_j = _j_fit(d, ref)
        p3s_t, p3e_t, dir_t, ok_t = (_np(o) for o in tl3.fit_lines_3d(
            TCAM, _t(d), _t(ref["sp"]), _t(ref["ep"]), _t(ref["valid"])))
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_allclose(p3s_t, p3s_j, rtol=0, atol=M3D)
        np.testing.assert_allclose(p3e_t, p3e_j, rtol=0, atol=M3D)
        np.testing.assert_allclose(dir_t, dir_j, rtol=0, atol=1e-4)
        n_ok += int(ok_j.sum())
    assert n_ok >= 100


def _planted_lines(n_pairs=6):
    """Horizontal/vertical segment grid with equal lengths (so fan scores
    tie) on one fronto-parallel plane at z = 2 m (so every LIL candidate has
    the same plane and the OldPlane dedup must keep the earliest)."""
    sp, ep = [], []
    for i in range(n_pairs):
        y = 40.0 + 30.0 * i
        x = 40.0 + 35.0 * i
        sp += [[x - 30.0, y], [x, y - 30.0]]
        ep += [[x + 30.0, y], [x, y + 30.0]]
    sp = np.asarray(sp, np.float32)
    ep = np.asarray(ep, np.float32)
    L = 16
    pad = L - len(sp)
    sp = np.r_[sp, np.zeros((pad, 2), np.float32)]
    ep = np.r_[ep, np.zeros((pad, 2), np.float32)]
    valid = np.r_[np.ones(2 * n_pairs, bool), np.zeros(pad, bool)]
    z = 2.0

    def back(p):
        return np.c_[(p[:, 0] - CAM_KW["cx"]) * z / CAM_KW["fx"],
                     (p[:, 1] - CAM_KW["cy"]) * z / CAM_KW["fy"],
                     np.full(len(p), z)].astype(np.float32)

    p3s, p3e = back(sp) * valid[:, None], back(ep) * valid[:, None]
    seg = p3e - p3s
    dir3d = (seg / np.maximum(np.linalg.norm(seg, axis=1, keepdims=True), 1e-9)).astype(np.float32)
    a = sp[:, 1] - ep[:, 1]
    b = ep[:, 0] - sp[:, 0]
    c = sp[:, 0] * ep[:, 1] - sp[:, 1] * ep[:, 0]
    nrm = np.maximum(np.hypot(a, b), 1e-9)
    eq2d = np.stack([a / nrm, b / nrm, c / nrm], -1).astype(np.float32)
    return dict(sp=sp, ep=ep, eq2d=eq2d, valid=valid, p3s=p3s, p3e=p3e,
                dir3d=dir3d, ok3d=valid.copy())


def _compare_lils(got, ref):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(_np(got.valid), v)
    np.testing.assert_array_equal(_np(got.line_idx), np.asarray(ref.line_idx))
    np.testing.assert_allclose(_np(got.cross2d)[v], np.asarray(ref.cross2d)[v],
                               rtol=0, atol=PX)
    for f in ("eq1", "eq2"):
        _check_eq2d(_np(getattr(got, f))[v], np.asarray(getattr(ref, f))[v])
    for f in ("cross3d", "plane", "p1s", "p1e", "p2s", "p2e"):
        np.testing.assert_allclose(_np(getattr(got, f))[v], np.asarray(getattr(ref, f))[v],
                                   rtol=0, atol=M3D)
    return int(v.sum())


def _lils_both(ls, n_lil=64):
    keys = ("sp", "ep", "eq2d", "valid", "p3s", "p3e", "dir3d", "ok3d")
    ref = jfans.build_lils(*(jnp.asarray(ls[k]) for k in keys), n_lil=n_lil,
                           width=CAM_KW["width"], height=CAM_KW["height"])
    got = tfans.build_lils(*(_t(ls[k]) for k in keys), n_lil=n_lil,
                           width=CAM_KW["width"], height=CAM_KW["height"])
    return got, ref


def test_build_lils_matches_jax(frames):
    grays, depths, _ = frames
    n_lil = 0
    for g, d in zip(grays, depths):
        ls = _j_lines(g, 8)
        ls["p3s"], ls["p3e"], ls["dir3d"], ls["ok3d"] = _j_fit(d, ls)
        n_lil += _compare_lils(*_lils_both(ls))
    assert n_lil >= 3


def test_build_lils_tie_order_matches_jax():
    """Equal summed lengths and one shared plane: the candidate order decides
    which single LIL survives the OldPlane dedup."""
    ls = _planted_lines()
    got, ref = _lils_both(ls, n_lil=8)
    assert _compare_lils(got, ref) >= 1


def test_mutual_nn_float_ties_match_jax():
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 6, (40, 30)).astype(np.float32) / 4.0  # many ties
    va, vb = rng.uniform(size=40) > 0.1, rng.uniform(size=30) > 0.1
    mask = rng.uniform(size=(40, 30)) > 0.3
    for ratio in (1.0, 0.85):
        ij, bj = jlm.mutual_nn_float(jnp.asarray(dist), jnp.asarray(va), jnp.asarray(vb),
                                     1.2, ratio, jnp.asarray(mask))
        it, bt = tlm.mutual_nn_float(_t(dist), _t(va), _t(vb), 1.2, ratio, _t(mask))
        np.testing.assert_array_equal(_np(it), np.asarray(ij))
        np.testing.assert_array_equal(_np(bt), np.asarray(bj))


def test_match_lines_match_jax(frames):
    """Frame 0's 3D lines, moved to the world and projected into frame 2,
    matched by projection against frame 2's lines; and frame-to-frame
    matching of the two frames' 2D lines."""
    grays, depths, poses = frames
    a, b = _j_lines(grays[0], 8), _j_lines(grays[2], 8)
    a["p3s"], a["p3e"], _, ok = _j_fit(depths[0], a)
    for ls, g in ((a, grays[0]), (b, grays[2])):
        ls["desc"] = np.asarray(jlbd.line_descriptors(
            jnp.asarray(g), jnp.asarray(ls["sp"]), jnp.asarray(ls["ep"]),
            jnp.asarray(ls["valid"])))
    T0, T2 = poses[0].astype(np.float64), poses[2].astype(np.float64)
    T20 = T2 @ np.linalg.inv(T0)

    def proj(X):
        Xc = X @ T20[:3, :3].T + T20[:3, 3]
        return np.stack([CAM_KW["fx"] * Xc[:, 0] / Xc[:, 2] + CAM_KW["cx"],
                         CAM_KW["fy"] * Xc[:, 1] / Xc[:, 2] + CAM_KW["cy"]], -1).astype(np.float32)

    psp, pep = proj(a["p3s"]), proj(a["p3e"])
    for radius in (8.0, 20.0):
        ij, dj = jlm.match_lines_projection(
            jnp.asarray(psp), jnp.asarray(pep), None, jnp.asarray(a["desc"]), jnp.asarray(ok),
            jnp.asarray(b["sp"]), jnp.asarray(b["ep"]), jnp.asarray(b["desc"]),
            jnp.asarray(b["valid"]), radius)
        it, dt = tlm.match_lines_projection(
            _t(psp), _t(pep), None, _t(a["desc"]), _t(ok), _t(b["sp"]), _t(b["ep"]),
            _t(b["desc"]), _t(b["valid"]), radius)
        np.testing.assert_array_equal(_np(it), np.asarray(ij))
        m = np.asarray(ij) >= 0
        np.testing.assert_allclose(_np(dt)[m], np.asarray(dj)[m], rtol=0, atol=1e-5)
    assert (np.asarray(ij) >= 0).sum() >= 10

    args = ("desc", "sp", "ep", "valid")
    fj, _ = jlm.match_lines_f2f(*(jnp.asarray(a[k]) for k in args),
                                *(jnp.asarray(b[k]) for k in args), 320.0, 240.0)
    ft, _ = tlm.match_lines_f2f(*(_t(a[k]) for k in args), *(_t(b[k]) for k in args),
                                320.0, 240.0)
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))
    assert (np.asarray(fj) >= 0).sum() >= 10

    p = np.random.default_rng(2).uniform(0, 320, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlm.point_to_segment_dist(_t(p)[:, None], _t(b["sp"])[None], _t(b["ep"])[None])),
        np.asarray(jlm.point_to_segment_dist(jnp.asarray(p)[:, None], jnp.asarray(b["sp"])[None],
                                             jnp.asarray(b["ep"])[None])),
        rtol=0, atol=1e-4)


def test_make_frame_lines_matches_jax(frames):
    grays, depths, _ = frames
    cfg_j, cfg_t = jlines.LineConfig(tile=8), tlines.LineConfig(tile=8)
    n_lil = 0
    for g, d in zip(grays, depths):
        ref = j_make_frame_lines(jnp.asarray(g), jnp.asarray(d), JCAM, cfg_j, 64)
        got = t_make_frame_lines(_t(g), _t(d), TCAM, cfg_t, 64)
        v = np.asarray(ref.valid)
        np.testing.assert_array_equal(_np(got.valid), v)
        np.testing.assert_array_equal(_np(got.ok3d), np.asarray(ref.ok3d))
        for f in ("sp", "ep", "length"):
            np.testing.assert_allclose(_np(getattr(got, f))[v], np.asarray(getattr(ref, f))[v],
                                       rtol=0, atol=PX)
        d2 = np.sum((_np(got.desc) - np.asarray(ref.desc)) ** 2, axis=1)
        assert d2.max() <= 1e-4, d2.max()
        for f in ("p3s", "p3e"):
            np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(ref, f)),
                                       rtol=0, atol=M3D)
        n_lil += _compare_lils(got.lil, ref.lil)
        carried = interop.frame_lines_from_numpy(ref, device="cpu")  # dtypes as the port's
        for f in got._fields:
            if f != "lil":
                assert getattr(carried, f).dtype == getattr(got, f).dtype, f
                np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                              np.asarray(getattr(ref, f)))
        for f in got.lil._fields:
            assert getattr(carried.lil, f).dtype == getattr(got.lil, f).dtype, f
    assert n_lil >= 3
