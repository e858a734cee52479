"""The port's stage profilers (``utils/profile.py``, ``apps/profile_frame.py``,
``apps/profile_backend.py``, ``apps/roofline.py``) against the JAX
package's scripts, on the CPU.

- Inputs: each app's builders give the scripts' synthetic inputs: the
  4096-point ``PointSet`` (here 1024 from a 320x240 frame), the two random
  ``BAProblem``s (16384 edges; 2048 points / 8192 edges), the two
  ``KFView``s with the gather's index and values, the LIL problem and the
  128-keyframe graph. The scripts keep their builders inside ``main()``, so
  this module restates their lines with ``pslam_tpu`` calls on the same
  ``default_rng`` seeds. Every array is exactly equal but the cameras'
  ``T_cw`` and what is projected through them: ``se3_exp``'s sine and
  cosine round differently in the two frameworks (up to 1.7e-6 on 10 of
  768 entries), which moves the noisy observations by up to 1.6e-6
  relative (4.4e-3 px), 6.7e-4 px where a coordinate nears 0.
  Given the same ``T_cw``, the port's observation model gives JAX's
  observations bit for bit.
- Stages no other test covers, through both packages on the same numpy
  inputs (JAX's, carried across): the bare gather and the Hamming
  mutual-NN on 1000x1000 (exact), ``epipolar_triangulate`` on the random
  views (no pair passes its gates in either package: the views' descriptors
  are random), and the local BA's edge terms, assembly, Schur solve and
  whole solve on the 2048 / 8192 problem.
- The assembly bound (the rule for the JAX package's default BA): on the
  same per-edge terms the port's ``_assemble`` meets JAX's scatter path
  (``PSLAM_BA_ONEHOT=0``) within f32 (relative 1e-6 on every block), and
  JAX's default one-hot path (``PSLAM_BA_ONEHOT=1``), which rounds the
  point-block terms to bf16, within the bound that rounding gives: each
  element within (2^-8 + 2 K 2^-24) of the sum of the |terms| that reach it,
  2^-8 the unit roundoff of bf16's 8-bit significand and 2 K 2^-24 the f32
  sums of both paths over at most K terms an element. The same for the
  joint point + LIL assembly of ``ba_lil``. ``PSLAM_BA_ONEHOT`` is read when
  ``_assemble`` runs, so each case calls it afresh.
- The counts: every operation formula against a hand count at a small
  shape, ``tensor_bytes``, and ``bound``'s sides and its 1.05 check.
- No fallback: without CUDA each app's ``run()`` and ``time_stage`` raise
  before measuring; with ``device="cpu"`` the rows have host ms and every
  device field ``None``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.geometry import project_stereo as j_project_stereo
from pslam_tpu.geometry import se3_exp as j_se3_exp
from pslam_tpu.geometry import transform_points as j_transform_points
from pslam_tpu.geometry.lie import Sim3 as JSim3
from pslam_tpu.io.synthetic import render_sequence
from pslam_tpu.ops.match import hamming_matrix as j_hamming, mutual_nn_match as j_mnn
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.ops.triangulate import KFView as JKFView, epipolar_triangulate as j_tri
from pslam_tpu.pipeline.frame_ops import make_frame as j_make_frame
from pslam_tpu.pipeline.track_ops import PointSet as JPointSet
from pslam_tpu.solver import ba_lil as j_ba_lil
from pslam_tpu.solver import local_ba as j_lba
from pslam_tpu.solver.sim3_graph import PoseGraphProblem as JGraph
from pslam_tpu.utils.config import SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.apps import profile_backend, profile_frame, roofline
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.match import hamming_matrix as t_hamming, mutual_nn_match as t_mnn
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.ops.triangulate import KFView as TKFView, epipolar_triangulate as t_tri
from pslam_tpu_torch.solver import local_ba as t_lba
from pslam_tpu_torch.solver.local_ba import ONE_DEVICE, assembly_plan
from pslam_tpu_torch.utils import profile as P
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
TINY_CAM = dict(fx=129.3, fy=129.1, cx=79.6, cy=63.8, bf=10.0, width=160, height=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return type(tree)(*[np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                        for x in tree])


def _assert_same(jt, tt, close=()):
    """Two NamedTuples of one type's fields exactly equal, dtypes aside for
    the indices (int32 in JAX, int64 in the port); the fields in ``close``
    (name -> (rtol, atol)) within it."""
    close = dict(close)
    for name, a, b in zip(jt._fields, _np(jt), _np(tt)):
        if a.dtype.kind in "iu" and b.dtype.kind in "iu":
            b = b.astype(a.dtype)
        if name in close:
            np.testing.assert_allclose(b, a, *close[name], err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


SE3_TOL = (0, 2e-6)  # se3_exp's rounding (1.7e-6 measured)
# The pixels projected through it: 4.4e-3 px at 1.6e-6 relative, 6.7e-4 px
# where a coordinate is near 0 (measured).
OBS_TOL = (1e-5, 1e-3)


# The scripts' builders, restated with pslam_tpu calls


def _jax_point_set(fd, M):
    """scripts/profile_frame.py:124-146."""
    has = np.asarray((fd.depth > 0) & fd.valid)
    sel = np.flatnonzero(has)[:M]
    pos = np.zeros((M, 3), np.float32)
    pos[: len(sel)] = np.asarray(fd.xyz_c)[sel]
    desc = np.zeros((M, 32), np.uint8)
    desc[: len(sel)] = np.asarray(fd.desc)[sel]
    dist = np.linalg.norm(pos, axis=-1)
    return JPointSet(
        pos=jnp.asarray(pos), desc=jnp.asarray(desc), level=jnp.zeros(M, jnp.int32),
        angle=jnp.zeros(M, jnp.float32),
        min_dist=jnp.asarray((dist * 0.2).astype(np.float32)),
        max_dist=jnp.asarray((dist * 5.0 + 1.0).astype(np.float32)),
        normal=jnp.asarray(pos / np.maximum(dist[:, None], 1e-9).astype(np.float32)),
        valid=jnp.asarray(np.arange(M) < len(sel)))


def _jax_ba_problem(cfg, rng, P_, E):
    """scripts/profile_backend.py:65-92 (bench_sharded.py:72-90 with 2048 /
    8192)."""
    cam, caps = cfg.camera, cfg.caps
    C, n_free = caps.ba_cams, caps.ba_free
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (P_, 3)).astype(np.float32)
    T_cw = np.stack([np.asarray(j_se3_exp(jnp.asarray(
        np.r_[rng.normal(0, 0.01, 3), 0.05 * c, 0, 0].astype(np.float32)))) for c in range(C)])
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, P_, E).astype(np.int32)
    Xc = j_transform_points(jnp.asarray(T_cw)[cam_idx], jnp.asarray(X)[pt_idx])
    obs = np.asarray(j_project_stereo(cam, Xc)) + rng.normal(0, 0.3, (E, 3)).astype(np.float32)
    free_slot = np.full(C, -1, np.int32)
    free_slot[1: 1 + n_free] = np.arange(n_free)
    prob = j_lba.BAProblem(
        T_cw=jnp.asarray(T_cw.astype(np.float32)), free_slot=jnp.asarray(free_slot),
        X_w=jnp.asarray(X + rng.normal(0, 0.02, X.shape).astype(np.float32)),
        point_valid=jnp.ones(P_, bool), cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx), obs=jnp.asarray(obs.astype(np.float32)),
        inv_sigma2=jnp.ones(E, jnp.float32), edge_valid=jnp.ones(E, bool))
    return prob, obs, T_cw


def _jax_views(cfg, rng, obs, T_cw):
    """scripts/profile_backend.py:132-154."""
    N, E = cfg.orb.capacity, obs.shape[0]

    def mk_view(c):
        return JKFView(
            T_cw=jnp.asarray(T_cw[c].astype(np.float32)),
            uv=jnp.asarray(obs[rng.integers(0, E, N), :2].astype(np.float32)),
            ur=jnp.asarray(np.full(N, -1, np.float32)),
            depth=jnp.asarray(rng.uniform(1, 5, N).astype(np.float32)),
            level=jnp.zeros(N, jnp.int32), angle=jnp.zeros(N, jnp.float32),
            desc=jnp.asarray(rng.integers(0, 256, (N, 32), dtype=np.uint8)),
            free=jnp.ones(N, bool))

    v1, v2 = mk_view(0), mk_view(1)
    j = jnp.asarray(rng.integers(0, N, N).astype(np.int32))
    vals = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    return v1, v2, j, vals


def _jax_lil(cfg, rng, Q=64):
    """scripts/bench_sharded.py:121-132."""
    C, El = cfg.caps.ba_cams, cfg.caps.ba_lil_edges
    lil_state = jnp.asarray(np.concatenate(
        [rng.uniform([-3, -2, 1], [3, 2, 8], (Q, 3)).astype(np.float32)] * 5, axis=1))
    ledges = j_ba_lil.LILBAEdges(
        cam_idx=jnp.asarray(rng.integers(0, C, El).astype(np.int32)),
        lil_idx=jnp.asarray(rng.integers(0, Q, El).astype(np.int32)),
        obs=jnp.asarray(rng.normal(0, 1, (El, 8)).astype(np.float32)),
        valid=jnp.ones(El, bool))
    return lil_state, jnp.ones(Q, bool), ledges


def _jax_graph(rng, K=128, Eg=256):
    """scripts/bench_sharded.py:145-167."""
    angles = 2 * np.pi * np.arange(K) / K
    Rk = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    tk = np.stack([np.cos(angles), np.zeros(K), np.sin(angles)], -1).astype(np.float32)
    tk += rng.normal(0, 0.02, tk.shape).astype(np.float32)
    e_i = np.r_[np.arange(K - 1), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.r_[np.arange(1, K), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.where(e_j == e_i, (e_j + 1) % K, e_j).astype(np.int32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return JGraph(
        S=JSim3(s=jnp.ones(K, jnp.float32), R=jnp.asarray(Rk), t=jnp.asarray(tk)),
        fixed=jnp.asarray(fixed), vertex_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_Sji=JSim3(s=jnp.ones(Eg, jnp.float32),
                    R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (Eg, 1, 1)),
                    t=jnp.zeros((Eg, 3), jnp.float32)),
        e_valid=jnp.ones(Eg, bool))


# Inputs


def test_point_set_matches_profile_frame_script():
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500))
    grays, depths, _ = render_sequence(jc.camera, n_frames=1, seed=0)
    fd = _np(j_make_frame(jnp.asarray(grays[0]), jnp.asarray(depths[0]), jc.camera, jc.orb))
    M = 1024
    jp = _jax_point_set(fd, M)
    assert int(np.asarray(jp.valid).sum()) > 300
    _assert_same(jp, profile_frame.point_set_from_frame(fd, M, "cpu"))


@pytest.fixture(scope="module")
def backend_inputs():
    """Both packages' inputs of scripts/profile_backend.py (full size) and
    scripts/bench_sharded.py."""
    jc, tc = JCfg(), TCfg()
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    jprob, jobs, jT = _jax_ba_problem(jc, rj, jc.caps.ba_points, jc.caps.ba_edges)
    tprob, tobs, tT = profile_backend.random_ba_problem(tc, rt, tc.caps.ba_points,
                                                        tc.caps.ba_edges, "cpu")
    jviews = _jax_views(jc, rj, jobs, jT)
    tviews = profile_backend.random_views(tc, rt, tobs, tT, "cpu")
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    jsh = (_jax_ba_problem(jc, rj, 2048, 8192)[0], *_jax_lil(jc, rj), _jax_graph(rj))
    tsh = (profile_backend.random_ba_problem(tc, rt, 2048, 8192, "cpu")[0],
           *profile_backend.random_lil_problem(tc, rt, "cpu"),
           profile_backend.random_pose_graph(rt, "cpu"))
    same = interop.ba_problem_from_numpy(_np(jsh[0]), device="cpu")
    jv = jviews[:2]
    views = [TKFView(**{f: torch.from_numpy(np.array(getattr(v, f))) for f in v._fields})
             for v in jv]
    return dict(jprob=jprob, tprob=tprob, jviews=jviews, tviews=tviews, jsh=jsh, tsh=tsh,
                obs=(jobs, tobs), jT=jT, same=same, same_views=views)


def test_profile_backend_inputs_match_script(backend_inputs):
    b = backend_inputs
    assert b["tprob"].cam_idx.shape[0] == 16384
    _assert_same(b["jprob"], b["tprob"], close={"T_cw": SE3_TOL, "obs": OBS_TOL})
    np.testing.assert_allclose(b["obs"][1], b["obs"][0], *OBS_TOL)
    for jv, tv in zip(b["jviews"][:2], b["tviews"][:2]):
        _assert_same(jv, tv, close={"T_cw": SE3_TOL, "uv": OBS_TOL})
    for ja, ta in zip(b["jviews"][2:], b["tviews"][2:]):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_observation_model_is_jax_bit_for_bit(backend_inputs):
    """Given JAX's cameras, the builder's observation model reproduces the
    script's noise-free observations exactly."""
    jprob, jT = backend_inputs["jprob"], backend_inputs["jT"]
    cam_idx, pt_idx = np.asarray(jprob.cam_idx), np.asarray(jprob.pt_idx)
    rng = np.random.default_rng(0)
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (JCfg().caps.ba_points, 3)).astype(np.float32)
    ref = np.asarray(j_project_stereo(JCfg().camera, j_transform_points(
        jnp.asarray(jT)[cam_idx], jnp.asarray(X)[pt_idx])))
    np.testing.assert_array_equal(
        profile_backend._observe(TCfg().camera, jT[cam_idx], X[pt_idx]), ref)


def test_bench_sharded_inputs_match_script(backend_inputs):
    jprob, jstate, jvalid, jedges, jgraph = backend_inputs["jsh"]
    tprob, tstate, tvalid, tedges, tgraph = backend_inputs["tsh"]
    assert tprob.X_w.shape[0] == 2048 and tprob.cam_idx.shape[0] == 8192
    _assert_same(jprob, tprob, close={"T_cw": SE3_TOL, "obs": OBS_TOL})
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    _assert_same(jedges, tedges)
    assert tgraph.fixed.shape[0] == 128 and tgraph.e_i.shape[0] == 256
    for f in ("fixed", "vertex_valid", "e_i", "e_j", "e_valid"):
        np.testing.assert_array_equal(getattr(tgraph, f).numpy(),
                                      np.asarray(getattr(jgraph, f)), err_msg=f)
    for f in ("S", "e_Sji"):
        _assert_same(getattr(jgraph, f), getattr(tgraph, f))


# Stages no other test covers


def test_gather_and_hamming_mutual_nn_exact(backend_inputs):
    jv1, jv2, jj, jvals = backend_inputs["jviews"]
    _, _, tj, tvals = backend_inputs["tviews"]
    tv1, tv2 = backend_inputs["same_views"]
    assert tv1.desc.shape[0] == 1000
    np.testing.assert_array_equal(tvals[tj].numpy(), np.asarray(jvals[jj]))
    got = t_mnn(t_hamming(tv1.desc, tv2.desc), valid_a=tv1.free, valid_b=tv2.free,
                max_dist=50, ratio=1.0)
    ref = j_mnn(j_hamming(jv1.desc, jv2.desc), valid_a=jv1.free, valid_b=jv2.free,
                max_dist=50, ratio=1.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_epipolar_triangulate_on_the_random_views(backend_inputs):
    """The same matches and gates (none pass on these random views); points
    within 1e-4 relative where they do."""
    jv1, jv2 = backend_inputs["jviews"][:2]
    tv1, tv2 = backend_inputs["same_views"]
    cam_j, cam_t = JCfg().camera, TCfg().camera
    idx_j, X_j, ok_j = (np.asarray(x) for x in j_tri(cam_j, jv1, jv2, 1.2, 8))
    idx_t, X_t, ok_t = (x.numpy() for x in t_tri(cam_t, tv1, tv2, 1.2, 8))
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(X_t[ok_t], X_j[ok_j], rtol=1e-4, atol=1e-5)


def _bf16_bound(terms_abs, counts):
    """Per element: (2^-8 + 2 K 2^-24) x the sum of |terms| reaching it."""
    return (2.0**-8 + 2 * counts.max() * 2.0**-24) * terms_abs


def _abs_sums(idx, vals, n):
    """Sums of |vals| (E, ...) into n targets, in float64, and the largest
    number of terms a target receives."""
    out = np.zeros((n,) + vals.shape[1:])
    np.add.at(out, idx, np.abs(vals.astype(np.float64)))
    return out, np.bincount(idx, minlength=n)


def _point_term_sums(prob, n_free, w, r, Jc, Jp):
    """|term| sums of every block _assemble builds, and the term counts."""
    slot = np.asarray(prob.free_slot)[np.asarray(prob.cam_idx)]
    pt = np.asarray(prob.pt_idx)
    ww = w[:, None, None]
    Hcc_e = np.einsum("eij,eik->ejk", Jc, Jc) * ww
    Hpp_e = np.einsum("eij,eik->ejk", Jp, Jp) * ww
    Hcp_e = np.einsum("eij,eik->ejk", Jc, Jp) * ww
    bc_e = -np.einsum("eij,ei->ej", Jc, r) * w[:, None]
    bp_e = -np.einsum("eij,ei->ej", Jp, r) * w[:, None]
    free = slot >= 0
    P_ = np.asarray(prob.X_w).shape[0]
    Hcc, kc = _abs_sums(slot[free], Hcc_e[free], n_free)
    bc, _ = _abs_sums(slot[free], bc_e[free], n_free)
    Hpp, kp = _abs_sums(pt, Hpp_e, P_)
    bp, _ = _abs_sums(pt, bp_e, P_)
    G, kg = _abs_sums(pt[free] * n_free + slot[free], Hcp_e[free], P_ * n_free)
    sums = (Hcc, bc, Hpp, bp, G.reshape(P_, n_free, 6, 3))
    return sums, (kc, kc, kp, kp, kg)


NAMES = ("Hcc", "bc", "Hpp", "bp", "G")


def _jax_assemble(prob, n_free, terms, onehot, mp):
    mp.setenv("PSLAM_BA_ONEHOT", "1" if onehot else "0")
    return [np.asarray(x) for x in j_lba._assemble(prob, n_free, *map(jnp.asarray, terms))]


@pytest.fixture(scope="module")
def point_terms(backend_inputs):
    """JAX's per-edge terms of the 2048-point / 8192-edge problem at its
    start, in numpy, and the port's assembly of them."""
    jprob, tprob = backend_inputs["jsh"][0], backend_inputs["same"]
    n_free = TCfg().caps.ba_free
    _, w, r, Jc, Jp, _ = j_lba._edge_terms(JCfg().camera, jprob, jprob.T_cw, jprob.X_w,
                                           jprob.edge_valid, True)
    terms = [np.asarray(x) for x in (w, r, Jc, Jp)]
    plan = t_lba._problem_plan(tprob, n_free)
    port = [x.numpy() for x in t_lba._assemble(plan, n_free, *map(torch.from_numpy, terms))]
    return jprob, tprob, n_free, terms, port


def test_edge_terms_match_jax(backend_inputs):
    """Residuals within 4 f32 ulps of the ~1000 px projections they
    subtract (2 measured), chi2 within what that moves it, the Huber
    weights within 1e-4 relative (4.8e-5 measured), the Jacobians within
    1e-6 of their largest entry, the cost within 1e-6."""
    jprob, tprob = backend_inputs["jsh"][0], backend_inputs["same"]
    ref = [np.asarray(x) for x in j_lba._edge_terms(JCfg().camera, jprob, jprob.T_cw,
                                                      jprob.X_w, jprob.edge_valid, True)]
    got = [x.numpy() for x in t_lba._edge_terms(TCfg().camera, tprob, tprob.T_cw, tprob.X_w,
                                                 tprob.edge_valid, True)]
    dr = 4 * float(np.spacing(np.float32(1024)))
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=dr)
    chi2_tol = 2 * np.abs(ref[2]).sum(-1) * dr + 3 * dr * dr + 1e-6 * ref[0]
    assert (np.abs(got[0] - ref[0]) <= chi2_tol).all()
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
    for g, r in zip(got[3:5], ref[3:5]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max())
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-6)


def test_assemble_matches_jax_scatter_within_f32(point_terms):
    jprob, _, n_free, terms, port = point_terms
    with pytest.MonkeyPatch.context() as mp:
        ref = _jax_assemble(jprob, n_free, terms, False, mp)
    for name, g, r in zip(NAMES, port, ref):
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), name


def test_assemble_within_bf16_bound_of_jax_default(point_terms):
    jprob, _, n_free, terms, port = point_terms
    with pytest.MonkeyPatch.context() as mp:
        ref = _jax_assemble(jprob, n_free, terms, True, mp)
        scatter = _jax_assemble(jprob, n_free, terms, False, mp)
    sums, counts = _point_term_sums(jprob, n_free, *terms)
    assert any(not np.array_equal(a, b) for a, b in zip(ref[2:], scatter[2:]))  # bf16 bites
    for name, g, r, s, k in zip(NAMES, port, ref, sums, counts):
        assert (np.abs(g.astype(np.float64) - r) <= _bf16_bound(s, k)).all(), name


def test_lil_assemble_against_both_jax_paths(backend_inputs, point_terms):
    """ba_lil's normal equations: the point blocks by ``_assemble``, the LIL
    blocks by the scatter of ``_assemble_lil``, joined as its normal_eqs
    joins them."""
    jprob, tprob, n_free, terms, port = point_terms
    _, jstate, _, jedges, _ = backend_inputs["jsh"]
    _, _, _, tedges, _ = backend_inputs["tsh"]
    cam = JCfg().camera
    _, wl, rl, Jcl, Jll, _, _ = j_ba_lil._lil_edge_terms(cam, jprob.T_cw, jstate, jedges,
                                                         jedges.valid, True)
    lterms = [np.asarray(x) for x in (wl, rl, Jcl, Jll)]
    Q = jstate.shape[0]
    plan_l = assembly_plan(tprob.free_slot, tedges.cam_idx, tedges.lil_idx, tedges.valid,
                           n_free, Q)
    port_l = [x.numpy() for x in t_lba._assemble(plan_l, n_free, *map(torch.from_numpy, lterms))]
    jl = [np.asarray(x) for x in j_ba_lil._assemble_lil(
        jedges, n_free, Q, jprob.free_slot, *map(jnp.asarray, lterms))]

    def joint(p, l):
        return [p[0] + l[0], p[1] + l[1], *(np.concatenate([a, b]) for a, b in zip(p[2:], l[2:]))]

    got = joint(port, port_l)
    lprob = jprob._replace(free_slot=jprob.free_slot, cam_idx=jedges.cam_idx,
                           pt_idx=jedges.lil_idx, X_w=jnp.zeros((Q, 3)))
    sums_p, k_p = _point_term_sums(jprob, n_free, *terms)
    sums_l, k_l = _point_term_sums(lprob, n_free, *lterms)
    sums = joint(sums_p, sums_l)
    counts = [np.r_[a, b] if i >= 2 else a + b for i, (a, b) in enumerate(zip(k_p, k_l))]
    with pytest.MonkeyPatch.context() as mp:
        for onehot in (False, True):
            ref = joint(_jax_assemble(jprob, n_free, terms, onehot, mp), jl)
            for name, g, r, s, k in zip(NAMES, got, ref, sums, counts):
                if onehot:
                    assert (np.abs(g.astype(np.float64) - r) <= _bf16_bound(s, k)).all(), name
                else:
                    assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), name


def test_solve_schur_matches_jax(point_terms):
    """One damped Schur step on the same blocks: dx within 2e-3 of its
    largest entry (9.5e-4 measured): the two frameworks' f32 LU solves of
    the 96 x 96 reduced system, after 2048 3x3 inverses, round apart."""
    jprob, tprob, n_free, _, port = point_terms
    lam = 1e-4
    ref = j_lba._solve_schur(*map(jnp.asarray, port), jprob.point_valid, jnp.float32(lam))
    got = t_lba._schur_step(ONE_DEVICE, tuple(map(torch.from_numpy, port)), tprob.point_valid,
                            torch.tensor(lam))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 2e-3 * np.abs(r).max()


def test_full_ba_matches_jax_scatter(backend_inputs):
    """``full BA (5+10 LM)`` on the 2048 / 8192 problem, JAX on its scatter
    path with fresh jit caches: poses within 1e-4, points within 1e-4 + 1e-4
    relative (3.95e-4 on a 7.2 m coordinate measured), the inlier
    classification equal but for edges at the gate."""
    jprob, tprob = backend_inputs["jsh"][0], backend_inputs["same"]
    n_free = TCfg().caps.ba_free
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        ref = [np.asarray(x) for x in j_lba.local_bundle_adjustment(JCfg().camera, jprob, n_free)]
    jax.clear_caches()
    got = [x.numpy() for x in t_lba.local_bundle_adjustment(TCfg().camera, tprob, n_free)]
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-4)
    flips = got[2] != ref[2]
    assert flips.sum() <= 2, np.flatnonzero(flips)
    gate = np.where(np.asarray(jprob.obs)[:, 2] >= 0, 7.815, 5.991)
    np.testing.assert_allclose(got[3][flips], gate[flips], rtol=1e-3)


# Counting


def test_operation_formulas_equal_hand_counts():
    assert P.pyramid_ops(12, 10, 2, 2.0) == 4 * (6 * 10 + 6 * 5)
    assert P.FAST_DUAL_PIXEL_OPS == 195 and P.FAST_PIXEL_OPS == 138
    assert P.BLUR_PIXEL_OPS == 28 and P.BRIEF_KEYPOINT_OPS == 260
    assert P.angle_ops(2, 4) == 2 * (16 + 16 + 16 + 16 + 1)
    assert P.track_ops(3, 4, 5) == 9 * 12 + 49 * 280 * 5
    assert P.BA_ASSEMBLE_EDGE_OPS == 54 * 6 + 54 * 2
    k = torch.tensor([1, 2])
    assert P.schur_landmark_ops(k) == (39 + 108 + 216 + 36) + (39 + 216 + 864 + 72)
    assert P.schur_camera_ops(1) == 12 + 144 + 72
    assert P.back_substitute_ops(k) == (36 + 21) + (72 + 21)
    step = 1590 + 228 + 150
    assert P.ba_ops(2, k, 1, schedule=(1, 1)) == (
        4 * 2 * (P.BA_TERM_EDGE_OPS + P.BA_ASSEMBLE_EDGE_OPS) + 2 * step + 2 * 2 * 110)
    cpp = P.cams_per_point(torch.tensor([-1, 0, 1]), torch.tensor([0, 1, 2, 1, 2, 2]),
                           torch.tensor([0, 0, 0, 1, 1, 1]), torch.ones(6, dtype=torch.bool), 3)
    assert cpp.tolist() == [2, 2, 0]


def test_bytes_and_bound():
    tree = (torch.zeros(3), {"a": torch.zeros((2, 2), dtype=torch.uint8),
                             "b": [np.zeros(2), 7]})
    assert P.tensor_bytes(tree) == 12 + 4 + 16
    row = P.time_stage(lambda x: x * 2, torch.zeros(10), reps=2, device="cpu")
    assert row["nbytes"] == 80
    b = P.bound(67e9, 3.35e6, ms=10.0)  # 1 ms of operations, 1 us of bytes
    assert b["bound_by"] == "operations" and b["floor_ms"] == pytest.approx(1.0)
    assert b["share"] == pytest.approx(0.1)
    b = P.bound(67e3, 3.35e9)
    assert b["bound_by"] == "bytes" and b["floor_ms"] == pytest.approx(1.0)
    assert b["share"] is None
    b = P.bound(None, 3.35e9, ms=2.0)
    assert b["ops"] == "not counted" and b["bound_by"].startswith("bytes")
    with pytest.raises(ValueError):
        P.bound(67e9, 0, ms=0.9)


# No fallback


@pytest.mark.parametrize("app", [profile_frame, profile_backend, roofline])
def test_apps_raise_without_cuda(app, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        app.run()
    with pytest.raises(RuntimeError):
        P.time_stage(lambda: None)


def _tiny_cfg():
    return TCfg(camera=TCam(**TINY_CAM), orb=TOrb(n_features=200),
                caps=TCaps(local_points=256, ba_points=128, ba_edges=512, ba_lil_edges=64),
                use_lines=False, use_bow=False, use_loop_closing=False)


def _device_fields_none(rows):
    assert rows
    for r in rows:
        assert r["device"] == "cpu" and r["host_ms"] > 0
        for k in ("event_ms", "device_ms", "launches", "busy", "k1", "k2", "peak_mib", "share"):
            assert r[k] is None, (r["name"], k)
        assert r["floor_ms"] >= 0


def test_apps_on_the_cpu_give_host_rows_only():
    cfg = _tiny_cfg()
    rows = profile_frame.run("cpu", cfg=cfg, reps=1, n_warm=2, n_scan=1)
    _device_fields_none(rows)
    names = [r["name"] for r in rows]
    assert names[:13] == ["build_pyramid", "fast_dual", "nms3x3", "detect_keypoints",
                          "gaussian_blur", "extract_patches", "keypoint_angles", "brief_bits",
                          "extract_orb (full)", "make_frame", "make_frame_lines",
                          "track_against_points", "track_local_map_step"]
    assert names[13] == "keyframe frame 0" and names[-1] == "frame_step (real map)"
    rows = profile_backend.run("cpu", cfg=cfg, reps=1, ba_reps=1, graph_reps=1,
                               sharded_shape=(64, 256, 4, 8, 16))
    _device_fields_none(rows)
    assert [r["max_dT"] for r in rows if "sharded" in r["name"]] == [0.0, 0.0, 0.0]
    rows = roofline.run("cpu", cfg=cfg, reps=1, ba_reps=1, ba_shape=(64, 256))
    _device_fields_none(rows)
    assert len(rows) == 9 and roofline.targets(rows) == []
    assert "Card: CPU" in roofline.table(rows, "cpu")
