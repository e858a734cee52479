"""The last public functions of the JAX package, ported: ``ops.fast_score``
(exact), ``solver.mono_residual_jac`` (1e-5), ``ops.bow.save_vocabulary``
(both packages load the file and get JAX's arrays, exact), and the
synchronous backend wrappers ``local_mapping.create_new_map_points`` and
``search_in_neighbors`` on the scenarios of tests/test_local_mapping.py,
run in both packages on one scene: the same counts, integer and boolean
map arrays equal, float ones within 1e-4 absolute + 1e-4 relative (the
mono triangulation at a 0.25 m baseline solves a 4x4 SVD in f32 in each
package; measured 2.9e-4 m at ~4 m depth), and the JAX tests' bars on the
port's result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam, se3_exp as j_se3_exp
from pslam_tpu.models.map_state import MapState as JMap
from pslam_tpu.ops import bow as jbow
from pslam_tpu.ops.fast import fast_score as j_fast_score
from pslam_tpu.pipeline import local_mapping as jlm
from pslam_tpu.solver.reproj import mono_residual_jac as j_mono
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.models.map_state import MapState as TMap
from pslam_tpu_torch.ops import bow as tbow
from pslam_tpu_torch.ops import fast_score as t_fast_score
from pslam_tpu_torch.pipeline import local_mapping as tlm
from pslam_tpu_torch.solver import mono_residual_jac as t_mono
from pslam_tpu_torch.utils.config import SlamConfig as TCfg
from test_local_mapping import CFG as JCFG, add_kf_observing, look_at_pose

TCFG = TCfg(use_lines=False, use_bow=False, use_loop_closing=False)
CAM_KW = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("threshold", [7, 20])
def test_fast_score_equals_jax(threshold):
    """Integer intensities, so every score sum is exact in f32 whatever the
    summation order."""
    rng = np.random.default_rng(threshold)
    stack = rng.integers(0, 256, (2, 40, 56)).astype(np.float32)
    stack[:, 10:20, 10:20] = 250.0  # flat blobs with corners
    corner_j, score_j = (np.asarray(a) for a in j_fast_score(jnp.asarray(stack), threshold))
    corner_t, score_t = (a.numpy() for a in t_fast_score(torch.from_numpy(stack), threshold))
    np.testing.assert_array_equal(corner_t, corner_j)
    np.testing.assert_array_equal(score_t, score_j)
    assert corner_t.any() and not corner_t.all()


def test_mono_residual_jac_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (n, 3)).astype(np.float32)
    xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)].astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray(xi)))
    obs = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    T_b = np.broadcast_to(T, (n, 4, 4)).copy()
    ref = [np.asarray(a) for a in j_mono(JCam(**CAM_KW), jnp.asarray(T_b), jnp.asarray(X),
                                         jnp.asarray(obs))]
    got = [a.numpy() for a in t_mono(TCam(**CAM_KW), torch.from_numpy(T_b),
                                     torch.from_numpy(X), torch.from_numpy(obs))]
    for name, g, r in zip(("r", "J_pose", "J_point"), got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)


def test_save_vocabulary_loads_in_both_packages(tmp_path):
    """The port writes JAX's ``.npz`` keys: the packaged vocabulary, loaded
    by the port and saved again, loads in both packages with JAX's arrays."""
    j_ref = jbow.load_vocabulary(jbow.PACKAGED_VOCAB)
    path = str(tmp_path / "vocab.npz")
    tbow.save_vocabulary(tbow.load_vocabulary(tbow.PACKAGED_VOCAB, device="cpu"), path)
    j_got = jbow.load_vocabulary(path)
    t_got = tbow.load_vocabulary(path, device="cpu")
    assert len(j_got.node_desc) == len(t_got.node_desc) == len(j_ref.node_desc)
    for a, b, c in zip(j_got.node_desc, t_got.node_desc, j_ref.node_desc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    np.testing.assert_array_equal(np.asarray(j_got.idf), np.asarray(j_ref.idf))
    np.testing.assert_array_equal(t_got.idf.numpy(), np.asarray(j_ref.idf))


def _scene(seed):
    rng = np.random.default_rng(seed)
    X_w = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 5.0], (60, 3)).astype(np.float32)
    descs = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    return X_w, descs, rng


def _map_arrays(m):
    return {k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)}


def _assert_maps_match(mt, mj):
    a, b = _map_arrays(mt), _map_arrays(mj)
    for k in b:
        if b[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_create_new_map_points_matches_jax():
    """tests/test_local_mapping.py::test_epipolar_triangulation_creates_points
    in both packages."""
    X_w, descs, _ = _scene(11)
    results = []
    for m, fn in ((JMap(JCFG), lambda m, k: jlm.create_new_map_points(m, k, JCFG)),
                  (TMap(TCFG), lambda m, k: tlm.create_new_map_points(m, k, TCFG, "cpu"))):
        k0 = add_kf_observing(m, X_w, descs, look_at_pose([0, 0, 0]), 0, with_depth=False)
        k1 = add_kf_observing(m, X_w, descs, look_at_pose([0.25, 0, 0], yaw=0.02), 1,
                              with_depth=False)
        shared = m.alloc_map_points(20)
        m.mp_valid[shared] = True
        m.kf_feat_mp[k0, 100:120] = shared
        m.kf_feat_mp[k1, 100:120] = shared
        m._attach_observations(k0)
        m._update_covisibility(k1)
        results.append((fn(m, k1), m, shared, k0, k1))
    (n_j, mj, *_), (n_t, mt, shared, k0, k1) = results
    assert n_t == n_j >= 45
    _assert_maps_match(mt, mj)
    ids = np.flatnonzero(mt.mp_valid)
    ids = ids[~np.isin(ids, shared)]
    err = [np.linalg.norm(X_w - mt.mp_pos[i], axis=1).min() for i in ids]
    assert np.median(err) < 0.02
    assert (mt.kf_feat_mp[k0, :60] >= 0).sum() >= 40
    assert (mt.mp_n_obs[ids] == 2).all()


def test_search_in_neighbors_matches_jax():
    """tests/test_local_mapping.py::test_fuse_merges_duplicates in both
    packages."""
    X_w, descs, rng = _scene(12)
    X_dup = X_w + rng.normal(0, 0.003, X_w.shape).astype(np.float32)
    results = []
    for m, fn in ((JMap(JCFG), lambda m, k: jlm.search_in_neighbors(m, k, JCFG)),
                  (TMap(TCFG), lambda m, k: tlm.search_in_neighbors(m, k, TCFG, "cpu"))):
        k0 = add_kf_observing(m, X_w, descs, look_at_pose([0, 0, 0]), 0)
        k1 = add_kf_observing(m, X_w, descs, look_at_pose([0.3, 0, 0], yaw=0.03), 1)
        ids0 = m.create_points_from_depth(k0, np.arange(60), X_w)
        m.create_points_from_depth(k1, np.arange(60), X_dup)
        m.mp_n_obs[ids0] += 1
        m._update_covisibility(k1)
        m.covis[k0, k1] = m.covis[k1, k0] = 60
        results.append((fn(m, k1), m, ids0, k1))
    (f_j, mj, *_), (f_t, mt, ids0, k1) = results
    assert f_t == f_j >= 40
    _assert_maps_match(mt, mj)
    assert int(mt.mp_valid.sum()) <= 120 - 40
    assert np.isin(mt.kf_feat_mp[k1, :60], ids0).sum() >= 40


@pytest.mark.parametrize("name", ["profile_frame", "profile_backend", "roofline"])
def test_profiling_apps_measure_the_card_by_default(name):
    """Each profiling app (the counterparts of scripts/profile_frame.py +
    bench_frame_step.py, profile_backend.py + bench_sharded.py and
    roofline.py) has ``run(device="cuda", ...)`` and a ``main`` whose
    ``--device`` defaults to the card and whose ``--out`` names the table's
    file; no app writes ROOFLINE.md or SHARDED_r05.json."""
    import importlib
    import inspect

    app = importlib.import_module(f"pslam_tpu_torch.apps.{name}")
    assert inspect.signature(app.run).parameters["device"].default == "cuda"
    src = inspect.getsource(app)
    assert '"--out"' in src and '"--device", default="cuda"' in src
    assert "ROOFLINE.md" not in src.replace("``ROOFLINE.md``", "")
    assert "SHARDED_r05" not in src
