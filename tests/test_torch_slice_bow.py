"""The default configuration (BASELINE config 4: points, map lines, LILs,
BoW place recognition and loop closing): the JAX ``SlamSystem`` against the
port's ``SlamSystem(device="cpu")`` over the first 8 frames of the 24-frame
arc at 320x240, 500 ORB features, 8 px line tiles, a 1024-point local map,
32 keyframes, and the k=8, 3-level vocabulary of tests/test_loop_closing.py
(both packages train it from the same seed when no packaged vocabulary
matches).

Bars: the same vocabulary; identical TrackState per frame; the same
keyframe count and keyframe frame ids; identical database rows (present
rows, words and nodes exact, BoW vectors within 1e-6); the same loop-closer
stats; per-frame camera-centre difference <= 1 cm (the bound of
tests/test_torch_slice.py). As there, JAX's keypoint top-k is pinned to
``lax.top_k`` and its local BA runs the scatter assembly
(``PSLAM_BA_ONEHOT=0``), with fresh jit caches."""

import jax
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import arc_trajectory, render_sequence
from pslam_tpu.ops.lines import LineConfig as JLines
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.lines import LineConfig as TLines
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
CAPS_KW = dict(local_points=1024, max_keyframes=32)
N_FRAMES = 8


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


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module")
def runs():
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500), lines=JLines(tile=8),
              caps=JCaps(**CAPS_KW), bow_k=8, bow_levels=3)
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500), lines=TLines(tile=8),
              caps=TCaps(**CAPS_KW), bow_k=8, bow_levels=3)
    assert jc.use_bow and jc.use_loop_closing and jc.use_lils
    assert tc.use_bow and tc.use_loop_closing and tc.use_lils
    grays, depths, _ = render_sequence(jc.camera, poses=arc_trajectory(24)[:N_FRAMES], seed=0)
    js, ts = JSys(jc), TSys(tc, device="cpu")
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        for i in range(N_FRAMES):
            Tj = js.track_rgbd(grays[i], depths[i], i / 30.0)
            Tt = ts.track_rgbd(grays[i], depths[i], i / 30.0)
            rows.append((js.state.name, ts.state.name, js.map.n_kf, ts.map.n_kf,
                         float(np.linalg.norm(_centre(Tj) - _centre(Tt)))))
        js.flush()
    jax.clear_caches()
    ts.flush()
    return js, ts, rows


def test_same_vocabulary(runs):
    js, ts, _ = runs
    for a, b in zip(js.kf_db.vocab.node_desc, ts.kf_db.vocab.node_desc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ts.kf_db.vocab.idf.numpy(), np.asarray(js.kf_db.vocab.idf))


def test_states_keyframes_and_database_rows_identical(runs):
    js, ts, rows = runs
    for sj, st, kj, kt, _ in rows:
        assert sj == st == "OK"
        assert kj == kt
    K = js.map.n_kf
    assert ts.map.n_kf == K >= 3
    np.testing.assert_array_equal(ts.map.kf_frame_id[:K], js.map.kf_frame_id[:K])
    dj, dt = js.kf_db, ts.kf_db
    np.testing.assert_array_equal(dt.present, dj.present)
    assert dt.present.sum() == K
    np.testing.assert_array_equal(dt.word[:K], dj.word[:K])
    np.testing.assert_array_equal(dt.node[:K], dj.node[:K])
    np.testing.assert_allclose(dt.bow[:K], dj.bow[:K], atol=1e-6, rtol=0)
    assert ts.loop_closer.stats == js.loop_closer.stats


def test_per_frame_centres_close(runs):
    _, _, rows = runs
    worst = max(r[4] for r in rows)
    assert worst <= 0.01, [round(r[4], 5) for r in rows]
