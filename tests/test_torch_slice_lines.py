"""The structural-line slice: the JAX ``SlamSystem`` against the port's
``SlamSystem(device="cpu")`` on BASELINE config 3 (points, map lines and
LILs with the composite error; no BoW, no loop closing), 8 frames at 320x240
(the first 8 of a 24-frame arc), 500 ORB features, a 1024-point local map.

The line tiles are cut with the image: 8 px at 320x240 for the default
16 px at 640x480, so the 320x240 box scene yields lines and LILs at all.

Bars: identical TrackState per frame; the same keyframe count and keyframe
frame ids; equal ``ba_runs``; equal counts of valid map lines and valid
LILs; at least one LIL and one LIL BA edge; per-frame camera-centre
difference <= 1 cm (the bound of tests/test_torch_slice.py, for the same
reason: f32 gate flips carried forward by the backend).

As in tests/test_torch_slice.py, the JAX keypoint top-k is pinned to
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
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.lines import LineConfig as TLines
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import frame_step as tfs
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
CFG_KW = dict(use_bow=False, use_loop_closing=False)
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
              caps=JCaps(local_points=1024), **CFG_KW)
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500), lines=TLines(tile=8),
              caps=TCaps(local_points=1024), **CFG_KW)
    assert jc.use_lines and jc.use_lils and tc.use_lines and tc.use_lils
    grays, depths, _ = render_sequence(
        jc.camera, poses=arc_trajectory(24)[:N_FRAMES], seed=0
    )
    js, ts = JSys(jc), TSys(tc, device="cpu")
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        for i in range(N_FRAMES):
            Tj = js.track_rgbd(grays[i], depths[i], i / 30.0)
            Tt = ts.track_rgbd(grays[i], depths[i], i / 30.0)
            rows.append((js.state, ts.state, js.map.n_kf, ts.map.n_kf,
                         float(np.linalg.norm(_centre(Tj) - _centre(Tt)))))
        js.flush()
    jax.clear_caches()
    ts.flush()
    return js, ts, rows


def test_states_and_keyframes_identical(runs):
    js, ts, rows = runs
    for sj, st, kj, kt, _ in rows:
        assert sj.name == st.name == "OK"
        assert kj == kt
    assert ts.map.n_kf == js.map.n_kf >= 3
    np.testing.assert_array_equal(
        ts.map.kf_frame_id[: ts.map.n_kf], js.map.kf_frame_id[: js.map.n_kf]
    )
    assert ts.stats["ba_runs"] == js.stats["ba_runs"] >= 1


def test_line_and_lil_landmarks(runs):
    js, ts, _ = runs
    assert int(ts.map.ml_valid.sum()) == int(js.map.ml_valid.sum()) > 0
    assert int(ts.map.il_valid.sum()) == int(js.map.il_valid.sum()) >= 1
    assert ts.stats["lil_ba_edges"] >= 1  # a local BA ran with LIL edges
    for key in ("lils_culled", "lines_triangulated"):
        assert ts.stats.get(key) == js.stats.get(key), key


def test_snapshot_carried_across_exactly(runs):
    """The port's snapshot of the JAX map (points, map lines, InsectLines)
    equals JAX's own snapshot, and ``interop`` carries JAX's snapshot tuples
    across with the port's dtypes."""
    js, ts, _ = runs
    js._rebuild_snapshot()  # of the flushed map (the last BA moved the LILs)
    m = interop.map_state_from_arrays(ts.cfg, vars(js.map))
    snap = tfs.build_snapshot(m, m.cfg, js._snap_pt_ids, "cpu", js._snap_ml_ids,
                              js._snap_il_ids)
    ref = jax.device_get(js._snap)
    assert ref.lines.valid.sum() > 0 and ref.lils.valid.sum() > 0
    for got, want, conv in ((snap.lines, ref.lines, interop.line_snap_from_numpy),
                            (snap.lils, ref.lils, interop.lil_snap_from_numpy)):
        carried = conv(want, device="cpu")
        for f in got._fields:
            assert getattr(carried, f).dtype == getattr(got, f).dtype, f
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f))
            np.testing.assert_array_equal(getattr(carried, f).numpy(), getattr(want, f))


def test_per_frame_centres_close(runs):
    _, _, rows = runs
    worst = max(r[4] for r in rows)
    assert worst <= 0.01, [round(r[4], 5) for r in rows]


def test_config2_tracks_with_lines_and_no_lils():
    """BASELINE config 2 (map lines, no composite error) runs through the
    same code: lines are mapped, no LIL is created."""
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500), lines=TLines(tile=8),
              caps=TCaps(local_points=1024), use_lils=False, **CFG_KW)
    grays, depths, _ = render_sequence(tc.camera, poses=arc_trajectory(24)[:4], seed=0)
    ts = TSys(tc, device="cpu")
    for i in range(4):
        ts.track_rgbd(grays[i], depths[i], i / 30.0)
        assert ts.state.name == "OK"
    ts.flush()
    assert ts.map.n_kf >= 3 and int(ts.map.ml_valid.sum()) > 0
    assert int(ts.map.il_valid.sum()) == 0 and "lil_ba_edges" not in ts.stats
