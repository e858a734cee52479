"""Parity of depth-1 pipelined tracking (``track_rgbd_pipelined`` +
``finish``) against the JAX package's pipelined run: BASELINE config 1
(points only, no BoW, no loop closing), 8 frames of the arc at 320x240 with
500 ORB features and a 1024-point local map.

Bars: after every call the same state and keyframe count, the same returned
poses (None on the priming call) with camera centres within 1 cm, the same
keyframe frame ids, local BAs and keyframe insertions; 8 trajectory rows.
(The triangulation and fuse counts may differ by a few points, as in the
synchronous slice of tests/test_torch_slice.py.) Then the mixed-mode drain
of tests/test_round4.py on the port: a synchronous ``track_rgbd`` call
finishes the frame in flight first.

As in the other parity tests, the JAX keypoint top-k is pinned to
``lax.top_k`` and its local BA runs the scatter assembly
(``PSLAM_BA_ONEHOT=0``), with fresh jit caches."""

import jax
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import arc_trajectory, render_sequence
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg
from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
CFG_KW = dict(use_lines=False, use_bow=False, use_loop_closing=False)
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


def _tcfg():
    return TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500),
                caps=TCaps(local_points=1024), **CFG_KW)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(JCam(**CAM_KW), poses=arc_trajectory(24)[:N_FRAMES], seed=0)


@pytest.fixture(scope="module")
def runs(frames):
    grays, depths, poses_gt = frames
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500),
              caps=JCaps(local_points=1024), **CFG_KW)
    js, ts = JSys(jc), TSys(_tcfg(), device="cpu")
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        for i in range(N_FRAMES):
            Tj = js.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
            Tt = ts.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
            rows.append((js.state.name, ts.state.name, js.map.n_kf, ts.map.n_kf, Tj, Tt))
        js.finish()
        ts.finish()
        poses_j = js.poses
    jax.clear_caches()
    return js, ts, rows, poses_j, poses_gt


def test_pipelined_states_and_keyframes_identical(runs):
    js, ts, rows, _, _ = runs
    for sj, st, kj, kt, _, _ in rows:
        assert sj == st == "OK"
        assert kj == kt
    assert ts.map.n_kf == js.map.n_kf >= 3
    np.testing.assert_array_equal(ts.map.kf_frame_id[: ts.map.n_kf],
                                  js.map.kf_frame_id[: js.map.n_kf])
    for key in ("ba_runs", "kf_inserted", "kf_culled"):
        assert ts.stats[key] == js.stats[key], key
    assert ts._inflight is None and len(ts.trajectory) == len(js.trajectory) == N_FRAMES


def test_pipelined_poses_close(runs):
    _, ts, rows, poses_j, poses_gt = runs
    # Frame 0 initializes synchronously; the priming call of the pipeline
    # (frame 1) returns None, each later call the previous frame's pose.
    assert rows[1][4] is None and rows[1][5] is None
    diffs = [float(np.linalg.norm(_centre(r[4]) - _centre(r[5])))
             for r in rows if r[4] is not None]
    gt = trajectory_positions(poses_gt)
    ate_j = ate_rmse(trajectory_positions(poses_j), gt)
    ate_t = ate_rmse(trajectory_positions(ts.poses), gt)
    print(f"pipelined: max centre difference {max(diffs) * 1e3:.3f} mm; ATE JAX "
          f"{ate_j * 100:.3f} cm, port {ate_t * 100:.3f} cm")
    assert len(diffs) == N_FRAMES - 1 and max(diffs) <= 0.01, diffs
    assert abs(ate_t - ate_j) <= 0.005 and ate_t < 0.05, (ate_j, ate_t)


def test_mixed_mode_drains(frames):
    """tests/test_round4.py::TestPipelinedTracking::test_mixed_mode_drains."""
    grays, depths, _ = frames
    s = TSys(_tcfg(), device="cpu")
    for i in range(4):
        s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
    # The synchronous API finishes the frame in flight first.
    s.track_rgbd(grays[4], depths[4], 4 / 30.0)
    assert s._inflight is None
    assert len(s.trajectory) == 5
    for i in range(5, 8):
        s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
    s.finish()
    assert len(s.trajectory) == 8
    assert [ts for ts, _, _ in s.trajectory] == [i / 30.0 for i in range(8)]
