"""Parity of localization-only mode and its visual-odometry fallback against
the JAX package, at 320x240 with 500 ORB features.

- The VO steps (``track_frame_to_frame`` and its unwindowed fallback) on one
  JAX-built frame pair: identical matches and inlier masks, pose within
  1e-4.
- The system: tests/test_round5.py's excursion (12 mapping frames looking at
  the back wall, then yaw out to 150 deg, where the frozen map is out of
  view, and back), with 8 yaw steps out instead of 14, then
  tests/test_round4.py's freeze checks: a blackout ends in LOST without a
  reset, and a revisited view relocalizes. Both packages run it; per frame
  the same state and mbVO flag, centres within 1 cm, and the same stats
  (the port's tracking counters aside).

The JAX keypoint top-k is pinned to ``lax.top_k`` and its local BA runs the
scatter assembly (``PSLAM_BA_ONEHOT=0``), with fresh jit caches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import ClosedRoom, arc_trajectory, render_sequence
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline import track_ops as jto
from pslam_tpu.pipeline.frame_ops import make_frame as j_make_frame
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import track_ops as tto
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys, TrackState
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
CFG_KW = dict(use_lines=False, use_lils=False, use_loop_closing=False)
N_MAP = 12


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
def pinned():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def steps(pinned):
    """Frames 0 and 2 of the arc built by JAX; JAX's two VO steps from
    frame 0 (at its true pose) to frame 2, predicted at frame 1's pose
    (windowed) and at frame 0's (unwindowed)."""
    cam = JCam(**CAM_KW)
    grays, depths, poses = render_sequence(cam, poses=arc_trajectory(24)[:3], seed=0)
    orb = JOrb(n_features=500)
    fd0, fd2 = (j_make_frame(jnp.asarray(grays[i]), jnp.asarray(depths[i]), cam, orb)
                for i in (0, 2))
    T0, T1 = jnp.asarray(poses[0]), jnp.asarray(poses[1])
    win = jto.track_frame_to_frame(cam, T1, fd0, T0, fd2, 30.0, 1.2, 8)
    unwin = jto.track_frame_to_frame_unwindowed(cam, T0, fd0, T0, fd2, 1.2, 8)
    pts = jto._vo_point_set(fd0, T0)
    return jax.device_get((fd0, fd2, poses, win, unwin, pts))


def _port_frames(steps):
    fd0, fd2, poses = steps[:3]
    return (interop.frame_from_numpy(fd0, device="cpu"),
            interop.frame_from_numpy(fd2, device="cpu"),
            [torch.from_numpy(np.array(p)) for p in poses])


def test_vo_point_set_matches_jax(steps):
    fd0, _, T = _port_frames(steps)
    pts_j = steps[5]
    pts_t = tto._vo_point_set(fd0, T[0])
    for f in pts_t._fields:
        np.testing.assert_allclose(getattr(pts_t, f).numpy(), np.asarray(getattr(pts_j, f)),
                                   rtol=0, atol=1e-5, err_msg=f)


def _assert_same_step(res_t, res_j):
    assert int(res_j.n_inliers) > 100  # a real VO step
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_array_equal(res_t.match_point.numpy(), np.asarray(res_j.match_point))
    np.testing.assert_array_equal(res_t.inlier.numpy(), np.asarray(res_j.inlier))
    np.testing.assert_allclose(res_t.T_cw.numpy(), np.asarray(res_j.T_cw), rtol=0, atol=1e-4)


def test_track_frame_to_frame_matches_jax(steps):
    fd0, fd2, T = _port_frames(steps)
    res = tto.track_frame_to_frame(TCam(**CAM_KW), T[1], fd0, T[0], fd2, 30.0, 1.2, 8)
    _assert_same_step(res, steps[3])


def test_track_frame_to_frame_unwindowed_matches_jax(steps):
    fd0, fd2, T = _port_frames(steps)
    res = tto.track_frame_to_frame_unwindowed(TCam(**CAM_KW), T[0], fd0, T[0], fd2, 1.2, 8)
    _assert_same_step(res, steps[4])


def _excursion_poses():
    """tests/test_round5.py's excursion with 8 yaw steps out."""
    def yaw_pose(yaw, C):
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ np.asarray(C)
        return T

    C0 = np.array([0.0, 0.0, 1.0])
    poses = [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0]) for i in range(N_MAP)]
    out_yaws = np.linspace(0.44, 2.6, 8)
    poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws]
    poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws[::-1][1:]]
    poses += [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0]) for i in range(11, 7, -1)]
    return np.stack(poses).astype(np.float32)


@pytest.fixture(scope="module")
def runs(pinned):
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500),
              caps=JCaps(local_points=1024), **CFG_KW)
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500),
              caps=TCaps(local_points=1024), **CFG_KW)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=4)
    grays, depths, _ = render_sequence(jc.camera, poses=_excursion_poses(), room=room)
    black, no_depth = np.zeros_like(grays[0]), np.zeros_like(depths[0])
    # The excursion, a 2-frame blackout, then frames 5-7 of the map again.
    frames = [(grays[i], depths[i]) for i in range(len(grays))]
    frames += [(black, no_depth)] * 2 + [(grays[i], depths[i]) for i in (5, 6, 7)]
    js, ts = JSys(jc), TSys(tc, device="cpu")
    rows, frozen = [], None
    for i, (g, d) in enumerate(frames):
        if i == N_MAP:
            for s in (js, ts):
                s.activate_localization_mode()
            frozen = [(s.stats["kf_inserted"], int(s.map.mp_valid.sum())) for s in (js, ts)]
        Tj = js.track_rgbd(g, d, i / 30.0)
        Tt = ts.track_rgbd(g, d, i / 30.0)
        rows.append((js.state.name, ts.state.name, js._vo_mode, ts._vo_mode,
                     float(np.linalg.norm(_centre(Tj) - _centre(Tt)))))
    return js, ts, rows, frozen, len(grays)


def test_localization_only_runs_identical(runs):
    js, ts, rows, _, _ = runs
    for i, (sj, st, vj, vt, _) in enumerate(rows):
        assert (sj, vj) == (st, vt), (i, rows[i])
    worst = max(r[4] for r in rows)
    print(f"localization-only run: max centre difference {worst * 1e3:.3f} mm; stats {ts.stats}")
    assert worst <= 0.01, [round(r[4], 5) for r in rows]
    # The port also counts its tracked frames, frame_step runs and LM step
    # kernels; JAX does not.
    track = {"track_frames", "track_steps", "track_retries", "track_fallbacks",
             "pose_lm_steps"}
    assert ts.stats.keys() - js.stats.keys() <= track
    assert {k: v for k, v in ts.stats.items() if k not in track} == js.stats


def test_vo_survives_leaving_the_map(runs):
    """tests/test_round5.py's bars, on the port."""
    _, ts, rows, _, n_exc = runs
    assert ts.stats.get("vo_frames", 0) >= 3, ts.stats
    assert rows[n_exc - 1][1] == "OK"
    assert sum(r[1] == "LOST" for r in rows[N_MAP:n_exc]) <= 4
    assert not any(r[3] for r in rows[n_exc - 2: n_exc])  # back on map inliers


def test_frozen_map_blackout_and_relocalization(runs):
    """tests/test_round4.py's bars, on the port: nothing inserted after the
    freeze, the blackout ends LOST without a reset, then a relocalization."""
    js, ts, rows, frozen, n_exc = runs
    assert ts.stats["kf_inserted"] == frozen[1][0]
    assert int(ts.map.mp_valid.sum()) == frozen[1][1]
    assert [r[1] for r in rows[n_exc:n_exc + 2]] == ["LOST", "LOST"]
    assert ts.stats.get("resets", 0) == 0
    assert rows[-1][1] == "OK" and ts.stats.get("relocs", 0) >= 1
    for s in (js, ts):
        s.deactivate_localization_mode()
        assert not s.localization_only and not s._vo_mode and s._vo_prev is None
    assert ts.state == TrackState.OK
