"""Relocalization after a kidnap, and the early reset, at 320x240: the JAX
``SlamSystem`` against the port's ``SlamSystem(device="cpu")`` on the
scenario of tests/test_relocalization.py (points only, BoW on,
``reset_if_lost_with_kfs=0`` and ``kf_max_interval=3`` for the kidnap).

The JAX system tracks 10 frames; the port starts from copies of its state
(map, keyframe database, last pose; ``interop``), so both relocalize
against one map. Tracked separately the two maps already differ by up to
2.4 cm per frame on this fast arc (f32 gate flips, as in
tests/test_torch_slice.py). The port relocalizes twice: fed the JAX
package's RANSAC draws (``jax.random.split(PRNGKey(frame_id * 131 + rank))``
and ``uniform`` on the first key, as JAX draws them), and with its own
CPU-generator draws. Bars: the same outcome in both packages (state, one
relocalization, the next frame OK, a single reset and one keyframe after
the early loss) and camera centres within 1 cm of each other; the
relocalized centre within 5 cm of the truth, the bar of
tests/test_relocalization.py. As in the other slice tests, JAX's keypoint
top-k is pinned to ``lax.top_k`` and its local BA runs the scatter assembly
(``PSLAM_BA_ONEHOT=0``), with fresh jit caches."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import render_sequence
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline.system import SlamSystem as JSys, TrackState as JState
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import relocalization as treloc
from pslam_tpu_torch.pipeline.system import HostFrame as THostFrame
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys, TrackState as TState
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
N_FRAMES = 10


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


def _cfgs(kidnap: bool):
    out = []
    for Cfg, Cam, Orb, Caps in ((JCfg, JCam, JOrb, JCaps), (TCfg, TCam, TOrb, TCaps)):
        c = Cfg(camera=Cam(**CAM_KW), orb=Orb(n_features=500), caps=Caps(local_points=1024),
                use_lines=False, use_loop_closing=False)
        if kidnap:
            c = dataclasses.replace(c, tracking=dataclasses.replace(
                c.tracking, reset_if_lost_with_kfs=0, kf_max_interval=3))
        out.append(c)
    return out


def _jax_priorities(seed, n_trials, n, device):
    key3, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(jax.random.uniform(key3, (n_trials, n)))).to(device)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(JCam(**CAM_KW), n_frames=N_FRAMES, seed=0)


@pytest.fixture(scope="module")
def pinned():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _port_from_jax(js, tc):
    """A port system in the JAX system's state: its map, database, last
    pose, reference keyframe and frame counter."""
    ts = TSys(tc, device="cpu")
    ts.map = interop.map_state_from_arrays(tc, vars(js.map))
    ts.kf_db = interop.keyframe_db_from_numpy(js.kf_db, ts.kf_db.vocab)
    ts.last = THostFrame(frame_id=js.last.frame_id, timestamp=js.last.timestamp,
                         T_cw=js.last.T_cw.copy())
    ts.ref_kf, ts.frame_id, ts.state = js.ref_kf, js.frame_id, TState[js.state.name]
    return ts


@pytest.fixture(scope="module")
def kidnap(frames, pinned):
    grays, depths, poses_gt = frames
    jc, tc = _cfgs(kidnap=True)
    js = JSys(jc)
    for i in range(N_FRAMES):
        js.track_rgbd(grays[i], depths[i], i / 30.0)
    js.flush()
    ts = _port_from_jax(js, tc)
    ts_own = copy.deepcopy(ts)
    before = (js.state.name, js.map.n_kf)

    def lost_then(slam, draws=None):
        # Kidnap: declare the tracker lost, then show it an already-mapped view.
        slam.state = type(slam.state).LOST
        with pytest.MonkeyPatch.context() as mp:
            if draws is not None:
                mp.setattr(treloc, "ransac_priorities", draws)
            T = slam.track_rgbd(grays[3], depths[3], 11 / 30.0)
        state = slam.state.name
        slam.track_rgbd(grays[4], depths[4], 12 / 30.0)
        return T, state, slam.stats.get("relocs", 0), slam.state.name

    return dict(before=before, gt=poses_gt[3], jax=lost_then(js),
                port_jax_draws=lost_then(ts, _jax_priorities), port_own_draws=lost_then(ts_own))


def test_the_map_before_the_kidnap(kidnap):
    state, n_kf = kidnap["before"]
    assert state == "OK" and n_kf >= 3


@pytest.mark.parametrize("draws", ["port_jax_draws", "port_own_draws"])
def test_relocalize_after_kidnap_like_jax(kidnap, draws):
    Tj, sj, rj, nj = kidnap["jax"]
    Tt, st, rt, nt = kidnap[draws]
    assert sj == st == "OK"
    assert rj == rt == 1
    assert nj == nt == "OK"
    Cj, Ct, Cg = _centre(Tj), _centre(Tt), _centre(kidnap["gt"])
    assert np.linalg.norm(Ct - Cj) < 0.01, np.linalg.norm(Ct - Cj)
    assert np.linalg.norm(Ct - Cg) < 0.05


def test_reset_when_lost_early_like_jax(frames, pinned):
    grays, depths, _ = frames
    jc, tc = _cfgs(kidnap=False)
    js, ts = JSys(jc), TSys(tc, device="cpu")
    out = []
    for slam, lost in ((js, JState.LOST), (ts, TState.LOST)):
        slam.track_rgbd(grays[0], depths[0], 0.0)
        assert slam.state.name == "OK"
        slam.state = lost  # lost with <= 5 KFs -> hard reset
        T = slam.track_rgbd(grays[5], depths[5], 1 / 30.0)
        out.append((slam.stats.get("resets", 0), slam.state.name, slam.map.n_kf, T))
    (rj, sj, kj, Tj), (rt, st, kt, Tt) = out
    assert rj == rt == 1 and sj == st == "OK" and kj == kt == 1
    assert np.linalg.norm(_centre(Tt) - _centre(Tj)) < 0.01
