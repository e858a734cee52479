"""Checkpoints across the packages: a checkpoint written by the JAX package
(``pslam_tpu.io.checkpoint``) loads into the port
(``pslam_tpu_torch.io.checkpoint``) with every map array, the BoW database,
the vocabulary, the trajectory and the loop closer's state equal; the port's
own round trip gives identical arrays; a capacity mismatch is rejected; and
both resumed systems relocalize on a revisited view.

The system is tests/test_checkpoint.py's (256 ORB features, 32 keyframes,
BoW k=8 with 3 levels, loop closing on, no lines) at 320x240, 5 frames,
with ``reset_if_lost_with_kfs=0`` (as in tests/test_relocalization.py) so
that the resumed system relocalizes instead of resetting its small map. The
JAX keypoint top-k is pinned to ``lax.top_k``, with fresh jit caches."""

import jax
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
from pslam_tpu.io.synthetic import render_sequence
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg, TrackingConfig as JTrack
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline.system import TrackState
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg, TrackingConfig as TTrack

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
CAPS_KW = dict(max_keyframes=32, max_map_points=8192, local_points=1024)
CFG_KW = dict(use_lines=False, use_loop_closing=True, bow_k=8, bow_levels=3)


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


def _tcfg(**caps):
    return TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=256),
                caps=TCaps(**dict(CAPS_KW, **caps)),
                tracking=TTrack(reset_if_lost_with_kfs=0), **CFG_KW)


def _jcfg():
    return JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=256), caps=JCaps(**CAPS_KW),
                tracking=JTrack(reset_if_lost_with_kfs=0), **CFG_KW)


def _map_fields(m):
    return {k: v for k, v in vars(m).items() if isinstance(v, (np.ndarray, int)) and k != "cfg"}


def _assert_systems_equal(a, b):
    fa, fb = _map_fields(a.map), _map_fields(b.map)
    assert set(fa) <= set(fb)
    for k, v in fa.items():
        np.testing.assert_array_equal(np.asarray(fb[k]), np.asarray(v), err_msg=k)
    for name in ("bow", "word", "node", "present"):
        np.testing.assert_array_equal(getattr(b.kf_db, name), getattr(a.kf_db, name))
    for x, y in zip(a.kf_db.vocab.node_desc, b.kf_db.vocab.node_desc):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(a.kf_db.vocab.idf), np.asarray(b.kf_db.vocab.idf))
    assert [(t, r) for t, _, r in a.trajectory] == [(t, r) for t, _, r in b.trajectory]
    for (_, Ta, _), (_, Tb, _) in zip(a.trajectory, b.trajectory):
        np.testing.assert_array_equal(Ta, Tb)
    np.testing.assert_array_equal(a.poses, b.poses)
    assert (a.frame_id, a.ref_kf, a.state.name) == (b.frame_id, b.ref_kf, b.state.name)
    assert a.loop_closer.loop_edges == b.loop_closer.loop_edges
    assert a.loop_closer.last_loop_seq == b.loop_closer.last_loop_seq
    np.testing.assert_array_equal(a.velocity, b.velocity)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    jc = _jcfg()
    grays, depths, _ = render_sequence(jc.camera, n_frames=5, seed=1)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        jax.clear_caches()
        js = JSys(jc)
        for i in range(5):
            js.track_rgbd(grays[i], depths[i], 100.0 + i / 30.0)
        assert js.state.name == "OK" and js.map.n_kf >= 2
        j_save(js, path)
        resumed = j_load(path, jc)
        resumed.track_rgbd(grays[4], depths[4], 101.0)
    jax.clear_caches()
    return path, resumed, grays, depths


def test_jax_checkpoint_loads_into_the_port(jax_checkpoint):
    path, _, _, _ = jax_checkpoint
    ref = j_load(path, _jcfg())
    ts = load_checkpoint(path, _tcfg(), device="cpu")
    assert ts.state == TrackState.LOST and ts.map.n_kf >= 2
    _assert_systems_equal(ref, ts)


def test_port_round_trip_identical(jax_checkpoint, tmp_path):
    path, _, grays, depths = jax_checkpoint
    ts = load_checkpoint(path, _tcfg(), device="cpu")
    ts.track_rgbd(grays[4], depths[4], 101.0)  # relocalizes and moves the map on
    p2 = str(tmp_path / "port.npz")
    save_checkpoint(ts, p2)
    ts2 = load_checkpoint(p2, _tcfg(), device="cpu")
    ts.state = TrackState.LOST  # a resumed system starts LOST
    _assert_systems_equal(ts, ts2)
    assert ts2.stats == ts.stats


def test_capacity_mismatch_rejected(jax_checkpoint):
    path, _, _, _ = jax_checkpoint
    with pytest.raises(ValueError, match="capacity"):
        load_checkpoint(path, _tcfg(max_map_points=4096), device="cpu")


def test_resumed_systems_relocalize(jax_checkpoint):
    path, resumed_j, grays, depths = jax_checkpoint
    ts = load_checkpoint(path, _tcfg(), device="cpu")
    ts.track_rgbd(grays[4], depths[4], 101.0)
    assert ts.state.name == resumed_j.state.name == "OK"
    assert ts.stats.get("relocs", 0) == resumed_j.stats.get("relocs", 0) == 1
    assert len(ts.trajectory) == len(resumed_j.trajectory)
    np.testing.assert_allclose(ts.trajectory[-1][1], resumed_j.trajectory[-1][1], atol=1e-3)


def test_loaded_system_runs_on_the_requested_device(jax_checkpoint):
    path, _, _, _ = jax_checkpoint
    ts = load_checkpoint(path, _tcfg(), device="cpu")
    assert ts.device.type == "cpu"
    assert all(d.device.type == "cpu" for d in ts.kf_db.vocab.node_desc)


@pytest.mark.parametrize("writer", ["save_trajectory_tum", "save_keyframe_trajectory_tum",
                                    "save_trajectory_kitti"])
def test_trajectory_writers_match_jax(jax_checkpoint, tmp_path, writer):
    """The three trajectory writers on one state (the checkpoint loaded into
    both packages): the same rows, numbers within 1e-6."""
    path, _, _, _ = jax_checkpoint
    out = {}
    for name, system in (("jax", j_load(path, _jcfg())),
                         ("port", load_checkpoint(path, _tcfg(), device="cpu"))):
        getattr(system, writer)(str(tmp_path / name))
        out[name] = np.loadtxt(tmp_path / name, ndmin=2)
    assert out["port"].shape == out["jax"].shape
    assert out["jax"].shape[1] == (12 if writer.endswith("kitti") else 8)
    assert len(out["jax"]) >= 2
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=1e-6)
