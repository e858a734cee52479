"""Parity of the host-side line and LIL bookkeeping: every function of
``pipeline/line_mapping.py`` and the line/LIL methods of ``MapState``, run
by both packages on copies of one map. Bar: every map array (and every
returned array) identical.

The map comes from four frames of the port's config-3 slice at 320x240
(keyframes with lines, map lines and InsectLines); both packages' maps are
filled from its arrays. The code under test is host numpy in both packages,
so nothing here depends on which package built the map."""

import copy
import types

import numpy as np
import pytest
import torch

from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.models.map_state import MapState as JMap
from pslam_tpu.ops.lines import LineConfig as JLines
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline import line_mapping as jlm
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.io.synthetic import arc_trajectory, render_sequence
from pslam_tpu_torch.ops.fans import LILFeatures
from pslam_tpu_torch.ops.lines import LineConfig as TLines
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import line_mapping as tlm
from pslam_tpu_torch.pipeline.frame_ops import make_frame, make_frame_lines
from pslam_tpu_torch.pipeline.system import SlamSystem
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
CAPS = dict(local_points=1024, max_map_lines=512, max_lils=64)
CFG_KW = dict(use_bow=False, use_loop_closing=False)
JC = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500), lines=JLines(tile=8),
          caps=JCaps(**CAPS), **CFG_KW)
TC = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500), lines=TLines(tile=8),
          caps=TCaps(**CAPS), **CFG_KW)


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
def built():
    """The port's slice on frames 0-3 (its map) and frame 5's features."""
    poses = arc_trajectory(24)[:6]
    grays, depths, _ = render_sequence(TC.camera, poses=poses, seed=0)
    slam = SlamSystem(TC, device="cpu")
    for i in range(4):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    slam.flush()
    g, d = torch.from_numpy(grays[5]), torch.from_numpy(depths[5])
    fd = make_frame(g, d, TC.camera, TC.orb)
    fl = make_frame_lines(g, d, TC.camera, TC.lines, TC.caps.frame_lils)
    frame = {k: v.numpy() for k, v in fd._asdict().items()}
    lines = {k: v.numpy() for k, v in fl._asdict().items() if k != "lil"}
    lil = LILFeatures(*(a.numpy() for a in fl.lil))
    T5 = (poses[5] @ np.linalg.inv(poses[0])).astype(np.float32)
    return slam.map, frame, lines, lil, T5


def _maps(src):
    """Equal copies of ``src``'s arrays in a JAX and a port MapState."""
    arrays = {k: copy.deepcopy(v) for k, v in vars(src).items() if k != "cfg"}
    mj = JMap(JC)
    for k, v in arrays.items():
        setattr(mj, k, copy.deepcopy(v))
    return mj, interop.map_state_from_arrays(TC, arrays)


def _assert_same(mj, mt):
    for k, v in vars(mt).items():
        if k == "cfg":
            continue
        ref = getattr(mj, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == ref.dtype, k
            np.testing.assert_array_equal(v, ref, err_msg=k)
        else:
            assert v == ref, k


def _host_frame(lines, lil, line_ml, lil_il):
    hf = types.SimpleNamespace(**{f"line_{k}": v.copy() for k, v in lines.items()})
    hf.line_ml = line_ml.copy()
    hf.lil = lil
    hf.lil_il = lil_il.copy()
    return hf


def test_map_has_lines_and_lils(built):
    m = built[0]
    assert m.n_kf >= 3 and m.ml_valid.sum() > 10 and m.il_valid.sum() >= 1


def test_frame_geometry_helpers(built):
    _, _, _, lil, T5 = built
    state = np.concatenate([lil.p1s, lil.p1e, lil.p2s, lil.p2e, lil.cross3d], -1)
    np.testing.assert_array_equal(tlm.world_points_of_lil(state, T5),
                                  jlm.world_points_of_lil(state, T5))
    np.testing.assert_array_equal(tlm.world_plane(lil.plane, T5), jlm.world_plane(lil.plane, T5))
    np.testing.assert_array_equal(tlm.lil_obs8(lil), jlm.lil_obs8(lil))


def test_keyframe_line_and_lil_creation(built):
    """A new keyframe: attach tracked lines and LILs, create the rest, cull
    by quality, triangulate new map lines against the neighbours, fuse, and
    refresh the line statistics."""
    m0, frame, lines, lil, T5 = built
    mj, mt = _maps(m0)
    line_ml = np.full(len(lines["valid"]), -1, np.int32)
    tracked = np.flatnonzero(lines["valid"])[:6]
    line_ml[tracked] = np.flatnonzero(m0.ml_valid)[: len(tracked)]
    lil_il = np.full(TC.caps.frame_lils, -1, np.int32)
    v = np.flatnonzero(lil.valid)
    lil_il[v[:1]] = np.flatnonzero(m0.il_valid)[:1]
    out = []
    for m, lm, cfg in ((mj, jlm, JC), (mt, tlm, TC)):
        hf = _host_frame(lines, lil, line_ml, lil_il)
        kf = m.add_keyframe(50, 5 / 30.0, T5, frame["uv"], frame["ur"], frame["level"],
                            frame["angle"], frame["desc"], frame["valid"], frame["depth"],
                            np.full(len(frame["valid"]), -1, np.int32))
        res = [lm.create_or_attach_lines(m, kf, hf, T5),
               lm.create_or_attach_lils(m, kf, hf, T5),
               lm.cull_lils_by_quality(m, cfg),
               lm.cull_lines(m, cfg),
               lm.create_new_map_lines(m, kf, cfg),
               lm.fuse_lines_in_neighbors(m, kf, cfg)]
        row = m.kf_line_ml[kf]
        m.update_line_stats(np.unique(row[row >= 0]))
        out.append((res, hf.line_ml, hf.lil_il))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][2], out[0][2])
    assert out[1][0][0] > 0  # map lines created
    _assert_same(mj, mt)


def test_lil_edges_and_local_lines(built):
    m0 = built[0]
    mj, mt = _maps(m0)
    cam_ids = list(np.flatnonzero(m0.kf_valid))
    ref = jlm.assemble_lil_edges(mj, cam_ids, JC)
    got = tlm.assemble_lil_edges(mt, cam_ids, TC, "cpu")
    assert ref is not None and got is not None
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    for f in ref[2]._fields:
        np.testing.assert_array_equal(getattr(got[2], f).numpy(), getattr(ref[2], f))
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[2].valid.sum() >= 1
    for cap in (512, 5):
        np.testing.assert_array_equal(tlm.local_map_lines(mt, cam_ids, cap),
                                      jlm.local_map_lines(mj, cam_ids, cap))
    assert tlm.assemble_lil_edges(mt, [], TC, "cpu") is None


def test_map_line_and_lil_methods(built):
    """replace, cull, stats refresh and capacity eviction of map lines and
    LILs, and LIL observation attachment."""
    m0 = built[0]
    mj, mt = _maps(m0)
    ml = np.flatnonzero(m0.ml_valid)
    il = np.flatnonzero(m0.il_valid)
    for m in (mj, mt):
        m.ml_found[ml[:4]] = 0
        m.ml_visible[ml[:4]] = 9
        m.replace_map_line(int(ml[5]), int(ml[6]))
        m.replace_map_line(int(ml[7]), int(ml[7]))
        m.update_line_stats()
        m.cull_map_lines(ml[8:10])
        m.attach_lil_observations(int(m.last_kf), np.arange(2), il[:1].repeat(2),
                                  np.ones((2, 8), np.float32))
        m.cull_lils(il[-1:])
        # Fill both tables past capacity: the fewest-observed entries are
        # evicted (``_alloc``).
        n_ml = int(m.ml_valid.shape[0] - m.ml_valid.sum() + 3)
        k = int(m.last_kf)
        m.create_map_lines(k, np.arange(n_ml) % 128,
                           np.tile(np.float32([0, 0, 2, 0.5, 0, 2]), (n_ml, 1)),
                           np.ones((n_ml, 40), np.float32))
        n_il = int(m.il_valid.shape[0] - m.il_valid.sum() + 2)
        m.create_lils(k, np.arange(n_il) % 64,
                      np.tile(np.linspace(0, 1, 15, dtype=np.float32), (n_il, 1)),
                      np.tile(np.float32([0, 0, 1, 2]), (n_il, 1)),
                      np.zeros((n_il, 8), np.float32))
    assert mt.ml_valid.all() and mt.il_valid.all()
    _assert_same(mj, mt)


def test_culling_matches(built):
    m0 = built[0]
    mj, mt = _maps(m0)
    for m in (mj, mt):
        m.next_kf_seq += 10  # age every landmark past its probation
        m.ml_visible[:] = 4
        m.ml_found[::3] = 0
    assert tlm.cull_lils_by_quality(mt, TC) == jlm.cull_lils_by_quality(mj, JC) > 0
    assert tlm.cull_lines(mt, TC) == jlm.cull_lines(mj, JC) > 0
    _assert_same(mj, mt)
