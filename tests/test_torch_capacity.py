"""The map's recycling, eviction and backstop contracts: the JAX package
against the port on the same numpy inputs.

Unit cases (the small capacities of tests/test_round5.py: 8 keyframes, 256
map points, 64 map lines; 250 features a keyframe), each run through both packages and held exactly
equal, because every step is host numpy in both:
- capacity eviction of keyframes (``SlamSystem._evict_for_capacity``), with
  no loop edge and with a loop edge on every unprotected keyframe (the
  fallback that drops the victim's edges): the same victims in the same
  order, the same ``kf_evicted``, the same retargeted trajectory rows
  (chains of retargets included), loop edges and BoW database rows (a
  recycled slot's row is replaced, not added to);
- the map-level backstop raising (tests/test_round5.py:151);
- recycled-slot generations (tests/test_round5.py:23) and
  ``_materialize_host_frame`` masking a recycled slot (:50);
- ``local_mapping._apply_fuse`` skipping a point the keyframe already
  observes (:112);
- ``alloc_map_points`` and the generic ``_alloc`` evicting the same
  lowest-value victims, ties broken by the stable argsort
  (tests/test_local_mapping.py:402);
- many keyframes interleaved with culling staying within capacity
  (tests/test_local_mapping.py:253).

The system run: BASELINE config 1 at 320x240 (500 ORB features, a 1024-point
local map) with ``Capacities(max_keyframes=6)`` over the first 24 frames of
``run_long``'s default 500-frame circuit (``loop_trajectory(500,
loops=2.0)`` in ``ClosedRoom(seed=9)``), so keyframe culling, slot reuse and
``_evict_for_capacity`` all fire. JAX is pinned as the slices pin it
(``lax.top_k``, ``PSLAM_BA_ONEHOT=0``), with fresh jit caches.
- Frames 0-11 tracked separately: every frame the same state, keyframe
  slots, reference keyframe and counts (inserted, culled, evicted, local
  BAs), ``kf_evicted > 0`` in both; per-frame camera centres within 1 cm,
  the slices' bar (tests/test_torch_slice.py; 5.99 mm measured at frame 11).
  At frame 12 the separate runs cull different keyframes: f32 gate flips
  carried forward, as in the slices (ROADMAP Queue 3).
- Frames 12-23 from one copy of JAX's state (flushed, snapshot dropped; the
  port's state through ``interop``), as tests/test_torch_relocalization.py
  does: the same decisions every frame (four more evictions, two culls),
  centres within 1 cm (0.07 mm at most).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import pslam_tpu.pipeline.local_mapping as j_lm
import pslam_tpu.pipeline.system as j_sys
import pslam_tpu_torch.pipeline.local_mapping as t_lm
import pslam_tpu_torch.pipeline.system as t_sys
from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
from pslam_tpu.models.map_state import MapState as JMap
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.models.map_state import MapState as TMap
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

MINI_CAPS = dict(max_keyframes=8, max_map_points=256, local_points=128, ba_cams=8,
                 ba_free=4, ba_points=128, ba_edges=2048, max_map_lines=64, max_lils=32,
                 frame_lils=8)
CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
N_FRAMES = 24
N_SEPARATE = 12

PKGS = {
    "jax": SimpleNamespace(Map=JMap, Sys=j_sys.SlamSystem, HostFrame=j_sys.HostFrame,
                           lm=j_lm, Cfg=JCfg, Caps=JCaps, Orb=JOrb, sys_kw={}, to_dev=np.asarray),
    "port": SimpleNamespace(Map=TMap, Sys=t_sys.SlamSystem, HostFrame=t_sys.HostFrame,
                            lm=t_lm, Cfg=TCfg, Caps=TCaps, Orb=TOrb, sys_kw={"device": "cpu"},
                            to_dev=torch.as_tensor),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes, and torch's default of a thread a
    core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini_cfg(p, **kw):
    base = dict(use_lines=False, use_lils=False, use_bow=False, use_loop_closing=False)
    base.update(kw)
    return p.Cfg(caps=p.Caps(**MINI_CAPS), orb=p.Orb(n_features=250), **base)


def _kf_args(N, rng=None, feat_mp=None):
    """Keyframe arrays for ``add_keyframe`` after (frame_id, timestamp, T_cw)."""
    uv = np.zeros((N, 2), np.float32) if rng is None else \
        rng.uniform(0, 300, (N, 2)).astype(np.float32)
    aux = np.zeros(N, np.float32)
    desc = np.zeros((N, 32), np.uint8) if rng is None else \
        rng.integers(0, 256, (N, 32), dtype=np.uint8)
    fmp = np.full(N, -1, np.int32) if feat_mp is None else feat_mp
    return (uv, aux, np.zeros(N, np.int32), aux, desc, np.ones(N, bool), aux + 2.0, fmp)


def _random_pose(rng):
    a = rng.uniform(-0.3, 0.3)
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return T


# ---------------------------------------------------------------------------
# Keyframe eviction


def _evict_run(p, loop_edges: bool):
    """Insert 3x capacity keyframes through the system's eviction, each
    observing a random subset of 200 points, each with a trajectory row; a
    loop edge (0, k) on every keyframe when ``loop_edges``. Returns what the
    contract fixes: the victims in order and the end state."""
    s = p.Sys(_mini_cfg(p, use_bow=True), **p.sys_kw)
    s.loop_closer = SimpleNamespace(loop_edges=[])
    m = s.map
    rng = np.random.default_rng(11)
    N = m.kf_uv.shape[1]
    pts = m.alloc_map_points(200)
    m.mp_valid[pts] = True
    m.mp_pos[pts] = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    victims, db_rows = [], []
    for i in range(3 * m.kf_valid.shape[0]):
        before = m.kf_valid.copy()
        s._evict_for_capacity()
        gone = np.flatnonzero(before & ~m.kf_valid)
        victims.extend(int(k) for k in gone)
        feat_mp = np.full(N, -1, np.int32)
        n_obs = int(rng.integers(20, 120))
        feat_mp[:n_obs] = rng.choice(pts, n_obs, replace=False)
        args = _kf_args(N, rng, feat_mp)
        k = m.add_keyframe(i, i * 0.1, _random_pose(rng), *args)
        bow = s.kf_db.compute_bow(args[4], args[5])
        s.kf_db.add(k, *bow)  # what SlamSystem._register_kf_bow does
        db_rows.append((k, s.kf_db.bow[k].copy(), bow[0]))
        s.ref_kf = k
        s.trajectory.append((i * 0.1, _random_pose(rng), k))
        if loop_edges and k != 0:
            s.loop_closer.loop_edges.append((0, k))
    return dict(victims=victims, evicted=s.stats.get("kf_evicted", 0),
                kf_valid=m.kf_valid.copy(), n_kf=m.n_kf, frame_id=m.kf_frame_id.copy(),
                trajectory=s.trajectory, loop_edges=list(s.loop_closer.loop_edges),
                db_rows=db_rows, db_present=s.kf_db.present.copy(), db_bow=s.kf_db.bow.copy())


@pytest.mark.parametrize("loop_edges", [False, True], ids=["no_loop_edges", "every_kf_a_loop_edge"])
def test_eviction_same_victims_rows_and_db(loop_edges):
    j, t = _evict_run(PKGS["jax"], loop_edges), _evict_run(PKGS["port"], loop_edges)
    cap = MINI_CAPS["max_keyframes"]
    assert t["victims"] == j["victims"] and len(j["victims"]) == 2 * cap
    assert t["evicted"] == j["evicted"] == 2 * cap
    np.testing.assert_array_equal(t["kf_valid"], j["kf_valid"])
    assert t["n_kf"] == j["n_kf"] == cap
    np.testing.assert_array_equal(t["frame_id"], j["frame_id"])
    assert t["loop_edges"] == j["loop_edges"]
    if loop_edges:
        # Every unprotected keyframe held an edge, so each victim lost its own
        # before its slot took a new keyframe and a new edge: one edge a live
        # keyframe, none twice.
        edges = j["loop_edges"]
        assert len(set(edges)) == len(edges) == int(j["kf_valid"].sum()) - 1
    assert [(ts, ref) for ts, _, ref in t["trajectory"]] == \
        [(ts, ref) for ts, _, ref in j["trajectory"]]
    refs = [ref for _, _, ref in j["trajectory"]]
    assert all(ref == -1 or j["kf_valid"][ref] for ref in refs)
    for (_, Tt, _), (_, Tj, _) in zip(t["trajectory"], j["trajectory"]):
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-6)
    # A recycled slot's BoW row is the new keyframe's, not a sum with the old.
    for (kt, row_t, fresh_t), (kj, row_j, _) in zip(t["db_rows"], j["db_rows"]):
        assert kt == kj
        np.testing.assert_array_equal(row_t, fresh_t)
        np.testing.assert_allclose(row_t, row_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t["db_present"], j["db_present"])
    np.testing.assert_array_equal(t["db_present"], t["kf_valid"])


# ---------------------------------------------------------------------------
# Map-level contracts


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_map_level_backstop_raises(pkg):
    p = PKGS[pkg]
    m = p.Map(_mini_cfg(p))
    N = m.kf_uv.shape[1]
    for i in range(MINI_CAPS["max_keyframes"]):
        m.add_keyframe(i, i * 0.1, np.eye(4, dtype=np.float32), *_kf_args(N))
    with pytest.raises(RuntimeError, match="capacity"):
        m.add_keyframe(99, 9.9, np.eye(4, dtype=np.float32), *_kf_args(N))


def _recycle(p):
    m = p.Map(_mini_cfg(p))
    N = m.kf_uv.shape[1]
    kf = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), *_kf_args(N))
    ids = m.create_points_from_depth(kf, np.arange(4),
                                     np.tile([0, 0, 2.0], (4, 1)).astype(np.float32))
    g0 = m.mp_gen[ids].copy()
    m.cull_map_points(ids[:2])
    ids2 = m.alloc_map_points(2)
    return ids, g0, ids2, m.mp_gen.copy(), m.mp_valid.copy()


def test_recycled_slot_changes_generation():
    j, t = _recycle(PKGS["jax"]), _recycle(PKGS["port"])
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    ids, g0, ids2, gen, _ = t
    assert set(ids2.tolist()) == set(ids[:2].tolist())
    assert (gen[ids2] == g0[:2] + 1).all() and (gen[ids[2:]] == g0[2:]).all()


def _materialize(p):
    """A snapshot of 3 points, then slot 0 culled and recycled; a frame that
    matched snapshot slots 0 and 1 binds only slot 1."""
    cfg = _mini_cfg(p)
    s = p.Sys(cfg, **p.sys_kw)
    m = s.map
    N = cfg.orb.capacity
    kf = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), *_kf_args(N))
    ids = m.create_points_from_depth(kf, np.arange(3),
                                     np.tile([0, 0, 2.0], (3, 1)).astype(np.float32))
    s.ref_kf = kf
    s._rebuild_snapshot()
    snap_ids = s._snap_id_pack()
    m.cull_map_points(ids[:1])
    rid = m.alloc_map_points(1)
    m.mp_valid[rid] = True
    M = cfg.caps.local_points
    match = np.full(M, -1, np.int32)
    match[0], match[1] = 5, 6
    inl = np.zeros(M, bool)
    inl[:2] = True
    uv, aux, lvl, _, desc, okm, depth, _ = _kf_args(N)
    fd = SimpleNamespace(**{k: p.to_dev(v) for k, v in dict(
        uv=uv, ur=aux, depth=depth, xyz_c=np.zeros((N, 3), np.float32), level=lvl,
        angle=aux, desc=desc, valid=okm).items()})
    out = SimpleNamespace(fd=fd, fl=None, match_point=p.to_dev(match), inlier=p.to_dev(inl))
    hf = p.HostFrame(frame_id=1, timestamp=0.0, T_cw=np.eye(4, dtype=np.float32))
    s._materialize_host_frame(hf, out, snap_ids)
    return ids, rid, hf.feat_mp


def test_materialize_masks_recycled_slot():
    (ij, rj, fj), (it, rt, ft) = _materialize(PKGS["jax"]), _materialize(PKGS["port"])
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ft, fj)
    assert rt[0] == it[0]
    assert ft[5] == -1 and ft[6] == it[1]


def _fuse(p):
    m = p.Map(_mini_cfg(p))
    N = m.kf_uv.shape[1]
    k0 = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), *_kf_args(N))
    k1 = m.add_keyframe(1, 0.1, np.eye(4, dtype=np.float32), *_kf_args(N))
    xyz = np.asarray([[0, 0, 2.0]], np.float32)
    a = int(m.create_points_from_depth(k0, np.asarray([0]), xyz)[0])
    b = int(m.create_points_from_depth(k1, np.asarray([7]), xyz)[0])
    m.add_point_obs(k1, [3], [a])
    n = p.lm._apply_fuse(m, k1, np.asarray([a, a]), np.asarray([7, 9]))
    return n, a, b, m.kf_feat_mp[: m.n_kf].copy(), m.mp_n_obs.copy(), m.mp_valid.copy()


def test_apply_fuse_skips_already_observed():
    j, t = _fuse(PKGS["jax"]), _fuse(PKGS["port"])
    assert t[:3] == j[:3]
    for a, b in zip(j[3:], t[3:]):
        np.testing.assert_array_equal(a, b)
    n, a, _, feat_mp, n_obs, _ = t
    assert int((feat_mp[1] == a).sum()) <= 2  # feat 3 and feat 7, never feat 9
    assert feat_mp[1, 9] == -1
    assert n_obs[a] == int((feat_mp == a).sum())


def _alloc(p):
    """Fill the point and line pools, give them tied and untied values, and
    allocate past capacity."""
    m = p.Map(_mini_cfg(p))
    rng = np.random.default_rng(5)
    P = m.mp_valid.shape[0]
    a = m.alloc_map_points(P)
    m.mp_valid[a] = True
    m.mp_n_obs[a] = rng.integers(1, 4, P)
    m.mp_found[a] = rng.integers(0, 3, P)
    m.mp_visible[a] = rng.integers(1, 3, P)
    ids = m.alloc_map_points(9)
    L = m.ml_valid.shape[0]
    N = m.kf_uv.shape[1]
    kf = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), *_kf_args(N))
    pos = rng.uniform(-1, 1, (L, 6)).astype(np.float32) + np.float32([0, 0, 3, 0, 0, 3])
    all_lines = m.create_map_lines(kf, np.arange(L), pos, np.zeros((L, 40), np.float32))
    m.ml_n_obs[:] = rng.integers(1, 3, L)
    lines = m.create_map_lines(kf, np.arange(5), pos[:5], np.zeros((5, 40), np.float32))
    return (a, ids, m.mp_valid.copy(), m.mp_gen.copy(), all_lines, lines,
            m.ml_valid.copy(), m.ml_gen.copy())


def test_alloc_evicts_the_same_lowest_value_slots():
    j, t = _alloc(PKGS["jax"]), _alloc(PKGS["port"])
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    a, ids, mp_valid, _, all_lines, lines, ml_valid, _ = t
    assert len(ids) == 9 and mp_valid.sum() == len(a) - 9
    assert len(set(all_lines.tolist())) == ml_valid.shape[0]
    assert len(lines) == 5


def _many_kfs(p):
    """tests/test_local_mapping.py:253 at the small capacity: K + 40
    keyframes of one 60-point scene, culled as the table fills."""
    cfg = _mini_cfg(p)
    m = p.Map(cfg)
    K = cfg.caps.max_keyframes
    rng = np.random.default_rng(7)
    X_w = rng.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 2.8], (60, 3)).astype(np.float32)
    N = m.kf_uv.shape[1]

    def add(T, i, feat_mp):
        Xc = X_w @ T[:3, :3].T + T[:3, 3]
        uv = np.zeros((N, 2), np.float32)
        uv[:60] = np.stack([cfg.camera.fx * Xc[:, 0] / Xc[:, 2] + cfg.camera.cx,
                            cfg.camera.fy * Xc[:, 1] / Xc[:, 2] + cfg.camera.cy], -1)
        depth = np.zeros(N, np.float32)
        depth[:60] = Xc[:, 2]
        valid = np.zeros(N, bool)
        valid[:60] = True
        fmp = np.full(N, -1, np.int32)
        fmp[:60] = feat_mp
        z = np.zeros(N, np.float32)
        return m.add_keyframe(i, float(i), T, uv, z - 1, np.zeros(N, np.int32), z,
                              np.zeros((N, 32), np.uint8), valid, depth, fmp)

    def pose(x):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x
        return T

    k0 = add(pose(0.0), 0, -1)
    ids = m.create_points_from_depth(k0, np.arange(60), X_w)
    victims = []
    for i in range(1, K + 40):
        k = add(pose(0.01 * (i % 7)), i, -1)
        m.add_point_obs(k, np.arange(60), ids)
        m._update_covisibility(k)
        if m.n_kf > K - 4:
            v = p.lm.cull_keyframes(m, k, cfg, protect={k})
            for kv in v:
                m.erase_keyframe(kv)
            victims.append(list(map(int, v)))
    return victims, m.kf_valid.copy(), m.kf_frame_id.copy(), m.n_kf


def test_capacity_survives_many_keyframes():
    j, t = _many_kfs(PKGS["jax"]), _many_kfs(PKGS["port"])
    assert t[0] == j[0]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])
    assert t[3] == j[3] <= MINI_CAPS["max_keyframes"]
    assert t[1].sum() <= MINI_CAPS["max_keyframes"]
    assert sum(len(v) for v in t[0]) >= 40


# ---------------------------------------------------------------------------
# The system run on rendered frames


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _port_from_jax(js, tc):
    """A port system in the JAX system's (flushed) state."""
    ts = t_sys.SlamSystem(tc, device="cpu")
    ts.map = interop.map_state_from_arrays(tc, vars(js.map))
    ts.last = t_sys.HostFrame(frame_id=js.last.frame_id, timestamp=js.last.timestamp,
                              T_cw=js.last.T_cw.copy())
    ts.ref_kf, ts.frame_id, ts.state = js.ref_kf, js.frame_id, t_sys.TrackState[js.state.name]
    ts.velocity = js.velocity.copy()
    ts.trajectory = [(t, T.copy(), r) for t, T, r in js.trajectory]
    ts.stats = dict(js.stats)
    return ts


def _decisions(s):
    return (s.state.name, s.stats.get("kf_inserted", 0), s.stats.get("kf_culled", 0),
            s.stats.get("kf_evicted", 0), s.stats.get("ba_runs", 0), s.ref_kf,
            s.map.n_kf, tuple(np.flatnonzero(s.map.kf_valid)))


@pytest.fixture(scope="module")
def system_runs():
    kw = dict(use_lines=False, use_bow=False, use_loop_closing=False)
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500),
              caps=JCaps(max_keyframes=6, local_points=1024), **kw)
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500),
              caps=TCaps(max_keyframes=6, local_points=1024), **kw)
    grays, depths, _ = render_sequence(
        jc.camera, poses=loop_trajectory(500, loops=2.0)[:N_FRAMES],
        room=ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=9))
    js, ts = j_sys.SlamSystem(jc), t_sys.SlamSystem(tc, device="cpu")
    separate, shared = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        for i in range(N_FRAMES):
            if i == N_SEPARATE:
                # From here both continue from one copy of the JAX state.
                js.flush()
                js._invalidate_snapshot()
                ts.flush()
                end_separate = (_decisions(js), _decisions(ts), js.map.kf_frame_id.copy(),
                                ts.map.kf_frame_id.copy())
                ts = _port_from_jax(js, tc)
            Tj = js.track_rgbd(grays[i], depths[i], i / 30.0)
            Tt = ts.track_rgbd(grays[i], depths[i], i / 30.0)
            (separate if i < N_SEPARATE else shared).append(
                (_decisions(js), _decisions(ts),
                 float(np.linalg.norm(_centre(Tj) - _centre(Tt)))))
        js.flush()
    jax.clear_caches()
    ts.flush()
    return dict(separate=separate, end_separate=end_separate, shared=shared,
                end_shared=(_decisions(js), _decisions(ts), js.map.kf_frame_id.copy(),
                            ts.map.kf_frame_id.copy()))


def test_system_run_evicts_culls_and_reuses_slots_like_jax(system_runs):
    """Tracked separately: every frame the same state, keyframe slots and
    counts; eviction, culling and slot reuse all fired."""
    for dj, dt, _ in system_runs["separate"]:
        assert dt == dj
    dj, dt, fj, ft = system_runs["end_separate"]
    assert dt == dj
    np.testing.assert_array_equal(ft, fj)
    state, inserted, culled, evicted, _, _, n_kf, _ = dt
    assert state == "OK" and evicted > 0 and culled > 0
    assert inserted > n_kf  # slots were reused


def test_system_run_centres_within_1cm(system_runs):
    worst = max(r[2] for r in system_runs["separate"])
    assert worst <= 0.01, [round(r[2], 5) for r in system_runs["separate"]]


def test_system_run_from_one_state_decides_like_jax(system_runs):
    """From one copy of the JAX state both packages take the same decision
    on every later frame, the evictions, culls and slot reuse among them."""
    for dj, dt, _ in system_runs["shared"]:
        assert dt == dj
    dj, dt, fj, ft = system_runs["end_shared"]
    assert dt == dj
    np.testing.assert_array_equal(ft, fj)
    assert dt[3] > system_runs["end_separate"][1][3]  # more evictions
    worst = max(r[2] for r in system_runs["shared"])
    assert worst <= 0.01, [round(r[2], 5) for r in system_runs["shared"]]
