"""Where the port and the JAX package part on the 200-frame ATE ladder.

The circuit of ``scripts/run_ate_ladder.py`` (``loop_trajectory(200,
loops=1.0)`` in ``ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3)``,
640x480, BASELINE config 1), JAX pinned as the slices pin it
(``lax.top_k``, ``PSLAM_BA_ONEHOT=0``, fresh jit caches), the port on the
CPU on one thread. Run over all 200 frames the two read 7.60 and 4.21 cm.

Tracked separately, both packages take the same decisions on frames 0-7
(states, keyframe insertions and culls, local BAs, reference keyframe,
live keyframes), with camera centres within 1.76 mm. They part at frame 8,
in keyframe culling: keyframe 5's close map points are redundantly observed
357 times of 396 in JAX (gate 0.9 x 396 = 356.4: culled) and 364 of 405 in
the port (gate 364.5: kept). Each count is within one map point of the 90%
gate, and the counts themselves differ by the f32 drift both packages
carry from frame 0 (the first frame's features already differ by f32
rounding, within the bounds of tests/test_torch_frontend.py).

So the split is a count at a gate, not the port's logic. This module holds
it the way tests/test_torch_capacity.py holds the capacity run:
- frames 0-7 tracked separately: the same decisions every frame, centres
  within 1 cm (the slices' bar);
- frame 8 tracked separately: every keyframe whose culling verdict differs
  between the packages has a redundancy count within one map point of the
  90% gate in both (counted by this module's restatement of
  ``cull_keyframes``, held to give that function's own victims);
- frames 9-10 from one copy of JAX's state after frame 8 (flushed, the
  snapshot dropped; the port's state through ``interop``): the same
  decisions every frame, centres within 1 cm.
"""

import jax
import numpy as np
import pytest
import torch

import pslam_tpu.pipeline.local_mapping as j_lm
import pslam_tpu_torch.pipeline.local_mapping as t_lm
import pslam_tpu_torch.pipeline.system as t_sys
from pslam_tpu.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.utils.config import SlamConfig as TCfg

CFG_KW = dict(use_lines=False, use_bow=False, use_loop_closing=False)
SPLIT = 8  # the first frame whose decisions differ, tracked separately
N_FRAMES = 11


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes. The split frame and its counts above
    are those of one thread (torch's CPU sums split by thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redundancy(m, kf, th_depth, protect):
    """{candidate keyframe: (redundantly observed close points, close
    points)} of one ``cull_keyframes(m, kf, ...)`` call: the count that
    function compares with 90% of the close points."""
    out = {}
    n = m.n_kf
    for k in m.covisible_kfs(kf):
        k = int(k)
        if k in set(protect) | {0, kf}:
            continue
        row = m.kf_feat_mp[k]
        feat = np.flatnonzero(row >= 0)
        depth_k = m.kf_feat_depth[k, feat]
        feat = feat[(depth_k > 0) & (depth_k < th_depth)]
        feat = feat[m.mp_valid[row[feat]]]
        if len(feat) == 0:
            continue
        ids = row[feat]
        lvl_req = np.zeros(m.mp_valid.shape[0], np.int32)
        lvl_req[ids] = m.kf_level[k, feat] + 1
        in_sel = np.zeros(m.mp_valid.shape[0], bool)
        in_sel[ids] = True
        obs = m.kf_feat_mp[:n]
        hit = (obs >= 0) & in_sel[np.maximum(obs, 0)] & m.kf_valid[:n, None]
        hit[k] = False
        kk, ff = np.nonzero(hit)
        oid = obs[kk, ff]
        cnt = np.bincount(oid[m.kf_level[kk, ff] <= lvl_req[oid]],
                          minlength=m.mp_valid.shape[0])
        out[k] = (int((cnt[ids] >= 3).sum()), len(feat))
    return out


def _recording(module, log):
    """``module.cull_keyframes`` that also logs each call's redundancy
    counts, after holding them to the function's own victims."""
    orig = module.cull_keyframes

    def cull(m, kf, cfg, protect=()):
        counts = _redundancy(m, kf, cfg.th_depth, protect)
        victims = orig(m, kf, cfg, protect=protect)
        assert sorted(victims) == sorted(k for k, (c, n) in counts.items() if c > 0.9 * n)
        log.append(counts)
        return victims
    return cull


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _decisions(s):
    return (s.state.name, s.stats.get("kf_inserted", 0), s.stats.get("kf_culled", 0),
            s.stats.get("ba_runs", 0), s.ref_kf, s.map.n_kf,
            tuple(np.flatnonzero(s.map.kf_valid)))


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


@pytest.fixture(scope="module")
def ladder_runs():
    jc, tc = JCfg(**CFG_KW), TCfg(**CFG_KW)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3)
    grays, depths, _ = render_sequence(
        jc.camera, poses=loop_trajectory(200, loops=1.0)[:N_FRAMES], room=room)
    js, ts = JSys(jc), t_sys.SlamSystem(tc, device="cpu")
    culls = {"jax": [], "port": []}
    separate, shared = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        mp.setattr(j_lm, "cull_keyframes", _recording(j_lm, culls["jax"]))
        mp.setattr(t_lm, "cull_keyframes", _recording(t_lm, culls["port"]))
        jax.clear_caches()
        for i in range(N_FRAMES):
            if i == SPLIT + 1:
                # From here both continue from one copy of the JAX state.
                js.flush()
                js._invalidate_snapshot()
                ts = _port_from_jax(js, tc)
            n_cull = len(culls["jax"]), len(culls["port"])
            Tj = js.track_rgbd(grays[i], depths[i], i / 30.0)
            Tt = ts.track_rgbd(grays[i], depths[i], i / 30.0)
            (separate if i <= SPLIT else shared).append(dict(
                dj=_decisions(js), dt=_decisions(ts),
                dc=float(np.linalg.norm(_centre(Tj) - _centre(Tt))),
                cj=culls["jax"][n_cull[0]:], ct=culls["port"][n_cull[1]:]))
        js.flush()
    jax.clear_caches()
    ts.flush()
    return dict(separate=separate, shared=shared)


def test_same_decisions_up_to_the_split(ladder_runs):
    rows = ladder_runs["separate"][:SPLIT]
    for i, r in enumerate(rows):
        assert r["dt"] == r["dj"], i
    assert rows[-1]["dj"][1] == SPLIT and rows[-1]["dj"][2] > 0  # insertions, a cull
    worst = max(r["dc"] for r in rows)
    assert worst <= 0.01, [round(r["dc"], 5) for r in rows]


def test_split_frame_culls_within_one_point_of_the_gate(ladder_runs):
    """At the split frame every culling verdict the packages disagree on is
    one a count within one map point of 90% decides, in both packages."""
    r = ladder_runs["separate"][SPLIT]
    assert len(r["cj"]) == len(r["ct"]) == 1  # one keyframe inserted, one cull call
    cj, ct = r["cj"][0], r["ct"][0]
    assert cj.keys() == ct.keys()
    for k in cj:
        if (cj[k][0] > 0.9 * cj[k][1]) != (ct[k][0] > 0.9 * ct[k][1]):
            for c, n in (cj[k], ct[k]):
                assert abs(c - 0.9 * n) <= 1.0, (k, cj[k], ct[k])


def test_from_one_state_decides_like_jax(ladder_runs):
    rows = ladder_runs["shared"]
    assert len(rows) == N_FRAMES - SPLIT - 1
    for r in rows:
        assert r["dt"] == r["dj"]
        assert len(r["cj"]) == len(r["ct"])
    worst = max(r["dc"] for r in rows)
    assert worst <= 0.01, [round(r["dc"], 5) for r in rows]
