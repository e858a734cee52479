"""Loop closing on the hand-built drifted world of tests/test_loop_closing.py:
the JAX ``LoopCloser`` against the port's, both started from one map and
one keyframe database (CPU).

The world is built once by the JAX package; the port gets copies of its map
(``interop.map_state_from_arrays``) and database
(``interop.keyframe_db_from_numpy``). One port copy takes the JAX package's
RANSAC draws (its PRNG keys from the same integer seeds), so both solve from
the same hypotheses; a second copy takes the port's own draws. JAX's BA
runs its scatter assembly (``PSLAM_BA_ONEHOT=0``), the one the port
implements, with fresh jit caches.

Bars, with the JAX draws: the same closing keyframe and the same ``stats``
(integers exact, ``blend_alpha`` within 1e-3), keyframe poses within 1e-3,
map points within 1e-3 m and the same valid set. With either draws: the
bars of tests/test_loop_closing.py (the closing keyframe within 0.03 of its
true pose, the fused points' median distance to cloud A below 0.05 m).
``assemble_global_ba`` builds identical arrays."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.geometry import se3_exp
from pslam_tpu.geometry.camera import project
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline import global_ba as jgba
from pslam_tpu.pipeline.system import SlamSystem as JSys
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import global_ba as tgba
from pslam_tpu_torch.pipeline import loop_closing as tlc
from pslam_tpu_torch.pipeline.system import SlamSystem as TSys
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg

CAPS = dict(max_keyframes=32, max_map_points=4096, local_points=512,
            gba_cams=32, gba_free=16, gba_points=1024, gba_edges=4096)
CFG_KW = dict(use_lines=False, bow_k=8, bow_levels=3)


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


def _build_jax_world():
    """tests/test_loop_closing.py's drifted_world: KFs 0-2 see cloud A, 3-5
    B, 6-8 C, 9-13 A again through drifted duplicate points and poses."""
    cfg = JCfg(orb=JOrb(n_features=256), caps=JCaps(**CAPS), **CFG_KW)
    slam = JSys(cfg)
    m = slam.map
    rng = np.random.default_rng(0)
    cam = cfg.camera
    N = cfg.orb.capacity
    P_CLOUD = 150
    clouds = [rng.uniform([-1.5, -1.0, 2.0 + 2.5 * ci], [1.5, 1.0, 4.0 + 2.5 * ci],
                          (P_CLOUD, 3)).astype(np.float32) for ci in range(3)]
    descs = [rng.integers(0, 256, (P_CLOUD, 32), dtype=np.uint8) for _ in range(3)]
    segments = [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0]
    poses_true = []
    for k, ci in enumerate(segments):
        off = rng.normal(0, 0.08, 3).astype(np.float32)
        xi = np.r_[rng.normal(0, 0.02, 3),
                   [0.15 * (k % 3) + off[0], off[1], off[2]]].astype(np.float32)
        T = np.array(se3_exp(jnp.asarray(xi)))
        T[2, 3] -= 2.5 * ci
        poses_true.append(T.astype(np.float32))
    W = np.array(se3_exp(jnp.asarray(np.array([0.02, -0.03, 0.025, 0.25, -0.18, 0.22],
                                                np.float32))))
    W_inv = np.linalg.inv(W)
    cloud_ids = {}
    for k, ci in enumerate(segments):
        revisit = k >= 9
        X_w = clouds[ci]
        T_cw = poses_true[k]
        if revisit:
            X_w = (X_w @ W[:3, :3].T) + W[:3, 3]
            T_cw = (poses_true[k] @ W_inv).astype(np.float32)
        Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = np.asarray(project(cam, jnp.asarray(Xc))).astype(np.float32)
        z = Xc[:, 2]
        ok = (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < cam.height)
        uv_f = np.zeros((N, 2), np.float32)
        ur_f = np.full(N, -1.0, np.float32)
        depth_f = np.zeros(N, np.float32)
        desc_f = np.zeros((N, 32), np.uint8)
        valid_f = np.zeros(N, bool)
        nsel = min(ok.sum(), N)
        sel = np.flatnonzero(ok)[:nsel]
        uv_f[:nsel] = uv[sel]
        depth_f[:nsel] = z[sel]
        ur_f[:nsel] = uv[sel, 0] - cam.bf / z[sel]
        desc_f[:nsel] = descs[ci][sel]
        valid_f[:nsel] = True
        kf = m.add_keyframe(k, float(k), T_cw, uv_f, ur_f, np.zeros(N, np.int32),
                            np.zeros(N, np.float32), desc_f, valid_f, depth_f,
                            np.full(N, -1, np.int32))
        key = (ci, revisit)
        if key not in cloud_ids:
            ids = m.create_points_from_depth(kf, np.arange(nsel), X_w[sel].astype(np.float32))
            table = np.full(P_CLOUD, -1, np.int32)
            table[sel] = ids
            cloud_ids[key] = table
        else:
            table = cloud_ids[key]
            have = table[sel] >= 0
            m.kf_feat_mp[kf, np.arange(nsel)[have]] = table[sel][have]
            np.add.at(m.mp_n_obs, table[sel][have], 1)
            m._update_covisibility(kf)
        slam.kf_db.add(kf, *slam.kf_db.compute_bow(desc_f, valid_f))
    return slam, poses_true


def _port_copy(js):
    tc = TCfg(orb=TOrb(n_features=256), caps=TCaps(**CAPS), **CFG_KW)
    ts = TSys(tc, device="cpu", vocab=interop.vocabulary_from_numpy(js.kf_db.vocab, device="cpu"))
    ts.map = interop.map_state_from_arrays(tc, vars(js.map))
    ts.kf_db = interop.keyframe_db_from_numpy(js.kf_db, ts.kf_db.vocab)
    return ts


def _jax_priorities(seed, n_trials, n, device):
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(seed), (n_trials, n)))).to(device)


def _close(slam):
    for kf in (9, 10, 11, 12, 13):
        if slam.loop_closer.on_new_keyframe(kf):
            return kf
    return None


@pytest.fixture(scope="module")
def world():
    with pytest.MonkeyPatch.context() as mp:
        # JAX's local BA (and so its global BA) defaults to a bf16 one-hot
        # assembly; the port implements its scatter assembly.
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        js, poses_true = _build_jax_world()
        t_jax_draws, t_own_draws = _port_copy(js), _port_copy(js)
        probe = _port_copy(js)  # left untouched by any loop
        gba = (jgba.assemble_global_ba(js.map, js.cfg),
               tgba.assemble_global_ba(probe.map, probe.cfg, "cpu"))
        j_gba_map = copy.deepcopy(js.map)
        jgba.run_global_ba(j_gba_map, js.cfg)
        tgba.run_global_ba(probe.map, probe.cfg, "cpu")

        closed = {"jax": _close(js)}
        with pytest.MonkeyPatch.context() as draws:
            draws.setattr(tlc, "ransac_priorities", _jax_priorities)
            closed["port_jax_draws"] = _close(t_jax_draws)
        closed["port_own_draws"] = _close(t_own_draws)
    jax.clear_caches()
    return dict(js=js, tj=t_jax_draws, to=t_own_draws, probe=probe, j_gba_map=j_gba_map,
                poses_true=poses_true, closed=closed, gba=gba)


def test_same_closure_and_stats_with_the_jax_draws(world):
    js, tj = world["js"], world["tj"]
    assert world["closed"]["jax"] is not None
    assert world["closed"]["port_jax_draws"] == world["closed"]["jax"]
    sj, st = js.loop_closer.stats, tj.loop_closer.stats
    assert sj.keys() == st.keys()
    for k in sj:
        if isinstance(sj[k], float):
            assert abs(st[k] - sj[k]) < 1e-3, k
        else:
            assert st[k] == sj[k], k
    assert st["closed"] == 1
    assert tj.loop_closer.loop_edges == js.loop_closer.loop_edges


def test_poses_and_points_agree_with_the_jax_draws(world):
    mj, mt = world["js"].map, world["tj"].map
    K = mj.n_kf
    assert mt.n_kf == K
    np.testing.assert_allclose(mt.kf_pose[:K], mj.kf_pose[:K], atol=1e-3)
    np.testing.assert_array_equal(mt.mp_valid, mj.mp_valid)
    np.testing.assert_array_equal(mt.kf_feat_mp[:K], mj.kf_feat_mp[:K])
    v = mj.mp_valid
    np.testing.assert_allclose(mt.mp_pos[v], mj.mp_pos[v], atol=1e-3)


@pytest.mark.parametrize("which", ["tj", "to"], ids=["jax_draws", "own_draws"])
def test_loop_corrected_like_the_reference(world, which):
    """The bars of tests/test_loop_closing.py on the port's map."""
    m = world[which].map
    closed_at = world["closed"]["port_jax_draws" if which == "tj" else "port_own_draws"]
    assert closed_at == world["closed"]["jax"]
    assert world[which].loop_closer.stats["closed"] == 1
    err = np.abs(m.kf_pose[closed_at] - world["poses_true"][closed_at]).max()
    assert err < 0.03, err
    mp = m.kf_feat_mp[closed_at]
    pos = m.mp_pos[mp[mp >= 0]]
    orig = m.mp_pos[m.mp_valid & (m.mp_first_kf == 0)]
    d = np.linalg.norm(pos[:, None, :] - orig[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 0.05, np.median(d)


def test_no_loop_on_distinct_views(world):
    probe = world["probe"]
    lc = tlc.LoopCloser(probe)
    assert lc.detect_loop(4) == [] or lc.compute_sim3(4, lc.detect_loop(4)) is None


def test_assemble_global_ba_identical_arrays(world):
    (pj, cj, ptj, efj, nj), (pt, ct, ptt, eft, nt) = world["gba"]
    assert ct == cj and nt == nj
    np.testing.assert_array_equal(ptt, ptj)
    np.testing.assert_array_equal(eft, efj)
    for f in pj._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), f)


def test_global_ba_matches_jax(world):
    mj, mt = world["j_gba_map"], world["probe"].map
    K = mj.n_kf
    np.testing.assert_allclose(mt.kf_pose[:K], mj.kf_pose[:K], atol=1e-3)
    np.testing.assert_array_equal(mt.kf_feat_mp[:K], mj.kf_feat_mp[:K])
    v = mj.mp_valid
    np.testing.assert_allclose(mt.mp_pos[v], mj.mp_pos[v], atol=1e-3)


def test_system_config_4_constructs():
    """The default config (BoW + loop closing) builds its database and loop
    closer."""
    tc = TCfg(orb=TOrb(n_features=256), caps=TCaps(**CAPS), **CFG_KW)
    ts = TSys(dataclasses.replace(tc, use_loop_closing=False), device="cpu")
    assert ts.kf_db is not None and ts.loop_closer is None
    ts = TSys(tc, device="cpu")
    assert ts.kf_db.vocab.n_words == 8**3 and isinstance(ts.loop_closer, tlc.LoopCloser)
