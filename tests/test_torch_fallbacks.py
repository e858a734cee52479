"""The tracking fallbacks and the evaluation apps: the JAX package against
the port on the same numpy inputs.

- The un-windowed reference-keyframe fallback (``SlamSystem._fallback_ref_kf``,
  TrackReferenceKeyFrame) on tests/test_pipeline.py:102's scene: config 1,
  ``BoxRoom(seed=0)``, four smooth frames then a 0.6 m lateral jump, here at
  320x240 (500 ORB features, a 1024-point local map). The matcher's windows
  grow with the octave (x1.2 a level), so with the default 15 and 30 px
  windows the wide retry recovers the jump and the fallback never runs (in
  the port at 640x480 too, and at 320x240 up to a 1.5 m jump); here the
  windows are 3 and 5 px, so both attempts fail and the fallback carries the
  frame. Bars: the fallback runs on the jump frame in both packages and
  recovers; the same state and keyframes, the final pose within 1e-3 of
  JAX's (each entry), and within 5 cm of the truth (the JAX test's bar).
- The depth-sparse relocalization branch (tests/test_round4.py:54): frame 1
  of ``render_sequence(n_frames=2, seed=5)`` at 640x480 with depth only in one
  8-px column stripe, so fewer than 12 matches carry depth and the uv-only
  PnP RANSAC carries the solve. (At 320x240 that RANSAC's best hypothesis
  has 2-4 supporters and the pose solve alone rescues it, so the test keeps
  the JAX test's size.) The port is fed JAX's PnP samples
  (``jax.random.split(PRNGKey(1))[1]`` split 256 ways, ``categorical`` over
  the valid matches, as ``pslam_tpu/solver/pnp.py`` draws them), in the way
  tests/test_torch_relocalization.py feeds its draws. Bars: the same matches,
  the same branch, the same inlier mask and count after the pose solve, the
  RANSAC support within one edge (each package's 12x12 DLT eigh rounds its
  own way at the 4 px gate), the pose within 1e-4 (each entry), and within
  10 cm of the truth (the JAX test's bar).
- The apps against the JAX scripts: ``run_one`` of ``scripts/run_lowtex.py``
  (imported with importlib) and ``pslam_tpu_torch.apps.lowtex.run_one`` at
  320x240, every ladder config, with the small camera,
  ``OrbConfig(n_features=500)`` and ``LineConfig(tile=8)`` given through
  ``kw``, on the first 6 frames of ``lowtex``'s
  ``LowTextureRoom(seed=5)`` circuit. Bars: the same ``kfs``, ``relocs``,
  ``resets`` and ``lost``, ATE and online ATE within 1 cm. Neither package
  initializes in this scene, at 640x480 or here: its frames hold 29-101
  features with depth, and the RGB-D initialization needs 500 (250 at 500
  features), so every row has no keyframe.

JAX is pinned as in the slice tests (``lax.top_k``, ``PSLAM_BA_ONEHOT=0``),
with fresh jit caches.
"""

import importlib
import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pslam_tpu.pipeline.system as j_sys
import pslam_tpu_torch.pipeline.system as t_sys
from pslam_tpu.geometry import Camera as JCam
from pslam_tpu.io.synthetic import BoxRoom, LowTextureRoom, loop_trajectory, render_sequence
from pslam_tpu.ops.lines import LineConfig as JLines
from pslam_tpu.ops.orb import OrbConfig as JOrb
from pslam_tpu.pipeline.frame_ops import make_frame as j_make_frame
from pslam_tpu.pipeline.relocalization import reloc_bow_step as j_reloc_step
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg, \
    TrackingConfig as JTrack
from pslam_tpu_torch.apps import lowtex
from pslam_tpu_torch.geometry import Camera as TCam
from pslam_tpu_torch.ops.lines import LineConfig as TLines
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb
from pslam_tpu_torch.pipeline import relocalization as treloc
from pslam_tpu_torch.pipeline.frame_ops import make_frame as t_make_frame
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg, \
    TrackingConfig as TTrack
from pslam_tpu_torch.utils.metrics import trajectory_positions

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
APP_FRAMES = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes, and torch's default of a thread a
    core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# The reference-keyframe fallback


def _jump_pose(C):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = -np.asarray(C, np.float32)
    return T


JUMP_CENTRES = [[0, 0, 0], [0.02, 0, 0.02], [0.04, 0, 0.04], [0.06, 0, 0.06],
                [0.66, 0, 0.06]]


def _track_jump(slam, frames, mp, sys_cls):
    calls = []
    fallback = sys_cls._fallback_ref_kf

    def recorded(self, *a, **kw):
        out = fallback(self, *a, **kw)
        calls.append((self.frame_id, out is not None))
        return out

    mp.setattr(sys_cls, "_fallback_ref_kf", recorded)
    for i, (g, d) in enumerate(frames):
        T = slam.track_rgbd(g, d, i / 30.0)
    return T, calls


@pytest.fixture(scope="module")
def jump(pinned):
    kw = dict(use_lines=False, use_bow=False, use_loop_closing=False)
    windows = dict(motion_match_radius=3.0, motion_match_radius_wide=5.0)
    jc = JCfg(camera=JCam(**CAM_KW), orb=JOrb(n_features=500),
              caps=JCaps(local_points=1024), tracking=JTrack(**windows), **kw)
    tc = TCfg(camera=TCam(**CAM_KW), orb=TOrb(n_features=500),
              caps=TCaps(local_points=1024), tracking=TTrack(**windows), **kw)
    cam = jc.camera
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    room = BoxRoom(seed=0)
    frames = [room.render(K, _jump_pose(C).astype(np.float64), cam.width, cam.height)
              for C in JUMP_CENTRES]
    js, ts = j_sys.SlamSystem(jc), t_sys.SlamSystem(tc, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        Tj, cj = _track_jump(js, frames, mp, j_sys.SlamSystem)
        Tt, ct = _track_jump(ts, frames, mp, t_sys.SlamSystem)
    return js, ts, Tj, Tt, cj, ct


def test_ref_kf_fallback_recovers_the_jump_like_jax(jump):
    js, ts, Tj, Tt, cj, ct = jump
    last = len(JUMP_CENTRES) - 1
    assert ct == cj and (last, True) in ct  # ran on the jump frame and found the pose
    assert ts.state.name == js.state.name == "OK"
    assert ts.stats["kf_inserted"] == js.stats["kf_inserted"]
    np.testing.assert_array_equal(ts.map.kf_frame_id[: ts.map.n_kf],
                                  js.map.kf_frame_id[: js.map.n_kf])
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-3)
    C = -Tt[:3, :3].T @ Tt[:3, 3]
    assert np.linalg.norm(C - np.asarray(JUMP_CENTRES[-1])) < 0.05


# ---------------------------------------------------------------------------
# The depth-sparse PnP branch of relocalization


@pytest.fixture(scope="module")
def depth_sparse(pinned):
    cfg = JCfg()
    cam, orb = cfg.camera, cfg.orb
    tcfg = TCfg()
    grays, depths, poses = render_sequence(cam, n_frames=2, seed=5)
    dep = depths[1].copy()
    H, W = dep.shape
    dep[np.broadcast_to(np.arange(W)[None, :] // 8 != 20, (H, W))] = 0.0

    fj_full = j_make_frame(jnp.asarray(grays[0]), jnp.asarray(depths[0]), cam, orb)
    fj_holes = j_make_frame(jnp.asarray(grays[1]), jnp.asarray(dep), cam, orb)
    ft_full = t_make_frame(_t(grays[0]), _t(depths[0]), tcfg.camera, tcfg.orb)
    ft_holes = t_make_frame(_t(grays[1]), _t(dep), tcfg.camera, tcfg.orb)

    # The keyframe side: frame 0's features in the world through its true pose.
    T0_inv = np.linalg.inv(poses[0])
    X_w = (np.asarray(fj_full.xyz_c) @ T0_inv[:3, :3].T + T0_inv[:3, 3]).astype(np.float32)
    has = np.asarray((fj_full.depth > 0) & fj_full.valid)
    sigma2 = np.asarray([(orb.scale**l) ** 2 for l in range(orb.levels)], np.float32)
    nodes = np.zeros(len(has), np.int32)  # one BoW bucket
    rj = j_reloc_step(cam, jnp.asarray(X_w), jnp.asarray(has), fj_full.desc, fj_full.angle,
                      jnp.asarray(nodes), fj_holes, jnp.asarray(nodes), jnp.asarray(sigma2),
                      jax.random.PRNGKey(1))

    drawn = []

    def jax_samples(u, valid):
        """pslam_tpu.solver.pnp's hypotheses: key2 of PRNGKey(1), split 256
        ways, N_SAMPLE categorical draws over the valid matches each."""
        key2 = jax.random.split(jax.random.PRNGKey(1))[1]
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(u.shape[1],)))(
            jax.random.split(key2, u.shape[0]))
        drawn.append(u.shape)
        return _t(np.asarray(idx)).to(torch.int64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treloc, "pnp_sample_indices", jax_samples)
        rt = treloc.reloc_bow_step(
            tcfg.camera, _t(X_w), _t(has), ft_full.desc, ft_full.angle,
            _t(nodes.astype(np.int64)), ft_holes, _t(nodes.astype(np.int64)), _t(sigma2),
            seed=1)
    n_depth = [int(((np.asarray(r.match_idx) >= 0)
                    & (np.asarray(f.depth)[np.maximum(np.asarray(r.match_idx), 0)] > 0)).sum())
               for r, f in ((rj, fj_holes), (rt, ft_holes))]
    return rj, rt, n_depth, drawn, poses[1]


def test_depth_sparse_pnp_branch_like_jax(depth_sparse):
    rj, rt, n_depth, drawn, T1 = depth_sparse
    assert drawn == [(256, 6)]  # the port took the uv-only PnP branch once
    assert n_depth[1] == n_depth[0] < 12  # ... as JAX did: depth-backed matches scarce
    np.testing.assert_array_equal(rt.match_idx.numpy(), np.asarray(rj.match_idx))
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 30
    # The RANSAC support may differ by one edge at the 4 px gate: each
    # package's DLT (a 12x12 eigh) rounds the winning hypothesis its own way
    # (measured 11 against 10); the refined pose below is held to 1e-4.
    assert abs(int(rt.n_ransac) - int(rj.n_ransac)) <= 1
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-4)
    assert np.linalg.norm(rt.T_cw.numpy()[:3, 3] - T1[:3, 3]) < 0.10


# ---------------------------------------------------------------------------
# The apps against the scripts


def _script_run_one():
    path = Path(__file__).resolve().parents[1] / "scripts" / "run_lowtex.py"
    spec = importlib.util.spec_from_file_location("run_lowtex_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_one


@pytest.fixture(scope="module")
def app_rows(pinned):
    run_one = _script_run_one()
    grays, depths, poses_gt = render_sequence(
        JCam(**CAM_KW), poses=loop_trajectory(120, loops=1.0)[:APP_FRAMES],
        room=LowTextureRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=5))
    out = {}
    for name, kw in lowtex.LADDER:
        jkw = dict(kw, camera=JCam(**CAM_KW), orb=JOrb(n_features=500), lines=JLines(tile=8))
        tkw = dict(kw, camera=TCam(**CAM_KW), orb=TOrb(n_features=500), lines=TLines(tile=8))
        with redirect_stdout(io.StringIO()):
            rj = run_one(name, jkw, grays, depths, trajectory_positions(poses_gt), APP_FRAMES)
            rt = lowtex.run_one(name, tkw, grays, depths, poses_gt, device="cpu")
        out[name] = rj, rt
    return out


@pytest.mark.parametrize("config", [name for name, _ in lowtex.LADDER])
def test_lowtex_app_rows_like_the_script(app_rows, config):
    rj, rt = app_rows[config]
    for key in ("kfs", "relocs", "resets", "lost"):
        assert rt[key] == rj[key], key
    assert abs(rt["ate_cm"] - rj["ate_cm"]) <= 1.0
    assert abs(rt["online_cm"] - rj["online_cm"]) <= 1.0
    assert np.isfinite(rt["ate_cm"])
    # Neither package initializes in this scene (see the module docstring).
    assert rt["kfs"] == 0 and rt["map_points"] == 0


@pytest.mark.parametrize("app", ["run_long", "ate_ladder", "lowtex"])
def test_apps_run_on_the_card_by_default(app, capsys):
    """With no CUDA, the default device raises before a frame is rendered;
    the CPU is taken only on request."""
    mod = importlib.import_module(f"pslam_tpu_torch.apps.{app}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["2"])
    assert "rendering" not in capsys.readouterr().out


def test_ate_ladder_table(tmp_path):
    from pslam_tpu_torch.apps import ate_ladder

    rows = [dict(name=n, ate_cm=1.0 + i, online_cm=2.0, kfs=10 + i, loops=i % 2, lost=0,
                 device="cpu") for i, (n, _) in enumerate(ate_ladder.LADDER)]
    path = tmp_path / "ladder.md"
    ate_ladder.write_table(str(path), rows, 200)
    lines = path.read_text().splitlines()
    table = [ln for ln in lines if ln.startswith("| ") and "RMSE" not in ln]
    assert [ln.split(" | ")[0][2:] for ln in table] == [n for n, _ in ate_ladder.LADDER]
    assert table[3] == "| +loop | 4.00 | 2.00 | 13 | 1 | 0 | cpu |"
