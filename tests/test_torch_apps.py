"""The port's ``utils/trace.py`` and ``apps/visualize.py`` against the JAX
package's, on the CPU. All checks exact:

- ``StageTimers``: counts, maxima and the report rows equal to JAX's under
  one fake clock;
- ``dump_map_ply`` / ``dump_map_npz`` of one map state (built in the JAX
  package's ``MapState``, copied into the port with
  ``interop.map_state_from_arrays``): the same parsed arrays;
- ``draw_frame_overlay``: the same pixels;
- ``plot_trajectory`` and ``render_run_artifacts`` write their files.
"""

import itertools
import time
import types

import numpy as np
import pytest
from PIL import Image

from pslam_tpu.apps import visualize as jvis
from pslam_tpu.models.map_state import MapState as JMap
from pslam_tpu.utils.config import Capacities as JCaps, SlamConfig as JCfg
from pslam_tpu.utils.trace import StageTimers as JTimers
from pslam_tpu_torch import interop
from pslam_tpu_torch.apps import visualize as tvis
from pslam_tpu_torch.utils.config import Capacities as TCaps, SlamConfig as TCfg
from pslam_tpu_torch.utils.trace import StageTimers as TTimers

CAPS = dict(max_keyframes=8, max_map_points=64, max_map_lines=16, max_lils=8)


def _timed(timers, monkeypatch):
    """Drive ``timers`` through a fixed stage sequence under a fake clock
    that advances 1, 2, 3, ... ms between reads."""
    ticks = itertools.accumulate(itertools.count(1), initial=0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)
    for name in ("io", "track", "io", "track", "track", "save"):
        with timers.stage(name):
            pass
    return timers


def test_stage_timers_equal_jax(monkeypatch):
    t = _timed(TTimers(), monkeypatch)
    j = _timed(JTimers(), monkeypatch)
    assert t.counts == j.counts == {"io": 2, "track": 3, "save": 1}
    assert t.maxima == j.maxima and t.totals == j.totals
    assert t.report() == j.report()
    assert t.report().splitlines()[1].startswith("track")  # largest total first
    assert t.as_dict() == j.as_dict()
    assert t.mean("missing") == 0.0


@pytest.fixture(scope="module")
def maps():
    """One map state with points, map lines, LILs and keyframes, in both
    packages."""
    rng = np.random.default_rng(5)
    jm = JMap(JCfg(caps=JCaps(**CAPS)))
    jm.mp_valid[:] = rng.uniform(size=jm.mp_valid.shape) < 0.6
    jm.mp_pos[:] = rng.normal(0, 2, jm.mp_pos.shape).astype(np.float32)
    jm.mp_n_obs[:] = rng.integers(1, 9, jm.mp_n_obs.shape)
    jm.ml_valid[:] = rng.uniform(size=jm.ml_valid.shape) < 0.5
    jm.ml_pos[:] = rng.normal(0, 2, jm.ml_pos.shape).astype(np.float32)
    jm.ml_n_obs[:] = rng.integers(1, 9, jm.ml_n_obs.shape)
    jm.il_valid[:] = rng.uniform(size=jm.il_valid.shape) < 0.5
    jm.il_state[:] = rng.normal(0, 2, jm.il_state.shape).astype(np.float32)
    jm.il_plane[:] = rng.normal(0, 1, jm.il_plane.shape).astype(np.float32)
    jm.n_kf = 5
    jm.kf_valid[:5] = [True, True, False, True, True]
    jm.kf_pose[:5, :3, 3] = rng.normal(0, 1, (5, 3)).astype(np.float32)
    jm.kf_timestamp[:5] = np.arange(5) / 30.0
    tm = interop.map_state_from_arrays(TCfg(caps=TCaps(**CAPS)), jm)
    return jm, tm


def _parse_ply(path):
    lines = open(path).read().splitlines()
    end = lines.index("end_header")
    n_v = int(lines[2].split()[-1])
    rows = [ln.split() for ln in lines[end + 1:]]
    verts = np.asarray(rows[:n_v], np.float64)
    edges = np.asarray(rows[n_v:], np.int64).reshape(-1, 2)
    return lines[:end + 1], verts, edges


def test_map_dumps_equal_jax(maps, tmp_path):
    jm, tm = maps
    j_hdr, j_v, j_e = _parse_ply(jvis.dump_map_ply(jm, str(tmp_path / "j.ply")))
    t_hdr, t_v, t_e = _parse_ply(tvis.dump_map_ply(tm, str(tmp_path / "t.ply")))
    assert t_hdr == j_hdr
    np.testing.assert_array_equal(t_v, j_v)
    np.testing.assert_array_equal(t_e, j_e)
    assert len(t_e) == int(jm.ml_valid.sum()) >= 1
    assert set(t_v[:, 3].astype(int)) == {0, 1, 2}
    j = np.load(jvis.dump_map_npz(jm, str(tmp_path / "j.npz")))
    t = np.load(tvis.dump_map_npz(tm, str(tmp_path / "t.npz")))
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert len(t["kf_pose"]) == 4


def test_frame_overlay_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    H, W, N = 120, 160, 60
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    hf = types.SimpleNamespace(
        uv=rng.uniform([-5, -5], [W + 5, H + 5], (N, 2)).astype(np.float32),
        valid=rng.uniform(size=N) < 0.8,
        feat_mp=np.where(rng.uniform(size=N) < 0.5, rng.integers(0, 99, N), -1),
        line_valid=rng.uniform(size=6) < 0.7,
        line_sp=rng.uniform([0, 0], [W, H], (6, 2)).astype(np.float32),
        line_ep=rng.uniform([0, 0], [W, H], (6, 2)).astype(np.float32),
        lil=types.SimpleNamespace(valid=np.array([True, False, True]),
                                  cross2d=rng.uniform([0, 0], [W, H], (3, 2))),
    )
    inlier = rng.uniform(size=N) < 0.7
    for mask in (None, inlier):
        j = jvis.draw_frame_overlay(gray, hf, str(tmp_path / "j.png"), inlier_mask=mask)
        t = tvis.draw_frame_overlay(gray, hf, str(tmp_path / "t.png"), inlier_mask=mask)
        with Image.open(j) as a, Image.open(t) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    return T


def test_plot_trajectory_and_run_artifacts(maps, tmp_path):
    jm, tm = maps
    path = tvis.plot_trajectory(_poses(20, 0), str(tmp_path / "traj.png"),
                                gt_poses=_poses(20, 1), kf_poses=_poses(4, 2))
    with Image.open(path) as im:
        assert im.format == "PNG" and im.size[0] > 100
    system = types.SimpleNamespace(map=tm, poses=_poses(12, 3))
    out = tvis.render_run_artifacts(system, str(tmp_path / "run"))
    assert sorted(out) == ["npz", "ply", "trajectory"]
    with Image.open(out["trajectory"]) as im:
        assert im.format == "PNG"
    assert len(np.load(out["npz"])["mp_pos"]) == int(tm.mp_valid.sum())
