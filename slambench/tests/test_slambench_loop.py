"""The loop cell's parts on the CPU: the fr1-360 lap, the saved session
that a run resumes (its key, its build in the first run and its load in
the next), the loop checks and the configurations' limits."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from slambench import check, harness, stats
from slambench.traffic import path_poses, speeds

from .conftest import BENCH, small_config, small_traffic

SEED = 2**31 + 7
SEVEN = ("lost_frames", "ate_head_ratio", "pose_orth", "depth_rel_p99", "desc_bits_mean",
         "kf_rel_cm", "map_surface_mm")


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_fr1_360_is_one_lap_at_the_published_speeds():
    tr = json.loads((BENCH / "traffic" / "fr1-360.json").read_text())
    assert tr["replay"] == "cycle"
    poses = path_poses(tr)
    v, w = speeds(poses, tr["fps"])
    assert v == pytest.approx(0.210, rel=0.01) and w == pytest.approx(41.6, rel=0.01)
    # The lap closes: the step from its last frame back to its first is
    # every other step.
    lap = np.concatenate([poses, poses[:2]])
    steps = [np.linalg.inv(a) @ b for a, b in zip(lap[:-1], lap[1:])]
    for s in steps[-2:]:
        np.testing.assert_allclose(s, steps[0], atol=1e-9)


def test_resume_key_changes_with_each_input(tmp_path):
    port = tmp_path / "port"
    (port / "csrc").mkdir(parents=True)
    (port / "a.py").write_text("x = 1\n")
    (port / "csrc" / "k.cu").write_text("// kernel\n")
    cfg, tr = small_config("tum1-lil-loop"), small_traffic("fr1-360")
    key = harness.resume_key(cfg, tr, SEED, port)
    assert harness.resume_key(cfg, tr, SEED, port) == key
    (port / "__pycache__").mkdir()
    (port / "__pycache__" / "a.cpython-312.pyc").write_bytes(b"\0")
    assert harness.resume_key(cfg, tr, SEED, port) == key
    assert harness.resume_key(cfg, tr, SEED + 1, port) != key
    assert harness.resume_key(small_config("tum1-lil"), tr, SEED, port) != key
    tr2 = dict(tr, resume_frames=tr["resume_frames"] + 1)
    assert harness.resume_key(cfg, tr2, SEED, port) != key
    (port / "csrc" / "k.cu").write_text("// kernel, changed\n")
    assert harness.resume_key(cfg, tr, SEED, port) != key
    assert len(harness.resume_key(cfg, tr, SEED)) == 24


RESUME_RUNS = """
import contextlib, io, json, sys
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from pathlib import Path
from pslam_tpu_torch.pipeline.system import SlamSystem
from slambench import check, harness
cfg, tr, seed, out_dir = json.loads(sys.argv[1])
tracked, seen = [], []
real_track, real_readings = SlamSystem.track_rgbd, check.readings

def track(self, gray, depth, timestamp):
    tracked.append(self.frame_id)
    return real_track(self, gray, depth, timestamp)

def readings(cfg, traffic, seed, frames, m, seq_of_frame, first_frame, image_of, **kw):
    out = real_readings(cfg, traffic, seed, frames, m, seq_of_frame, first_frame, image_of, **kw)
    seen.append({"first": first_frame, "frames": [i for i, _, _ in frames],
                 "kf_ids": m["kf_frame_id"][m["kf_valid"]].tolist(), "values": out})
    return out

SlamSystem.track_rgbd, check.readings = track, readings
runs = []
for _ in range(2):
    tracked.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = harness.run("lil-fr1desk", seed, 1.0, False, device="cpu",
                          config_override=cfg, traffic_override=tr, resume_dir=Path(out_dir))
    info = [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith('{"seed"')][-1]
    runs.append({"tracked": list(tracked), "info": info, "checks": sorted(res["checks"]),
                 "seen": seen[-1]})
print(json.dumps(runs, default=float))
"""


def test_a_second_run_loads_the_saved_session(tmp_path):
    """The first run tracks the prefix and saves it; the second only loads
    it. Both resume at stream frame N: the window's keyframes continue from
    N + warm, and the two runs read alike. In a process of its own, so that
    the run's check for JAX holds."""
    cfg = small_config("tum1-lil-loop")
    tr = small_traffic("fr1-360", warm=3, head=3)
    n = tr["resume_frames"] = 8
    out = subprocess.run([sys.executable, "-c", RESUME_RUNS % str(BENCH.parent),
                          json.dumps([cfg, tr, SEED, str(tmp_path)])],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    built, loaded = json.loads(out.stdout.splitlines()[-1])
    warmed = {"loop_warmed": True}
    assert built["info"]["resume"] == {"frames": n, "built": True, "lost": 0, **warmed}
    assert loaded["info"]["resume"] == {"frames": n, "built": False, "lost": None, **warmed}
    assert [p.name for p in tmp_path.iterdir()] == [
        f"resume-{harness.resume_key(cfg, tr, SEED)}.npz"]
    # The build tracks frames 0..N-1 once; each run resumes at N.
    assert built["tracked"][:n] == list(range(n)) and built["tracked"][n:] == loaded["tracked"]
    assert loaded["tracked"][0] == n
    assert {"resume_build", "loop_warm", "resume_load"} <= loaded["info"]["setup_parts_s"].keys()
    for run in (built, loaded):
        seen = run["seen"]
        assert seen["first"] == n + tr["warm_frames"] == seen["frames"][0]
        assert min(seen["kf_ids"]) < n <= max(seen["kf_ids"]) <= seen["frames"][-1]
        assert run["checks"] == sorted(check.CHECKS)
    assert built["seen"]["values"] == loaded["seen"]["values"]


def test_the_loop_configuration_is_tum1_lil_with_the_loop_judged():
    lil, loop = _config("tum1-lil"), _config("tum1-lil-loop")
    for key in ("slam", "sensor", "source", "precision", "frames", "sequence_frames"):
        assert loop[key] == lil[key], key
    assert loop["limits"] == {**lil["limits"], "loop_missed": 0, "loop_rel_cm": 5.0}
    assert loop["reduced"] == lil["reduced"] + ["lap"]
    assert loop["assumed"].items() >= lil["assumed"].items()
    conf = harness.slam_config(loop)
    assert conf.use_loop_closing and conf.loop_gba and conf.use_bow


@pytest.mark.parametrize("name", ["tum1-points", "tum1-lil"])
def test_existing_configurations_keep_their_seven_checks(name):
    limits = _config(name)["limits"]
    assert tuple(limits) == SEVEN
    assert limits == {"lost_frames": 0, "ate_head_ratio": 0.5, "pose_orth": 0.001,
                      "depth_rel_p99": 1e-05, "desc_bits_mean": 0.005, "kf_rel_cm": 5.0,
                      "map_surface_mm": 50.0}
    assert check.CHECKS[:7] == SEVEN


@pytest.mark.parametrize("loop_judged", [False, True])
def test_judge_judges_the_checks_a_configuration_lists(loop_judged):
    limits = dict(_config("tum1-lil-loop" if loop_judged else "tum1-lil")["limits"])
    values = {k: 0.0 for k in check.CHECKS}
    values.update(loop_missed=1.0, loop_rel_cm=float("inf"))
    ok, rows = check.judge(values, limits)
    assert [r[0] for r in rows] == [c for c in check.CHECKS if c in limits]
    assert ok is not loop_judged
    if loop_judged:
        assert [r[0] for r in rows if not r[3]] == ["loop_missed", "loop_rel_cm"]
        values.update(loop_missed=0.0, loop_rel_cm=4.9)
        assert check.judge(values, limits)[0]
    with pytest.raises(ValueError, match="unknown"):
        check.judge(values, {**limits, "loop_rel_mm": 1.0})


def _pose(yaw_deg, centre):
    a = math.radians(yaw_deg)
    R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.asarray(centre, float)
    return T


def test_loop_readings():
    gt = np.stack([_pose(0, [0, 0, 1]), _pose(90, [1, 0, 1]), _pose(180, [0, 0, 2])])
    est = gt.copy()
    est[2] = _pose(180, [0.03, 0, 2])  # 3 cm off
    m = {"kf_valid": np.array([True, True, True, False]),
         "kf_frame_id": np.array([0, 1, 2, 0]), "kf_pose": np.concatenate([est, gt[:1]])}

    def seq(i):
        return i

    assert check.loop_readings(m, seq, gt, None) == {"loop_missed": 1.0,
                                                     "loop_rel_cm": float("inf")}
    r = check.loop_readings(m, seq, gt, {"closed": 1, "edges": [(2, 0), (1, 0)]})
    assert r["loop_missed"] == 0.0 and r["loop_rel_cm"] == pytest.approx(3.0, rel=1e-9)
    assert r["loop_rel_cm"] == pytest.approx(stats.rpe_mm(est[[2, 0]], gt[[2, 0]])[0] / 10)
    r = check.loop_readings(m, seq, gt, {"closed": 2, "edges": [(3, 0)]})
    assert r["loop_rel_cm"] == float("inf")
    assert check.loop_readings(m, seq, gt, {"closed": 0, "edges": []})["loop_missed"] == 1.0


def test_planted_loop_faults_act_from_the_first_window_frame():
    """Each loop fault, planted in a process of its own, leaves the loop
    closer alone before the window's first frame and acts from it on."""
    code = """
import sys, types
import numpy as np
sys.path.insert(0, %r)
from slambench.tests import planted
from pslam_tpu_torch.pipeline.loop_closing import LoopCloser
calls = []
LoopCloser.on_new_keyframe = lambda self, kf: calls.append(("on_kf", kf)) or True
LoopCloser.correct_loop = lambda self, kf, lkf, *a: calls.append(("correct", kf))
planted.plant(sys.argv[1], 10)
m = types.SimpleNamespace(kf_seq=np.arange(8) + 100, kf_pose=np.zeros((8, 4, 4)))
lc = types.SimpleNamespace(sys=types.SimpleNamespace(frame_id=9, map=m,
                           cfg=types.SimpleNamespace(loop_gba=True)),
                           loop_edges=[], last_loop_seq=-100,
                           stats={"closed": 0, "gba_runs": 0})
f = LoopCloser.on_new_keyframe if sys.argv[1] == "loop_skipped" else LoopCloser.correct_loop
args = (3,) if sys.argv[1] == "loop_skipped" else (3, 1, None, None, None)
before = f(lc, *args)
lc.sys.frame_id = 10
after = f(lc, *args)
print(calls, before, after, lc.loop_edges, lc.last_loop_seq, lc.stats, float(np.abs(m.kf_pose).sum()))
"""
    outs = {}
    for fault in ("loop_skipped", "loop_uncorrected"):
        out = subprocess.run([sys.executable, "-c", code % str(BENCH.parent), fault],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs[fault] = out.stdout.strip()
    assert outs["loop_skipped"] == ("[('on_kf', 3)] True False [] -100 "
                                    "{'closed': 0, 'gba_runs': 0} 0.0")
    assert outs["loop_uncorrected"] == ("[('correct', 3)] None None [(3, 1)] 103 "
                                        "{'closed': 1, 'gba_runs': 1} 0.0")


def test_the_head_ends_before_the_first_loop_frame():
    """A loop accepted inside the head cuts it there: the poses after a loop
    correction lie in the corrected map, and the ATE of a head across the
    jump would read the correction, not the tracker."""
    cfg = small_config("tum1-lil-loop")
    tr = small_traffic("fr1-360", warm=3, head=8)
    gt = path_poses(tr)
    jumped = [(i, gt[i] if i < 24 else _pose(0, [0.3, 0, 1]) @ gt[i], True) for i in range(20, 30)]
    # Slot 1, made in frame 24, accepted the loop; left invalid here, so no
    # keyframe of the window is sampled for the frontend numbers.
    m = {"kf_valid": np.array([True, False]), "kf_frame_id": np.array([1, 24]),
         "kf_pose": gt[[1, 24]], "kf_uv": np.zeros((2, 1, 2)), "kf_level": np.zeros((2, 1), int),
         "kf_desc": np.zeros((2, 1, 32), np.uint8), "kf_feat_depth": np.zeros((2, 1)),
         "kf_feat_mp": -np.ones((2, 1), int), "kf_feat_valid": np.zeros((2, 1), bool),
         "mp_valid": np.zeros(1, bool), "mp_pos": np.zeros((1, 3))}

    def read(loops):
        return check.readings(cfg, tr, SEED, jumped, m, lambda i: i, 20, lambda i: None,
                              loops=loops)

    cut = read({"closed": 1, "edges": [(1, 0)]})
    assert cut["ate_head_ratio"] < 1e-6 and cut["loop_missed"] == 0.0
    assert read(None)["ate_head_ratio"] > 1
    at_start = dict(m, kf_frame_id=np.array([1, 20]))
    r = check.readings(cfg, tr, SEED, jumped, at_start, lambda i: i, 20, lambda i: None,
                       loops={"closed": 1, "edges": [(1, 0)]})
    assert r["ate_head_ratio"] == r["pose_orth"] == float("inf")
