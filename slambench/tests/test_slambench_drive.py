"""The drive a configuration names: how the client calls the system. The
default cells call ``track_rgbd`` as before; ``tum1-points-pipelined``
calls ``track_rgbd_pipelined`` at depth 1, and each frame is judged by the
pose committed under its own ``frame_id``."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest

from slambench import harness

from .conftest import BENCH, small_config, small_traffic

SEED = 2**31 + 7


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_the_pipelined_configuration_is_tum1_points_with_a_drive():
    points, pipe = _config("tum1-points"), _config("tum1-points-pipelined")
    assert set(pipe) == set(points)
    for key in set(points) - {"name", "about", "slam"}:
        assert pipe[key] == points[key], key
    assert pipe["slam"] == {**points["slam"], "drive": "track_rgbd_pipelined"}
    assert harness.drive_of(points) == "track_rgbd"
    assert harness.drive_of(pipe) == "track_rgbd_pipelined"
    assert harness.slam_config(pipe) == harness.slam_config(points)


def test_an_unknown_drive_gives_no_result_before_rendering(monkeypatch):
    def render(*a, **k):
        raise AssertionError("rendered")

    monkeypatch.setattr(harness, "render_pass", render)
    cfg = small_config("tum1-points-pipelined")
    cfg["slam"]["drive"] = "track_rgbd_threaded"
    with pytest.raises(harness.NoResult, match="unknown drive 'track_rgbd_threaded'"):
        harness.run("points-pipelined-fr1desk", SEED, 1.0, False, device="cpu",
                    config_override=cfg, traffic_override=small_traffic())


class _Stub:
    """Depth-1 pipelined tracking as ``SlamSystem`` does it, on a clock the
    test moves: a call takes ``cost[frame]`` seconds, finishes the frame in
    flight and keeps its own in flight; at a frame in ``lost`` it finishes
    both (the drain and ``track_rgbd``)."""

    def __init__(self, clock, cost, lost=()):
        self.clock, self.cost, self.lost = clock, cost, set(lost)
        self.frame_id, self.state, self.inflight, self.committed = 0, "OK", None, []

    def _commit_frame(self, hf):
        self.committed.append(hf.frame_id)

    def _finish(self, fid):
        self._commit_frame(types.SimpleNamespace(frame_id=fid, T_cw=np.eye(4) * (fid + 1)))

    def track_rgbd_pipelined(self, gray, depth, timestamp):
        fid, prev = self.frame_id, self.inflight
        self.clock.now += self.cost[fid]
        self.frame_id += 1
        self.inflight = None if fid in self.lost else fid
        if prev is not None:
            self._finish(prev)
        if fid in self.lost:
            self._finish(fid)

    def finish(self):
        if self.inflight is not None:
            self._finish(self.inflight)
            self.inflight = None


def test_pipelined_latency_runs_from_hand_over_to_commit():
    clock = types.SimpleNamespace(now=100.0)
    cost = {0: 0.25, 1: 0.5, 2: 0.125, 3: 1.0, 4: 0.25}
    stub = _Stub(clock, cost, lost=[3])
    pipe = harness.Pipelined(stub, lambda s: s.state == "OK", clock=lambda: clock.now)
    ends, got = [], []
    for i in range(5):
        b, done = pipe.call(40 + i, None, None, 0.0)
        ends.append(b)
        got += done
        clock.now += 0.0625  # the client's own time between calls
    got += pipe.finish()
    # Frame i is handed over at the start of call i and committed at the end
    # of call i+1; frame 3 (lost) drains 2 and is finished in its own call;
    # frame 4 waits for finish().
    gap = 0.0625
    want = [cost[0] + gap + cost[1], cost[1] + gap + cost[2], cost[2] + gap + cost[3],
            cost[3], cost[4] + gap]
    assert [g[0] for g in got] == [40, 41, 42, 43, 44]
    assert [g[3] for g in got] == pytest.approx(want)
    assert all(g[2] for g in got)
    np.testing.assert_array_equal(got[2][1], np.eye(4) * 3)
    assert ends == pytest.approx(np.cumsum([cost[i] + gap for i in range(5)]) + 100 - gap)
    assert stub.committed == [0, 1, 2, 3, 4] and pipe.handed == {}


DRIVE_RUN = """
import contextlib, io, json, sys
sys.path.insert(0, %r)
import numpy as np
import torch
torch.set_num_threads(2)
from pslam_tpu_torch.pipeline.system import SlamSystem
from slambench import check, harness
cfg, tr, seed = json.loads(sys.argv[1])
S = SlamSystem
log = {"handed": [], "committed": [], "serial": [], "wrapped": [], "pipes": 0}
real = {n: getattr(S, n) for n in ("_commit_frame", "track_rgbd_pipelined", "track_rgbd")}

def commit(self, hf):
    log["committed"].append((hf.frame_id, np.array(hf.T_cw, np.float64).tolist()))
    return real["_commit_frame"](self, hf)

def pipelined(self, gray, depth, timestamp):
    log["handed"].append((self.frame_id, timestamp))
    return real["track_rgbd_pipelined"](self, gray, depth, timestamp)

def serial(self, gray, depth, timestamp):
    log["serial"].append((self.frame_id, timestamp))
    log["wrapped"].append("_commit_frame" in vars(self))
    return real["track_rgbd"](self, gray, depth, timestamp)

class Pipelined(harness.Pipelined):
    def __init__(self, *a, **k):
        log["pipes"] += 1
        super().__init__(*a, **k)

S._commit_frame, S.track_rgbd_pipelined, S.track_rgbd = commit, pipelined, serial
harness.Pipelined = Pipelined
real_readings = check.readings

def readings(cfg, traffic, seed, frames, m, seq_of_frame, first_frame, image_of, **kw):
    log["frames"] = [(i, T.tolist(), bool(ok)) for i, T, ok in frames]
    log["first"] = first_frame
    return real_readings(cfg, traffic, seed, frames, m, seq_of_frame, first_frame, image_of,
                         **kw)

check.readings = readings
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = harness.run(sys.argv[2], seed, 3.0, False, device="cpu", config_override=cfg,
                      traffic_override=tr)
log["correct"], log["attempted"] = res["correct"], res["attempted"]
print(json.dumps(log))
"""


def _drive_run(config: str, workload: str) -> dict:
    cfg, tr = small_config(config), small_traffic("fr1desk", warm=4, head=3)
    out = subprocess.run([sys.executable, "-c", DRIVE_RUN % str(BENCH.parent),
                          json.dumps([cfg, tr, SEED]), workload],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_a_configuration_without_a_drive_calls_track_rgbd_alone():
    log = _drive_run("tum1-points", "points-fr1desk")
    assert log["handed"] == [] and log["pipes"] == 0
    assert log["wrapped"] and not any(log["wrapped"])
    assert [i for i, _, _ in log["frames"]] == [round(ts * 30) for _, ts in log["serial"][4:]]


def test_the_pipelined_drive_pairs_each_frame_with_its_own_commit():
    """Each stream index the check gets carries the pose committed under the
    frame id handed over with that stream frame, read from the program's
    commits directly (a one-frame shift reads only ~0.09 ate_head_ratio at
    fr1desk speed, so the check alone would not catch it)."""
    log = _drive_run("tum1-points-pipelined", "points-pipelined-fr1desk")
    assert log["correct"] and log["pipes"] == 1
    # The first warm frame initializes through track_rgbd; every later frame
    # goes through track_rgbd_pipelined.
    assert [fid for fid, _ in log["serial"]] == [0]
    stream_of = {fid: round(ts * 30) for fid, ts in log["handed"]}
    committed = {fid: T for fid, T in log["committed"]}
    after = [fid for fid, _ in log["committed"] if stream_of.get(fid, -1) >= log["first"]]
    assert len(log["frames"]) == len(after) == len(log["handed"]) - log["first"]
    for (i, T, ok), fid in zip(log["frames"], after):
        assert stream_of[fid] == i and committed[fid] == T and ok
    assert [i for i, _, _ in log["frames"]] == list(range(log["first"],
                                                          log["first"] + len(after)))
    # The window's last frame, committed by finish(), is judged but not timed.
    assert log["attempted"] == len(after) - 1
