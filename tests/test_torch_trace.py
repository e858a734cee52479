"""The port's span recorder (``pslam_tpu_torch/utils/trace.py``) on the
structural-line slice of ``tests/test_torch_slice_lines.py`` (config 3, 8
frames at 320x240, 8 px line tiles), the port alone, on the CPU:

- off, it records nothing, and the poses, states and ``stats`` equal those
  of the same frames with it on;
- on, spans nest inside their parents, every record under a ``frame``
  carries that frame's id, the tracked and keyframe frames open the spans
  of their layers, and ``track_steps`` >= ``track_frames``;
- under a CPU ``torch.profiler`` window, each span's ``record_function``
  event lies inside its recorded interval (1 ms margin): the records are on
  the profiler's clock.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.io.synthetic import arc_trajectory, render_sequence
from pslam_tpu_torch.ops.lines import LineConfig
from pslam_tpu_torch.ops.orb import OrbConfig
from pslam_tpu_torch.pipeline.system import SlamSystem
from pslam_tpu_torch.utils import trace
from pslam_tpu_torch.utils.config import Capacities, SlamConfig

CAM_KW = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
              width=320, height=240)
N_FRAMES = 8
PROFILED = 5  # the frame that runs under the profiler: a keyframe frame
MARGIN_NS = 1_000_000

TRACKED = {"frame", "frame.upload", "track", "track.step", "track.orb", "track.lines",
           "track.motion", "track.pose", "track.local_map", "track.line_match",
           "track.readback"}
KEYFRAME = {"keyframe.readback", "keyframe.snapshot", "mapping", "mapping.insert",
            "mapping.lines", "mapping.cull", "backend.dispatch", "local_ba.dispatch",
            "backend.commit", "local_ba.commit"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes, and torch's default of a thread a
    core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder():
    """The process-wide recorder, cleared and off again afterwards."""
    rec = trace.RECORDER
    rec.clear()
    yield rec
    rec.disable()
    rec.clear()


def _run(grays, depths, profiled=None):
    cfg = SlamConfig(camera=Camera(**CAM_KW), orb=OrbConfig(n_features=500),
                     lines=LineConfig(tile=8), caps=Capacities(local_points=1024),
                     use_bow=False, use_loop_closing=False)
    slam = SlamSystem(cfg, device="cpu")
    rows, prof = [], None
    for i in range(N_FRAMES):
        if i == profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                T = slam.track_rgbd(grays[i], depths[i], i / 30.0)
        else:
            T = slam.track_rgbd(grays[i], depths[i], i / 30.0)
        rows.append((T.copy(), slam.state.name, slam.map.n_kf))
    slam.flush()
    return slam, rows, prof


@pytest.fixture(scope="module")
def runs():
    """The slice with the recorder off, then on (one frame profiled)."""
    rec = trace.RECORDER
    grays, depths, _ = render_sequence(
        Camera(**CAM_KW), poses=arc_trajectory(24)[:N_FRAMES], seed=0
    )
    try:
        rec.disable()
        rec.clear()
        off = _run(grays, depths)
        off_records = rec.records()
        rec.enable()
        on = _run(grays, depths, profiled=PROFILED)
        records = rec.records()
    finally:
        rec.disable()
        rec.clear()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in on[2].profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    return dict(off=off, on=on, off_records=off_records, records=records, events=events)


def test_off_records_nothing(runs):
    assert runs["off_records"] == []
    assert trace.RECORDER.span("track") is trace.RECORDER.span("mapping", cause=3)


def test_on_and_off_runs_identical(runs):
    (s_off, rows_off, _), (s_on, rows_on, _) = runs["off"], runs["on"]
    for (T0, st0, k0), (T1, st1, k1) in zip(rows_off, rows_on):
        np.testing.assert_array_equal(T0, T1)
        assert (st0, k0) == (st1, k1) and st1 == "OK"
    assert s_on.stats == s_off.stats
    np.testing.assert_array_equal(s_on.map.kf_pose, s_off.map.kf_pose)
    np.testing.assert_array_equal(s_on.map.mp_pos, s_off.map.mp_pos)


def test_spans_nest_and_carry_their_frame(runs):
    recs = runs["records"]
    assert recs and all(r[2] is not None for r in recs)
    roots = [r for r in recs if r[3] is None]
    assert [r[4] for r in roots if r[0] == "frame"] == list(range(N_FRAMES))
    # Outside a frame only ``flush()``'s commits open spans.
    assert {r[0] for r in roots if r[0] != "frame"} <= {"local_ba.commit", "backend.commit"}
    for name, t0, t1, parent, frame, _ in recs:
        assert t0 <= t1
        if parent is None:
            assert (frame is None) == (name != "frame"), name
            continue
        p = recs[parent]
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
        # Every record hangs under its frame's root and carries its id.
        root = parent
        while recs[root][3] is not None:
            root = recs[root][3]
        assert recs[root][0] == "frame" and frame == recs[root][4], name


def test_tracked_and_keyframe_frames_open_their_spans(runs):
    recs = runs["records"]
    by_frame = {}
    for r in recs:
        by_frame.setdefault(r[4], set()).add(r[0])
    kf_frames = [f for f, names in by_frame.items() if "mapping" in names]
    assert len(kf_frames) >= 3
    assert all(TRACKED <= by_frame[f] for f in range(1, N_FRAMES))
    assert any(KEYFRAME <= by_frame[f] for f in kf_frames)
    steps = [r for r in recs if r[0] == "track.step"]
    assert {r[5]["attempt"] for r in steps} <= {"motion", "wide", "fallback"}
    # A commit names the keyframe whose dispatch it finishes: an earlier one.
    commits = [r for r in recs if r[0] in ("backend.commit", "local_ba.commit")]
    assert commits and all(r[5]["cause"] in kf_frames for r in commits)
    assert all(r[5]["cause"] < r[4] for r in commits if r[4] is not None)


def test_track_counters(runs):
    s, _, _ = runs["on"]
    recs = runs["records"]
    st = s.stats
    assert st["track_steps"] >= st["track_frames"] == N_FRAMES - 1
    assert st["track_steps"] == sum(r[0] == "track.step" for r in recs)
    assert st["track_frames"] == sum(r[0] == "track" for r in recs)
    assert st.get("track_retries", 0) == sum(r[0] == "track.step" and r[5]["attempt"] == "wide"
                                             for r in recs)


def test_record_function_events_inside_the_recorded_intervals(runs):
    recs = runs["records"]
    profiled = [r for r in recs if r[4] == PROFILED]
    names = {r[0] for r in profiled}
    events = {}
    for name, s, e in sorted(runs["events"], key=lambda x: x[1]):
        if name in names:
            events.setdefault(name, []).append((s, e))
    assert names >= TRACKED | KEYFRAME - {"local_ba.commit"}
    for name in names:
        mine = [(r[1], r[2]) for r in profiled if r[0] == name]
        theirs = events.get(name, [])
        assert len(theirs) == len(mine), name
        for (t0, t1), (s, e) in zip(mine, theirs):
            assert t0 - MARGIN_NS <= s and e <= t1 + MARGIN_NS, (name, t0, s, e, t1)


def test_recorder_parents_frames_attrs_and_clear(recorder):
    span = recorder.span
    recorder.enable()
    with span("frame", frame=7):
        with span("track.step", attempt="wide"):
            with span("track.pose"):
                pass
        with span("track.readback"):
            pass
    with span("loose"):
        pass
    recs = recorder.records()
    assert [(r[0], r[3], r[4], r[5]) for r in recs] == [
        ("frame", None, 7, {"frame": 7}),
        ("track.step", 0, 7, {"attempt": "wide"}),
        ("track.pose", 1, 7, {}),
        ("track.readback", 0, 7, {}),
        ("loose", None, None, {}),
    ]
    # Cleared while a span is open: that span closes unrecorded, and the
    # spans after it start a new list.
    with span("open"):
        recorder.clear()
        with span("after"):
            pass
    assert [(r[0], r[3]) for r in recorder.records()] == [("after", None)]
    # Disabled while a span is open: it still closes and is kept.
    recorder.clear()
    with span("kept"):
        recorder.disable()
        with span("off"):
            pass
    assert [r[0] for r in recorder.records()] == ["kept"]
    assert recorder.records()[0][2] is not None
