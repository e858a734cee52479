"""The readers of the program's own spans (``slambench/program_spans.py``)
on fixed recorder records, a fixed device trace and fixed counters: one
warm-up frame, two window frames and one profiled frame."""

import pytest

from slambench import harness, program_spans
from slambench.trace import DeviceTrace, Spans

MS = 1_000_000


def S(name, t0, t1, *kids, **attrs):
    return name, t0, t1, attrs, kids


# Times in ms. Frame 1 retries with the wide window, then runs the
# fallback (its pose search is under no step) and becomes a keyframe.
FRAMES = [
    S("frame", 0, 10, S("track", 1, 9, S("track.step", 1, 8, S("track.orb", 1, 2),
                                         attempt="motion")), frame=0),
    S("frame", 100, 200,
      S("frame.upload", 100, 101),
      S("track", 101, 199,
        S("track.step", 101, 150,
          S("track.orb", 101, 111), S("track.lines", 111, 131),
          S("track.motion", 131, 140, S("track.pose", 132, 139)),
          S("track.local_map", 140, 149, S("track.pose", 141, 148)), attempt="motion"),
        S("track.readback", 150, 151),
        S("track.step", 151, 180,
          S("track.orb", 151, 161), S("track.pose", 162, 170), attempt="wide"),
        S("track.readback", 180, 182),
        S("track.fallback", 182, 189, S("track.pose", 183, 185)),
        S("keyframe.readback", 189, 190),
        S("mapping", 190, 197,
          S("backend.commit", 190, 191, cause=0), S("mapping.insert", 191, 192),
          S("mapping.lines", 192, 195), S("backend.dispatch", 195, 196),
          S("local_ba.dispatch", 196, 197)),
        S("keyframe.snapshot", 197, 199)),
      frame=1),
    S("frame", 200, 300,
      S("track", 201, 260,
        S("track.step", 201, 250, S("track.orb", 201, 209), S("track.pose", 210, 220),
          attempt="motion"),
        S("track.readback", 250, 252)),
      frame=2),
    S("frame", 300, 400,
      S("track", 301, 390,
        S("track.step", 301, 350, S("track.orb", 301, 305), S("track.pose", 310, 330),
          attempt="motion"),
        S("track.readback", 350, 360)),
      frame=3),
    S("backend.commit", 401, 402, cause=1),  # flush(), after the profiled frames
]

# (name, start, end, launching host time), ms: launched in the profiled
# frame's ORB, pose (twice), step's own time, read-back, frame's own time,
# and one unlinked.
ACTS = [("k", 302, 303, 301.5), ("k", 311, 312, 311), ("k", 315, 316, 315),
        ("k", 340, 341, 340), ("k", 355, 356, 355), ("k", 395, 396, 395),
        ("k", 398.5, 399, None)]


def build(nodes):
    recs = []

    def add(node, parent, frame):
        name, t0, t1, attrs, kids = node
        frame = attrs.get("frame", frame)
        i = len(recs)
        recs.append((name, int(t0 * MS), int(t1 * MS), parent, frame, attrs))
        for k in kids:
            add(k, i, frame)

    for n in nodes:
        add(n, None, None)
    return recs


class FixedRecorder:
    def __init__(self, records):
        self._records = records

    def records(self):
        return list(self._records)


def layer_run(offset_ns=0):
    spans = Spans()
    spans.records["system"] = [(0.5, 0.6), (0.6, 0.7)]  # the two window frames
    acts = [(n, int(s * MS), int(e * MS), None if t is None else int(t * MS))
            for n, s, e, t in ACTS]
    ranges = {"system": [(int(299.9 * MS) + offset_ns, int(400.1 * MS) + offset_ns)]}
    trace = DeviceTrace(acts, ranges, window_s=0.1)
    return harness.LayerRun(spans, trace, {"track_steps": 3, "track_frames": 2})


@pytest.fixture
def recorded(monkeypatch):
    recs = build(FRAMES)
    monkeypatch.setattr(program_spans, "RECORDER", FixedRecorder(recs))
    return recs


def read(name, run):
    return harness.layer_reader(name).read(run)


def test_window_and_profiled_frames(recorded):
    fr = program_spans.frames(layer_run())
    frame_of = {i: r[4] for i, r in enumerate(recorded)}
    assert {frame_of[i] for i in fr.window} == {1, 2}
    assert {frame_of[i] for i in fr.profiled} == {3}
    assert fr.window == list(range(fr.window[0], fr.profiled[0]))
    # Left out: frame 0's four records and the commit outside any frame.
    assert len(fr.window) + len(fr.profiled) + 5 == len(recorded)
    assert len(fr.pose_in_steps(fr.window)) == 4  # the fallback's is under no step


def test_readers_on_fixed_records_trace_and_counters(recorded):
    run = layer_run()
    assert read("tracking.steps_per_frame", run) == pytest.approx(1.5)
    assert read("tracking.orb_ms_per_step", run) == pytest.approx(28 / 3)
    assert read("tracking.lines_ms_per_step", run) == pytest.approx(20 / 3)
    assert read("tracking.pose_ms_per_step", run) == pytest.approx(32 / 3)
    assert read("tracking.pose_launches_per_step", run) == 2
    assert read("tracking.wait_ms_per_frame", run) == pytest.approx(2.5)
    assert read("keyframe.host_ms_per_kf", run) == pytest.approx(3.0)
    assert read("mapping.lines_ms_per_kf", run) == pytest.approx(3.0)
    assert read("backend.ms_per_kf", run) == pytest.approx(2.0)
    # Gaps 8 (ORB), 3 and 24 (pose), 14 (step's own), 39 (read-back), 2.5
    # (frame's own) ms: 16.5 of 90.5 unattributed.
    assert read("device.idle_unattributed_pct", run) == pytest.approx(100 * 16.5 / 90.5)


def test_idle_by_innermost_span(recorded):
    run = layer_run()
    by = program_spans.idle_by_span(run, program_spans.frames(run))
    assert by == {"track.orb": 8 * MS, "track.pose": 27 * MS, "track.step": 14 * MS,
                  "track.readback": 39 * MS, "frame": int(2.5 * MS)}


def test_no_frame_in_the_system_ranges_reads_nothing(recorded):
    run = layer_run(offset_ns=int(1.79e18))  # another clock
    assert program_spans.frames(run) is None
    for name in ("tracking.orb_ms_per_step", "tracking.pose_launches_per_step",
                 "keyframe.host_ms_per_kf", "device.idle_unattributed_pct"):
        assert read(name, run) is None, name


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "RECORDER", None)
    run = layer_run()
    run.counters = {}
    for name in ("tracking.steps_per_frame", "tracking.wait_ms_per_frame",
                 "backend.ms_per_kf", "device.idle_unattributed_pct"):
        assert read(name, run) is None, name


def test_points_only_frames_read_no_line_metrics(monkeypatch):
    def drop(node):
        name, t0, t1, attrs, kids = node
        return name, t0, t1, attrs, tuple(drop(k) for k in kids
                                          if k[0] not in ("track.lines", "mapping.lines"))

    monkeypatch.setattr(program_spans, "RECORDER", FixedRecorder(build(map(drop, FRAMES))))
    run = layer_run()
    assert read("tracking.lines_ms_per_step", run) is None
    assert read("mapping.lines_ms_per_kf", run) is None
    assert read("tracking.orb_ms_per_step", run) == pytest.approx(28 / 3)
