"""The program's own spans, for the per-layer readers that read them.

Importing this module turns on the span recorder of
``pslam_tpu_torch.utils.trace`` (``RECORDER``). The harness loads the
readers of a ``--trace 1`` run, and so this module, before it builds
``SlamSystem``, so the recorder holds every frame from the warm-up on. With
a program that has no recorder nothing is recorded, and every reader that
reads records returns None.

A record is ``(name, start_ns, end_ns, parent index, frame id, attrs)``,
stamped with ``time.time_ns()``: the wall clock of the profiler's events.
The program's ``frame`` spans (one a ``track_rgbd`` call) split the records:

- the **profiled frames** lie inside the harness's ``system`` ranges of the
  profiler window, compared on that shared clock; if none does, the clocks
  differ and the readers return None;
- the **window frames** are the ``run.spans.count("system")`` frames just
  before them: the frames of the timed window.

A device activity belongs to a program span when the host call that
launched it (``DeviceTrace.activities[i][3]``, on the same clock) fell
inside the span.
"""

from __future__ import annotations

import bisect

try:
    from pslam_tpu_torch.utils.trace import RECORDER
except ImportError:
    RECORDER = None

if RECORDER is not None:
    RECORDER.enable()

SPANS = [("pslam_tpu_torch.pipeline.system:SlamSystem.track_rgbd", "system")]

# Spans that hold the stages without being one: device idle that begins in
# their own time (or outside every frame) is unattributed.
CONTAINERS = ("frame", "track", "track.step", "mapping")
SLACK_NS = 1_000_000


class Frames:
    """The records of the window frames and of the profiled frames; each
    list keeps the records' indices into ``records``."""

    def __init__(self, records, window: list[int], profiled: list[int]):
        self.records = records
        self.window = window
        self.profiled = profiled

    def total_ms(self, which: list[int], *names: str) -> float:
        return sum(self.records[i][2] - self.records[i][1] for i in which
                   if self.records[i][0] in names) / 1e6

    def count(self, which: list[int], name: str) -> int:
        return sum(self.records[i][0] == name for i in which)

    def under(self, i: int, name: str) -> bool:
        """Whether record ``i`` lies below a span called ``name``."""
        p = self.records[i][3]
        while p is not None:
            if self.records[p][0] == name:
                return True
            p = self.records[p][3]
        return False

    def pose_in_steps(self, which: list[int]) -> list[int]:
        return [i for i in which
                if self.records[i][0] == "track.pose" and self.under(i, "track.step")]


def _inside(ranges, t0: int, t1: int) -> bool:
    k = bisect.bisect_right(ranges, (t0 + SLACK_NS, float("inf"))) - 1
    return k >= 0 and ranges[k][0] - SLACK_NS <= t0 and t1 <= ranges[k][1] + SLACK_NS


def frames(run) -> Frames | None:
    """The window and profiled frames of ``run`` (None when the program
    recorded none, or no frame lies in the profiler's ``system`` ranges)."""
    if RECORDER is None or run.trace is None:
        return None
    records = RECORDER.records()
    ranges = run.trace.ranges.get("system", [])
    roots = [i for i, r in enumerate(records)
             if r[0] == "frame" and r[3] is None and r[2] is not None]
    prof = [k for k, i in enumerate(roots) if _inside(ranges, records[i][1], records[i][2])]
    n = run.spans.count("system")
    if not prof or prof[0] < n:
        return None
    first, last = prof[0], prof[-1]

    def indices(a: int, b: int) -> list[int]:
        """The records of frames roots[a] up to (not including) roots[b]."""
        end = roots[b] if b < len(roots) else len(records)
        return [i for i in range(roots[a], end)
                if records[i][2] is not None and records[i][4] is not None]

    return Frames(records, indices(first - n, first), indices(first, last + 1))


def ms_per(run, names: tuple[str, ...], per: str):
    """Host ms of the window frames' spans called ``names`` over the number
    of their ``per`` spans; None where no such span was recorded."""
    fr = frames(run)
    if fr is None:
        return None
    n = fr.count(fr.window, per)
    if n == 0 or not any(fr.count(fr.window, name) for name in names):
        return None
    return fr.total_ms(fr.window, *names) / n


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def holds(intervals, t) -> bool:
    """Whether time ``t`` lies in the sorted, disjoint ``intervals``."""
    if t is None:
        return False
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= t <= intervals[k][1]


def idle_by_span(run, fr: Frames) -> dict[str, int]:
    """Device idle ns of the profiler window between activities, by the
    innermost program span of the profiled frames the host was in when each
    gap began (``None``: in none)."""
    recs = fr.records
    bounds = sorted([(recs[i][1], 0, i) for i in fr.profiled]
                    + [(recs[i][2], 1, i) for i in fr.profiled])
    stack, k, end = [], 0, None
    by: dict[str, int] = {}
    for _, s, e, _ in sorted(run.trace.activities, key=lambda a: a[1]):
        if end is not None and s > end:
            while k < len(bounds) and bounds[k][0] <= end:
                t, closing, i = bounds[k]
                if closing:
                    stack.remove(i)
                else:
                    stack.append(i)
                k += 1
            label = recs[stack[-1]][0] if stack else None
            by[label] = by.get(label, 0) + s - end
        end = e if end is None else max(end, e)
    return by
