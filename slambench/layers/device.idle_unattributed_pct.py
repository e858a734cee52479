"""device.idle_unattributed_pct: the share of the profiled frames' device
idle (the gaps between activities) whose gap began while the host was in
no program span below ``frame``, ``track``, ``track.step`` and ``mapping``:
in their own time, or outside every frame. What no stage span explains.
Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    fr = program_spans.frames(run)
    if fr is None:
        return None
    by = program_spans.idle_by_span(run, fr)
    total = sum(by.values())
    if total == 0:
        return None
    loose = sum(ns for name, ns in by.items()
                if name is None or name in program_spans.CONTAINERS)
    return 100.0 * loose / total
