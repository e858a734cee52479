"""device.idle_pct: the share of the profiled frames' window in which no
device activity ran (100 minus the union of activity intervals over the
window). Moves frames_per_s."""

SPANS = []


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
