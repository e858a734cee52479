"""tracking.pose_ms_per_step: host ms of the program's ``track.pose`` spans
(``pose_optimization``: the LM rounds, K2 and the robust re-weighting) that
lie under a ``track.step``, over the ``track.step`` spans, window frames.
Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    fr = program_spans.frames(run)
    if fr is None:
        return None
    n = fr.count(fr.window, "track.step")
    poses = fr.pose_in_steps(fr.window)
    if n == 0 or not poses:
        return None
    return sum(fr.records[i][2] - fr.records[i][1] for i in poses) / 1e6 / n
