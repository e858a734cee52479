"""tracking.pose_launches_per_step: device activities (kernels, copies,
fills) launched inside the program's ``track.pose`` spans that lie under a
``track.step``, over the ``track.step`` spans of the profiled frames.
Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    fr = program_spans.frames(run)
    if fr is None:
        return None
    n = fr.count(fr.profiled, "track.step")
    poses = program_spans.union((fr.records[i][1], fr.records[i][2])
                                for i in fr.pose_in_steps(fr.profiled))
    if n == 0 or not poses:
        return None
    return sum(program_spans.holds(poses, a[3]) for a in run.trace.activities) / n
