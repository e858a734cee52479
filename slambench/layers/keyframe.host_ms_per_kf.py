"""keyframe.host_ms_per_kf: host ms of the program's ``keyframe.readback``
(the frame's feature arrays and associations read back) and
``keyframe.snapshot`` (a new tracker view of the map uploaded) spans over
its ``mapping`` spans, window frames: the keyframe work that the tracking
span holds. Moves frame_ms_p90."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("keyframe.readback", "keyframe.snapshot"), "mapping")
