"""backend.ms_per_kf: host ms of the program's ``backend.dispatch``
(epipolar triangulation and neighbour fuse queued) and ``backend.commit``
(their results read back and written to the map at the next keyframe)
spans over its ``mapping`` spans, window frames. Moves frame_ms_p90."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("backend.dispatch", "backend.commit"), "mapping")
