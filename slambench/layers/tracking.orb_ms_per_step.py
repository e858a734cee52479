"""tracking.orb_ms_per_step: host ms of the program's ``track.orb`` spans
(``make_frame``: ORB extraction, depth, descriptors) over its ``track.step``
spans, window frames. Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("track.orb",), "track.step")
