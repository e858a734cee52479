"""tracking.wait_ms_per_frame: host ms of the program's ``track.readback``
spans (the 24-float summary read after each ``frame_step``, where the host
waits for the device) over its ``track`` spans, window frames. Moves
frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("track.readback",), "track")
