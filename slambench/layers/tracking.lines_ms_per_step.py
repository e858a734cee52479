"""tracking.lines_ms_per_step: host ms of the program's ``track.lines`` spans
(``make_frame_lines``: the line frontend and the frame's LILs) over its
``track.step`` spans, window frames. Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("track.lines",), "track.step")
