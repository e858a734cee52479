"""mapping.lines_ms_per_kf: host ms of the program's ``mapping.lines`` spans
(line and LIL creation and culls, line triangulation, fuse and stats) over
its ``mapping`` spans, window frames. Moves frame_ms_p90."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    return program_spans.ms_per(run, ("mapping.lines",), "mapping")
