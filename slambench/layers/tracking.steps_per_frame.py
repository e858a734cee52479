"""tracking.steps_per_frame: ``frame_step`` runs a tracked frame over the
window, from the program's counters (``track_steps`` over ``track_frames``):
1 plus the wide-window retries and the reference-keyframe fallback's step.
Moves frames_per_s."""

from slambench import program_spans

SPANS = program_spans.SPANS


def read(run):
    n = run.counter("track_frames")
    if n == 0:
        return None
    return run.counter("track_steps") / n
