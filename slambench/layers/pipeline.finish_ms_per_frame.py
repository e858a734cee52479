"""pipeline.finish_ms_per_frame: host ms a call of
``SlamSystem._finish_pipelined`` (the previous frame's summary waited for,
its retries, state machine and keyframe decision, and its commit) less the
``_create_keyframe`` inside it, over the window's finished frames. Moves
frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem._finish_pipelined", "pipeline.finish"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._create_keyframe", "mapping"),
]


def read(run):
    n = run.spans.count("pipeline.finish")
    if n == 0:
        return None
    return (run.spans.total_s("pipeline.finish") - run.spans.total_s("mapping")) / n * 1e3
