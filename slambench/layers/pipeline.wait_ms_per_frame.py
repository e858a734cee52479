"""pipeline.wait_ms_per_frame: host ms in ``SlamSystem._end_read`` (the
wait on the event behind a frame's summary copy, and the copy to numpy),
over the window's finished frames: the host blocked on the device despite
the pipeline. Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem._end_read", "pipeline.wait"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._finish_pipelined", "pipeline.finish"),
]


def read(run):
    n = run.spans.count("pipeline.finish")
    if n == 0 or run.spans.count("pipeline.wait") == 0:
        return None
    return run.spans.total_s("pipeline.wait") / n * 1e3
