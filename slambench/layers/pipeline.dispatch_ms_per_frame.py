"""pipeline.dispatch_ms_per_frame: host ms a call of
``SlamSystem.track_rgbd_pipelined`` less the ``_finish_pipelined`` inside
it: the upload of the frame and the enqueue of its ``frame_step``, chained
off the frame in flight, with its asynchronous read-back started. Over the
window's calls, one a frame handed over. Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem.track_rgbd_pipelined", "pipeline"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._finish_pipelined", "pipeline.finish"),
]


def read(run):
    n = run.spans.count("pipeline")
    if n == 0:
        return None
    return (run.spans.total_s("pipeline") - run.spans.total_s("pipeline.finish")) / n * 1e3
