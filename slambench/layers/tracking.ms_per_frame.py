"""tracking.ms_per_frame: host ms a tracked frame in ``SlamSystem._track_fused``
(``_frame_step`` and ``_finish_frame``: frame_step, its retries and the
read-back), less the keyframe span below it. Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem._track_fused", "tracking"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._create_keyframe", "mapping"),
]


def read(run):
    n = run.spans.count("tracking")
    if n == 0:
        return None
    return (run.spans.total_s("tracking") - run.spans.total_s("mapping")) / n * 1e3
