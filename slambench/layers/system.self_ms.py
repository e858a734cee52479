"""system.self_ms: host ms a frame spent in ``SlamSystem.track_rgbd`` outside
the tracking span below it (state machine, keyframe decision, trajectory
bookkeeping, the upload of the frame). Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem.track_rgbd", "system"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._track_fused", "tracking"),
]


def read(run):
    n = run.spans.count("system")
    if n == 0:
        return None
    return (run.spans.total_s("system") - run.spans.total_s("tracking")) / n * 1e3
