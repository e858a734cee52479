"""tracking.launches_per_frame: device activities (kernels, copies, fills)
launched under the tracking span, less those under the keyframe span, a
tracked frame of the profiled frames; read from the raw profiler trace.
Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem._track_fused", "tracking"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._create_keyframe", "mapping"),
]


def read(run):
    if run.trace is None:
        return None
    frames = len(run.trace.ranges.get("tracking", ()))
    if frames == 0:
        return None
    n = len(run.trace.under("tracking")) - len(run.trace.under("mapping"))
    return n / frames
