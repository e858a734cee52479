"""pipeline.launches_per_frame: device activities (kernels, copies, fills)
launched under ``SlamSystem.track_rgbd_pipelined`` or under the
``_finish_pipelined`` of the closing ``finish()``, less those under
``_create_keyframe``, over the profiled calls: each profiled frame's
dispatch and its finish. Moves frames_per_s."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem.track_rgbd_pipelined", "pipeline"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._finish_pipelined", "pipeline.finish"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._create_keyframe", "mapping"),
]


def read(run):
    if run.trace is None:
        return None
    frames = len(run.trace.ranges.get("pipeline", ()))
    if frames == 0:
        return None

    def ids(name):
        return {id(a) for a in run.trace.under(name)}

    return len((ids("pipeline") | ids("pipeline.finish")) - ids("mapping")) / frames
