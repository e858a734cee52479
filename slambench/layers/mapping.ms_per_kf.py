"""mapping.ms_per_kf: host ms a keyframe in ``SlamSystem._create_keyframe``
(the commit of the previous keyframe's backend, insertion, new points, line
and LIL mapping, culling, the dispatch of triangulation, fuse and local BA,
keyframe culling and loop detection). Moves frame_ms_p90."""

SPANS = [("pslam_tpu_torch.pipeline.system:SlamSystem._create_keyframe", "mapping")]


def read(run):
    n = run.spans.count("mapping")
    if n == 0:
        return None
    return run.spans.total_s("mapping") / n * 1e3
