"""loop.ms_per_kf: host ms a keyframe in the loop closer's
``on_new_keyframe`` (BoW query of the keyframe database, loop candidates,
and any correction). Moves frame_ms_p90."""

SPANS = [("pslam_tpu_torch.pipeline.loop_closing:LoopCloser.on_new_keyframe", "loop")]


def read(run):
    n = run.spans.count("loop")
    if n == 0:
        return None
    return run.spans.total_s("loop") / n * 1e3
