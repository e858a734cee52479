"""loop.sim3_ms: host ms a call of the loop closer's ``compute_sim3`` (BoW
matches, the Sim3 RANSAC and optimization, guided projection matching and
the metric 3D-3D refine) over the window's calls. Moves loop_stall_ms."""

SPANS = [("pslam_tpu_torch.pipeline.loop_closing:LoopCloser.compute_sim3", "loop.sim3")]


def read(run):
    n = run.spans.count("loop.sim3")
    if n == 0:
        return None
    return run.spans.total_s("loop.sim3") / n * 1e3
