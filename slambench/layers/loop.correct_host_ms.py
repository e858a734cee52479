"""loop.correct_host_ms: host ms a call of ``LoopCloser.correct_loop`` less
the essential graph and the global BA inside it: the Sim3 warps of the
group's poses and landmarks, the fuse, covisibility and the landmark
correction. Moves loop_stall_ms."""

SPANS = [
    ("pslam_tpu_torch.pipeline.loop_closing:LoopCloser.correct_loop", "loop.correct"),
    ("pslam_tpu_torch.pipeline.loop_closing:LoopCloser._run_essential_graph",
     "loop.essential_graph"),
    ("pslam_tpu_torch.pipeline.loop_closing:run_global_ba", "loop.gba"),
]


def read(run):
    n = run.spans.count("loop.correct")
    if n == 0:
        return None
    inner = run.spans.total_s("loop.essential_graph") + run.spans.total_s("loop.gba")
    return (run.spans.total_s("loop.correct") - inner) / n * 1e3
