"""loop.essential_graph_ms: host ms a call of
``LoopCloser._run_essential_graph`` (the edge set and the Sim3 pose-graph
solve, ``solver/sim3_graph.py``) over the window's calls. Moves
loop_stall_ms."""

SPANS = [("pslam_tpu_torch.pipeline.loop_closing:LoopCloser._run_essential_graph",
          "loop.essential_graph")]


def read(run):
    n = run.spans.count("loop.essential_graph")
    if n == 0:
        return None
    return run.spans.total_s("loop.essential_graph") / n * 1e3
