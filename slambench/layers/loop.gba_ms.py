"""loop.gba_ms: host ms a global BA after a loop correction
(``pipeline/global_ba.py`` ``run_global_ba``, as the loop closer calls it)
over the window's calls. Moves loop_stall_ms."""

SPANS = [("pslam_tpu_torch.pipeline.loop_closing:run_global_ba", "loop.gba")]


def read(run):
    n = run.spans.count("loop.gba")
    if n == 0:
        return None
    return run.spans.total_s("loop.gba") / n * 1e3
