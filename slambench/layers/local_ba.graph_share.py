"""local_ba.graph_share: the share of the window's local BAs that ran as one
replay of a captured CUDA graph (``solver/local_ba.BA_GRAPHS``), from the
program's counters: ``ba_graph_replays`` (counted where the solve is
dispatched) over ``ba_runs`` (counted at its commit). A program that counts
no replays reads nothing. Moves frame_ms_p90."""

SPANS = []


def read(run):
    n = run.counter("ba_runs")
    if n == 0 or "ba_graph_replays" not in run.counters:
        return None
    return run.counter("ba_graph_replays") / n
