"""local_ba.ms_per_call: host ms a local BA, from its assembly and dispatch
(``SlamSystem._run_local_ba``) to its read-back and write-back at the next
keyframe event (``SlamSystem._commit_pending_ba``), over the BAs committed.
Moves frame_ms_p90."""

SPANS = [
    ("pslam_tpu_torch.pipeline.system:SlamSystem._run_local_ba", "local_ba"),
    ("pslam_tpu_torch.pipeline.system:SlamSystem._commit_pending_ba", "local_ba_commit"),
]


def read(run):
    n = run.counter("ba_runs")
    if n == 0:
        return None
    return (run.spans.total_s("local_ba") + run.spans.total_s("local_ba_commit")) / n * 1e3
