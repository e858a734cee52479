"""k2_roofline: K2's share of its H100 floor. The floor of each call of
``ops.fused_pose.pose_terms`` (as ``solver.pose_opt`` resolves it) is
counted from its edge count (``stats.k2_ops`` / ``stats.k2_bytes``); the
time is that of every device activity launched under the call's range.
Moves frames_per_s."""

from slambench import stats


def capture(args, kwargs):
    return int(args[0].shape[1])


SPANS = [("pslam_tpu_torch.solver.pose_opt:pose_terms", "k2", capture)]


def read(run):
    if run.trace is None:
        return None
    acts = run.trace.under("k2")
    calls = run.spans.captured.get("k2", [])
    if not acts or not calls:
        return None
    floor = sum(stats.floor_s(stats.k2_bytes(e), stats.k2_ops(e)) for e in calls)
    device_s = sum(e - s for _, s, e, _ in acts) / 1e9
    return 100.0 * floor / device_s
