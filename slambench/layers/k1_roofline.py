"""k1_roofline: K1's share of its H100 floor. The floor of each call of
``ops.fused_match.fused_projection_match`` is counted from its shapes and
inputs (``stats.k1_ops`` / ``stats.k1_bytes``: every pair's window test and
the distance of every pair inside the windows); the time is that of every
device activity launched under the call's range, so the share reads the
same work whatever implements it. Moves frames_per_s."""

from slambench import stats


def capture(args, kwargs):
    desc_a, a_par, desc_b, b_par = args
    return a_par, b_par


SPANS = [("pslam_tpu_torch.ops.fused_match:fused_projection_match", "k1", capture)]


def pairs_in_window(a_par, b_par) -> int:
    """How many pairs pass K1's windows and flags: the distances its inputs
    need (``chip_smoke._k1_pairs_in_window``)."""
    import torch

    au, av, ar, alo, ahi = (a_par[k][:, None] for k in range(5))
    bu, bv, bl = (b_par[k][None, :] for k in range(3))
    mask = ((torch.abs(au - bu) <= ar) & (torch.abs(av - bv) <= ar) & (bl >= alo)
            & (bl <= ahi) & (a_par[5][:, None] > 0.5) & (b_par[3][None, :] > 0.5))
    return int(mask.sum())


def read(run):
    if run.trace is None:
        return None
    acts = run.trace.under("k1")
    calls = run.spans.captured.get("k1", [])
    if not acts or not calls:
        return None
    floor = sum(stats.floor_s(stats.k1_bytes(a.shape[1], b.shape[1]),
                              stats.k1_ops(a.shape[1], b.shape[1], pairs_in_window(a, b)))
                for a, b in calls)
    device_s = sum(e - s for _, s, e, _ in acts) / 1e9
    return 100.0 * floor / device_s
