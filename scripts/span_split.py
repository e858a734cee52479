"""The program's spans in one traced benchmark run, split further than the
result line shows; on one NVIDIA GPU, from the root of a checkout.

    python3 scripts/span_split.py --workload lil-fr1desk --seed 7 [--seconds 51] [--off]
    python3 scripts/span_split.py --span-cost

Runs one cell of ``BENCHMARK.json`` as ``slambench/run.py --trace 1`` runs
it and prints JSON lines:

- ``metrics``: the result line's per-layer metrics, ``correct`` and the
  device;
- ``track_vs_tracking``: the program's ``track`` spans over the window
  against the harness's wrapped ``SlamSystem._track_fused`` (one boundary
  timed twice), and the program's spans a window frame;
- ``window_spans``: each span name's count and host ms over the window;
- ``clock``: how far each program span's ``record_function`` event of the
  profiler window lies outside the span's recorded interval (largest, ns),
  the share of the device activities launched under the harness's ``k2``
  ranges (``pose_terms`` calls, stamped by the profiler) that the program's
  ``track.pose`` spans (stamped by ``time.time_ns``) hold, and the least
  time from a pose span's start to the launch of an activity it holds;
- ``idle_by_span``: the profiled frames' device idle seconds by the
  innermost program span the host was in when each gap began.

``--off`` turns the recorder off once the readers are loaded: the same
traced run without the program's spans, for what recording costs
(``tracking.ms_per_frame`` on against off). ``--span-cost`` times one
``span()`` call with the recorder off and on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> dict:
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "nvidia_smi": smi}


def span_cost() -> dict:
    from pslam_tpu_torch.utils.trace import RECORDER, span

    def per_call(n: int) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("track.pose"):
                pass
        return (time.perf_counter_ns() - t) / n

    def empty(n: int) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t) / n

    RECORDER.disable()
    loop = empty(1_000_000)
    off = per_call(1_000_000)
    RECORDER.clear()
    RECORDER.enable()
    with span("frame", frame=0):
        on = per_call(100_000)
    RECORDER.disable()
    RECORDER.clear()
    return {"span_cost_ns": {"off": off, "on": on, "empty_loop": loop}}


def run_cell(workload: str, seed: int, seconds: float, off: bool):
    from torch.autograd import DeviceType

    from slambench import harness, program_spans
    from slambench import trace as btrace

    seen = {}
    real_device_trace, real_layer_run = btrace.device_trace, harness.LayerRun

    def device_trace(prof, window_s, **kw):
        names = {r[0] for r in program_spans.RECORDER.records()}
        seen["events"] = sorted((e.name(), e.start_ns(), e.end_ns())
                                for e in prof.profiler.kineto_results.events()
                                if e.device_type() == DeviceType.CPU and e.name() in names)
        return real_device_trace(prof, window_s, **kw)

    class LayerRun(real_layer_run):
        def __init__(self, *a):
            super().__init__(*a)
            seen["run"] = self

    btrace.device_trace, harness.LayerRun = device_trace, LayerRun
    if off:
        real_reader = harness.layer_reader

        def layer_reader(name):
            r = real_reader(name)
            program_spans.RECORDER.disable()
            return r

        harness.layer_reader = layer_reader
    result = harness.run(workload, seed, seconds, True)
    print(json.dumps({"workload": workload, "seed": seed, "recorder": not off,
                      "correct": result["correct"], "device": result["device"],
                      "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                      "breakdown": result.get("breakdown")}), flush=True)
    if off:
        return
    run = seen["run"]
    fr = program_spans.frames(run)
    if fr is None:
        print(json.dumps({"frames": None}))
        return
    recs = fr.records
    n_frames = fr.count(fr.window, "frame")
    print(json.dumps({"track_vs_tracking": {
        "program_track_ms": fr.total_ms(fr.window, "track"),
        "harness_tracking_ms": run.spans.total_s("tracking") * 1e3,
        "program_track_spans": fr.count(fr.window, "track"),
        "harness_tracking_spans": run.spans.count("tracking"),
        "window_frames": n_frames, "spans_per_window_frame": len(fr.window) / n_frames,
    }}), flush=True)

    totals = {}
    for i in fr.window:
        c, ms = totals.get(recs[i][0], (0, 0.0))
        totals[recs[i][0]] = (c + 1, ms + (recs[i][2] - recs[i][1]) / 1e6)
    print(json.dumps({"window_spans": totals}), flush=True)

    by_name = {}
    for name, s, e in seen["events"]:
        by_name.setdefault(name, []).append((s, e))
    outside, matched = 0, 0
    for name in {recs[i][0] for i in fr.profiled}:
        mine = sorted((recs[i][1], recs[i][2]) for i in fr.profiled if recs[i][0] == name)
        if len(mine) != len(by_name.get(name, ())):
            raise AssertionError(f"{name}: {len(mine)} spans, "
                                 f"{len(by_name.get(name, ()))} profiler events")
        for (t0, t1), (s, e) in zip(mine, by_name[name]):
            outside = max(outside, t0 - s, e - t1)
            matched += 1
    pose_all = program_spans.union((recs[i][1], recs[i][2]) for i in fr.profiled
                                   if recs[i][0] == "track.pose")
    k2 = run.trace.under("k2")
    steps = fr.pose_in_steps(fr.profiled)
    lead = []
    for a in run.trace.activities:
        for i in steps:
            if a[3] is not None and recs[i][1] <= a[3] <= recs[i][2]:
                lead.append(a[3] - recs[i][1])
                break
    print(json.dumps({"clock": {
        "record_function_outside_ns_max": outside, "events_matched": matched,
        "k2_activities": len(k2),
        "k2_held_by_pose_share": (sum(program_spans.holds(pose_all, a[3]) for a in k2)
                                  / len(k2)) if k2 else None,
        "pose_spans": len(steps), "pose_activities": len(lead),
        "pose_launch_after_start_ns_min": min(lead) if lead else None,
    }}), flush=True)
    by = program_spans.idle_by_span(run, fr)
    print(json.dumps({"idle_by_span": {
        "total_s": sum(by.values()) / 1e9,
        "spans": sorted(([k or "outside frames", v / 1e9] for k, v in by.items()),
                        key=lambda kv: -kv[1]),
    }}), flush=True)


def main() -> int:
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--off", action="store_true")
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args()
    print(json.dumps(card()), flush=True)
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
    if args.workload:
        run_cell(args.workload, args.seed, args.seconds, args.off)
    return 0


if __name__ == "__main__":
    sys.exit(main())
