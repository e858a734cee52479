"""Per-stage measurement on the card: the helpers the profiling apps share
(``apps/profile_frame.py``, ``apps/profile_backend.py``, ``apps/roofline.py``).

The JAX package's scripts time a stage as R repetitions inside one jitted
``lax.scan`` and take FLOPs and bytes from XLA's cost analysis. Eager torch
neither fuses nor hoists a stage, so here a stage is a Python callable timed
call by call, and its operations are counted from its shapes by the
formulas below, each written from the algorithm.

``time_stage`` gives one row a call:
- ``event_ms``: the median over ``reps`` calls, each between two CUDA events,
  host enqueue included (what a caller waits);
- ``device_ms`` and ``launches``: the summed time and the count of the
  device activities (kernels, copies, fills) that one ``torch.profiler``
  window records over ``prof_reps`` more calls of the same stage, a call.
  The window is separate because the profiler adds host time to every
  launch: inside it the event times would measure the profiler;
- ``busy`` = ``device_ms / event_ms``;
- ``k1`` / ``k2``: the fused matcher's and fused pose kernel's launches a
  call (their wrappers' counters) over the timed calls;
- ``peak_mib``: the peak device memory while the timed calls ran;
- ``nbytes``: every input tensor read once and every output tensor written
  once, taken from the stage's actual tensors.

Once the windows of one process have held some 300,000 device activities,
the trace drops a few activities of every later window (seen on the H100
with torch 2.11): a stage of thousands of launches loses a negligible share,
a stage of three most of its count. So each app profiles its small stages
first, and ``chip_smoke.py`` runs each app in a process of its own. When
the profiler records no device time the device fields say ``"not
measured"``. On ``device="cpu"`` a row has ``host_ms`` and every device
field ``None``: no number from the CPU stands for the card. A measurement
on ``device="cuda"`` without CUDA raises.

``bound`` gives the H100 floor of a stage: the larger of its bytes over
3.35 TB/s of HBM and its operations over 67 TFLOP/s of f32 outside the
tensor cores (the port keeps TF32 off), the peaks chip_smoke.py uses
(NVIDIA's data sheet, SXM part at 700 W).
"""

from __future__ import annotations

import math
import statistics
import subprocess
import time

import numpy as np
import torch

from pslam_tpu_torch.ops import fused_match, fused_pose

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
SHARE_LIMIT = 1.05  # a share above this means a count is wrong
NOT_MEASURED = "not measured"
NOT_COUNTED = "not counted"

# Operation counts, one unit an add, multiply, compare, select or bit
# operation (a fused multiply-add is two). Integer and bit operations are
# counted at the f32 rate, which no integer unit exceeds.
#
# FAST at two thresholds, a pixel (ops/fast.py fast_score_dual): each of
# the 16 ring pixels takes a difference, 4 threshold compares, |d| - t and
# 2 score accumulations (9); each of the 4 arc masks takes 12 shift/and
# operations (_arc9_from_bits); 2 ORs and the score maximum.
FAST_DUAL_PIXEL_OPS = 16 * 9 + 4 * 12 + 3
# FAST at one threshold (fast_score): a difference, 2 compares, |d| - t and
# 2 accumulations a ring pixel; 2 arc masks; an OR and the maximum.
FAST_PIXEL_OPS = 16 * 7 + 2 * 12 + 2
# 3x3 non-maximum suppression: 8 neighbour maxima and the test.
NMS_PIXEL_OPS = 9
# Separable 7-tap Gaussian: 7 multiply-adds a pass, two passes.
BLUR_PIXEL_OPS = 7 * 2 * 2
# rBRIEF: the angle bin (4) and 256 pixel-pair compares a keypoint.
BRIEF_KEYPOINT_OPS = 4 + 256
# K1 (csrc/fused_match.cu, as chip_smoke.py counts it): the window and
# validity test of every pair.
K1_PAIR_OPS = 9
# K2 per edge (csrc/fused_pose.cu): transform 18, projection, residuals and
# chi2 29, robust weight 6, Jacobian factors 10, Jacobians 26, H 21 x 7, b
# 6 x 7, cost 2.
K2_EDGE_OPS = 280
# One pose solve (solver/pose_opt.py): 4 rounds of 11 K2 calls, a classify
# a round and a final one.
K2_CALLS_A_SOLVE = 49
# Local-BA edge terms (solver/local_ba.py _edge_terms): transform 18,
# stereo projection, residuals and chi2 29, robust weight 6, Jacobian
# factors 10, camera Jacobian 26, point Jacobian 18, the 3 row weights.
BA_TERM_EDGE_OPS = 18 + 29 + 6 + 10 + 26 + 18 + 3
# Local-BA assembly an edge (_assemble), symmetric blocks counted once:
# products over the 3 residual rows for Hcc (21 entries), Hpp (6), Hcp
# (18), bc (6) and bp (3), 2 operations a row each; one weight multiply and
# one add into the target block an entry.
BA_ASSEMBLE_EDGE_OPS = (21 + 6 + 18 + 6 + 3) * 3 * 2 + (21 + 6 + 18 + 6 + 3) * 2
# Hamming distance of one descriptor pair (32 bytes: 8 word XORs, 8
# popcounts, 8 adds) and the row best / second / column minimum compares.
HAMMING_PAIR_OPS = 24 + 4


def pyramid_ops(h: int, w: int, levels: int, scale: float) -> int:
    """Each level from the one before it (ORBextractor.cc:1107-1129):
    a separable 2-tap bilinear resize, a multiply-add a tap, rows then
    columns."""
    shapes = [(int(round(h / scale**l)), int(round(w / scale**l))) for l in range(levels)]
    return sum(4 * (hl * pw + hl * wl)
               for (hl, wl), (_, pw) in zip(shapes[1:], shapes[:-1]))


def angle_ops(n_keypoints: int, patch: int) -> int:
    """IC angle: the two first moments over a patch (a multiply-add a pixel
    each) and the arctangent, counted as one operation."""
    return n_keypoints * (2 * 2 * patch * patch + 1)


def track_ops(n_points: int, n_features: int, n_matches: int) -> int:
    """One tracking step: K1's window test of every valid point-feature pair
    and one pose solve over the matched edges. The distances of the pairs
    inside the windows and the 6x6 solves are left out, so this is a lower
    bound."""
    return K1_PAIR_OPS * n_points * n_features + K2_CALLS_A_SOLVE * K2_EDGE_OPS * n_matches


def schur_landmark_ops(cams_per_point) -> int:
    """``_schur_landmarks``: per point the damped 3x3 inverse (9 + 30), G
    Hpp^-1 for each observing free camera (6 x 3 x 3 multiply-adds), the
    reduced blocks of each pair of its free cameras (6 x 6 x 3 multiply-adds)
    and its share of the reduced right side (6 x 3). Only the camera pairs a
    point joins are counted, as the data needs."""
    k = torch.as_tensor(cams_per_point, dtype=torch.float64)
    return int((39 + 108 * k + 216 * k * k + 36 * k).sum())


def schur_camera_ops(n_free: int) -> int:
    """``_schur_cameras``: damping (2 a diagonal entry) and the dense LU solve
    of the 6F x 6F reduced system (2n^3/3 + 2n^2)."""
    n = 6 * n_free
    return 12 * n_free + math.ceil(2 * n**3 / 3) + 2 * n * n


def back_substitute_ops(cams_per_point) -> int:
    """``_back_substitute``: bp - G^T dx_c (6 x 3 multiply-adds an observing
    free camera) and Hpp^-1 times it (3 x 3 multiply-adds) a point."""
    k = torch.as_tensor(cams_per_point, dtype=torch.float64)
    return int((36 * k + 18 + 3).sum())


def ba_ops(n_edges: int, cams_per_point, n_free: int, schedule=(5, 10)) -> int:
    """A whole local BA: one assembly at each phase's start and one an LM
    iteration (edge terms and assembly), a Schur solve an iteration, and
    the two classifications (edge terms)."""
    iters = sum(schedule)
    step = (schur_landmark_ops(cams_per_point) + schur_camera_ops(n_free)
            + back_substitute_ops(cams_per_point))
    assemblies = iters + len(schedule)
    return (assemblies * n_edges * (BA_TERM_EDGE_OPS + BA_ASSEMBLE_EDGE_OPS)
            + iters * step + len(schedule) * n_edges * BA_TERM_EDGE_OPS)


def cams_per_point(free_slot, cam_idx, pt_idx, edge_valid, n_points: int):
    """(P,) number of distinct free cameras observing each point."""
    slot = free_slot[cam_idx]
    keep = edge_valid & (slot >= 0)
    n_free = int(free_slot.max()) + 1
    pair = torch.unique(pt_idx[keep] * n_free + slot[keep])
    return torch.bincount(pair // n_free, minlength=n_points)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor (or numpy array) in a nest of tuples, lists
    and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def bound(ops, nbytes: int, ms=None) -> dict:
    """The H100 floor of ``ops`` operations (None: not counted) on
    ``nbytes`` bytes: ``floor_ms``, ``bound_by`` and, given the measured
    ``ms``, ``share`` = floor / ms. A share above 1.05 raises: a floor
    above the time taken means a count is wrong."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    if ops is None:
        floor, by = t_bytes, "bytes (ops not counted)"
    else:
        t_ops = ops / PEAK_F32_S * 1e3
        floor, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    share = None if ms is None else floor / ms
    if share is not None and share > SHARE_LIMIT:
        raise ValueError(f"floor {floor:.6f} ms above {SHARE_LIMIT} x the measured {ms:.6f} ms: "
                         "a count is wrong")
    return dict(ops=NOT_COUNTED if ops is None else int(ops), nbytes=int(nbytes),
                floor_ms=floor, bound_by=by, share=share)


def cuda_device(device) -> torch.device:
    """The device to measure on; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the profilers measure the CUDA device by default, and CUDA is not "
                           "available here; pass --device cpu for host times on the CPU")
    return dev


def card_identity(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU's
    label."""
    if torch.device(device).type != "cuda":
        return "CPU (host ms only; no device metric)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _device_activity(prof):
    """(summed device us, number of device activities) of a profiler run,
    read from the raw trace (building the profiler's event tree for the
    ~20,000 activities of a frame takes longer than the frame)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in events) / 1e3, len(events)


def time_stage(fn, *args, reps: int = 20, device="cuda", warmup: int = 2,
               prof_reps: int = 2, profile_fn=None) -> dict:
    """One row of ``fn(*args)``'s cost a call (see the module docstring).
    ``warmup`` calls run first, outside the measurement. ``profile_fn``
    (default ``fn``) is what the profiler window calls: a call that cannot
    be repeated (a tracked frame) is timed on one system and profiled on a
    twin fed the same input, with ``warmup=0, reps=prof_reps=1``."""
    dev = cuda_device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(device="cpu", reps=reps, host_ms=statistics.median(times), event_ms=None,
                    device_ms=None, launches=None, busy=None, k1=None, k2=None, peak_mib=None,
                    nbytes=tensor_bytes(args) + tensor_bytes(out))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    k1, k2 = fused_match.LAUNCHES, fused_pose.LAUNCHES
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        torch.cuda.synchronize(dev)
        times.append(a.elapsed_time(b))
    k1, k2 = (fused_match.LAUNCHES - k1) / reps, (fused_pose.LAUNCHES - k2) / reps
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    event_ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_reps):
            (profile_fn or fn)(*args)
        torch.cuda.synchronize(dev)
    us, n = _device_activity(prof)
    device_ms = us / prof_reps / 1e3 if us > 0 else NOT_MEASURED
    return dict(
        device=torch.cuda.get_device_name(dev), reps=reps, host_ms=None, event_ms=event_ms,
        device_ms=device_ms, launches=n / prof_reps if us > 0 else NOT_MEASURED,
        busy=device_ms / event_ms if us > 0 else NOT_MEASURED, k1=k1, k2=k2, peak_mib=peak,
        nbytes=tensor_bytes(args) + tensor_bytes(out))


def measured_ms(row) -> float:
    """The time a row's share is taken against: event ms on the card, host
    ms on the CPU (where ``bound`` gives no share)."""
    return row["event_ms"] if row["event_ms"] is not None else row["host_ms"]


def stage_row(name: str, fn, *args, ops=None, reps: int = 20, device="cuda",
              warmup: int = 2, prof_reps: int = 2, profile_fn=None, **extra) -> dict:
    """``time_stage`` plus the floor of ``ops`` (an int, or None: not
    counted) on the stage's bytes; the share only on the card."""
    row = dict(name=name, **time_stage(fn, *args, reps=reps, device=device, warmup=warmup,
                                       prof_reps=prof_reps, profile_fn=profile_fn))
    row.update(bound(ops, row["nbytes"], row["event_ms"]), **extra)
    return row


def _fmt(x, digits=4):
    if x is None:
        return "-"
    if isinstance(x, str):
        return x
    return f"{x:.{digits}f}" if isinstance(x, float) else str(x)


def table(rows, title: str, device) -> str:
    """A markdown table of ``rows`` under a header naming the card."""
    cols = ("event_ms", "host_ms", "device_ms", "launches", "busy", "k1", "k2", "peak_mib",
            "ops", "nbytes", "floor_ms", "bound_by", "share")
    extra = [k for r in rows for k in r if k not in cols + ("name", "device", "reps")]
    extra = list(dict.fromkeys(extra))
    head = ["stage", *cols, *extra]
    lines = [f"# {title}", "", f"Card: {card_identity(device)}", "",
             "| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for r in rows:
        lines.append("| " + " | ".join([r["name"]] + [_fmt(r.get(k)) for k in cols + tuple(extra)])
                     + " |")
    return "\n".join(lines) + "\n"
