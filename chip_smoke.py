"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the smoke run below
    python3 chip_smoke.py --measure ROOT  # phases 0-3 and both slices timed,
                                          # with the pslam_tpu_torch at ROOT

Phases (each prints one line of evidence; any failure ends the run with a
non-zero exit and no result line):

0. identity: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
1. build: both CUDA kernels compiled from ``pslam_tpu_torch/csrc`` by nvcc,
   one nvcc each, started together; ``-Xptxas -v`` must report no spill for
   K2.
2. K1 (fused projection matcher) against its plain PyTorch version on the
   card, every output exactly equal (ties included, ``col_argmin`` wherever
   the column has a candidate): the main-path shape (4096 map points x 1000
   features), (200, 300), planted equal distances in different column slabs
   of one row, the ragged shapes (4097, 1), (1, 1000) and (4096, 257), and
   two launches of one input bit-identical. Times: median of 20 calls between
   CUDA events, device time per call from torch.profiler, and the bound.
3. K2 (fused pose terms) against its plain version within the
   tests/test_pallas_pose.py tolerances at E = 4096 (Huber on and off), 128
   and 8192, and at E = 4096 with every edge mono (``obs_ur = -1``, the
   monocular path) off the truth and at it; chi2 within the 1e-4 bar, and
   in the all-mono case at the truth alone within that bar plus a per-edge
   bound on the f32 rounding of the pixel coordinates
   (``_k2_chi2_bound``); an all-inactive input gives H = 0,
   b = 0 and cost = 0 exactly;
   two launches of one input bit-identical. Times and bound as in phase 2.
3b. the LM step (the second kernel of ``csrc/fused_pose.cu``) against
   ``lm_step_plain`` on 264 random states, every mix of first evaluation,
   accept / reject / NaN evaluation, closing step and LIL terms: the state
   rows bit-identical (so every accept / reject decision equal), the
   proposals within rtol 2e-4 / atol 1e-5; whole ``pose_optimization``
   solves on the card against the CPU (rotation and translation <= 1e-4,
   inlier masks equal; N = 300, 1000, 4096, with 8 LILs, and from the
   identity with the unmatched slots at the origin), 49 K2 and 44 LM
   launches a solve; 98 K2 and 88 LM launches (``stats["pose_lm_steps"]``)
   a one-step frame of the 320x240 configs 1 and 3; the step's times.
3c. the local BA through ``solver/local_ba.BA_GRAPHS`` (one captured CUDA
   graph a problem shape) at the main path's capacities (48 cameras, 16
   free, 4096 points, 16384 edges; and half of that), point and LIL
   solvers: four problems of one key and two of another, each call's result
   bit-identical to the eager solver's on the same fixed-width tables; 1
   eager call, 1 capture and 1-2 replays a key; a result held across two
   replays of its graph unchanged; the first problem's solve on the card
   against the CPU's (exact-width tables): the differences printed, poses
   within 1e-2 and >= 99% of the inlier flags equal; host ms a call (eager,
   capture, replay), peak memory before and after, and a replay's time
   between CUDA events.
4. the slice: ``SlamSystem(SlamConfig(use_lines=False, use_bow=False,
   use_loop_closing=False), device="cuda")`` at 640x480 with default
   capacities over 60 synthetic frames; every frame tracked, >= 3 keyframes,
   >= 1 local BA, ATE < 5 cm, and the launch counters prove that every
   tracked frame went through all three kernels (2 K1, 98 K2 and 88 LM
   steps at least), ``stats["pose_lm_steps"]`` equal to the LM launches.
5. the same slice, small (320x240, 8 frames), on the card and on the CPU:
   the same tracking states and keyframes, camera centres within 2 cm.
6. the structural-line slice: ``SlamSystem(SlamConfig(use_bow=False,
   use_loop_closing=False), device="cuda")`` (BASELINE config 3: lines,
   LILs, the LIL composite error in the pose solve and the joint point + LIL
   local BA) at 640x480 with default capacities and line settings over 60
   frames; every frame tracked, >= 3 keyframes, >= 1 local BA with LIL
   edges, map lines, LIL landmarks with one re-observed, ATE < 5 cm, and
   every tracked frame through all three kernels, as in phase 4.
7. the structural-line slice, small (320x240, 8 frames, 8 px line tiles),
   twice on the card and once on the CPU: the two card runs bit-identical
   (poses and every map array), card vs CPU the same states and keyframes
   with camera centres within 2 cm.
8. relocalization: the kidnap of tests/test_relocalization.py on the card
   (``SlamConfig(use_lines=False)`` with BoW, ``reset_if_lost_with_kfs=0``,
   ``kf_max_interval=3``, 640x480): 10 arc frames, then the tracker is
   declared LOST and shown frame 3 again. One relocalization, the centre
   within 5 cm of the truth, the next frame OK, and all three kernels
   launched by the relocalization call.
9. loop closing, card vs CPU: the hand-built drifted world of
   tests/test_loop_closing.py (built in numpy with the port's ``se3_exp`` and
   ``project``) through ``LoopCloser.on_new_keyframe``, twice on the card and
   once on the CPU. The card runs bit-identical (poses and every map array),
   the same closing keyframe and stats on card and CPU, keyframe poses
   within 1e-3, the closing keyframe within 0.03 of its true pose, the fused
   points' median distance to cloud A below 0.05 m.
10. BASELINE config 4: ``SlamSystem(SlamConfig())`` (points, lines, LILs,
   BoW, loop closing and global BA) at full width on the JAX package's loop
   circuit (160 frames of ``loop_trajectory`` in a ``ClosedRoom``, as
   scripts/eval_loop_tpu.py builds it) through ``track_rgbd``: every frame
   OK, at least one loop handled (detected, then corrected or fused), one
   global BA per correction, corrected ATE < 5 cm. Prints the times (median
   ms/frame, keyframe frames, each loop event), keyframes, online and
   corrected ATE, peak device memory and launches per tracked frame.
11. stereo: ``SlamSystem(SlamConfig(sensor="stereo", use_lines=False,
   use_lils=False, use_bow=False, use_loop_closing=False)).track_stereo`` at
   640x480 over 60 frames of ``render_stereo_sequence``: every frame OK,
   >= 3 keyframes, >= 1 local BA, ATE < 6 cm (tests/test_round5.py's bar),
   the median relative stereo depth error on tests/test_round5.py's frame
   (``BoxRoom(seed=1)``) < 2% against the rendered depth, every tracked
   frame through all three kernels.
12. monocular: ``track_mono`` with ``SlamConfig(sensor="mono",
   use_lines=False, use_loop_closing=False)`` at 640x480 on
   tests/test_round4.py's sequence (``render_sequence(n_frames=14,
   seed=6)``; a 30-frame render is another arc, 14/30 the step, on which
   both packages initialize only at frame 16 and miss the bar): the two-view
   initialization succeeds and every later frame is OK, every keyframe depth
   is 0, scale-aligned ATE < 8 cm, all three kernels on every all-mono frame;
   then ``initialize_two_view`` twice on the card on the run's own input:
   bit-identical, or the difference printed and held below 1e-5.
13. localization-only mode: tests/test_round5.py's excursion
   (``SlamConfig(use_lines=False, use_lils=False)``, 640x480, the frozen map
   out of view): >= 3 visual-odometry frames, <= 4 LOST, ends OK out of VO
   mode; then tests/test_round4.py's freeze with the default config: no
   keyframe and no point inserted over 50 frames, a blackout ends LOST
   without a reset, a revisited view relocalizes.
14. pipelined: config 1 over the 60-frame arc through
   ``track_rgbd_pipelined`` + ``finish()``, beside a synchronous run: 60
   trajectory rows, ATE < 5 cm and < max(2.5 x sync, 3 cm), the mixed-mode
   drain of tests/test_round4.py, every tracked frame through all three
   kernels and ``stats["pose_lm_steps"]`` equal to the LM launches in both
   runs. Prints both runs' median ms per call and wall ms/frame (no bar).
15. checkpoint: ``save_checkpoint`` / ``load_checkpoint`` on the card of the
   phase-14 system and of phase 13's frozen config-4 system: every map array
   and the poses equal after the load; the resumed config-4 system (which
   starts LOST, as in the JAX package) relocalizes and tracks 5 more frames
   OK. Config 1 has no place recognition, so a resumed config-1 system cannot
   relocalize; it is checked by its arrays only.
16. the TUM app: tests/test_tum_io.py's distorted dataset (the TUM1 lens,
   ``render_sequence(n_frames=12, seed=4, use_distortion=True)``, 640x480)
   written as PNGs by this script's own minimal writer (the card's machine
   has no PIL), then ``apps.rgbd_tum.main`` on the card twice: with
   ``--no-lines --no-loop --kitti`` and with its default flags (config 4 from
   the settings file). Each: every frame OK, f/kf (and KITTI) files of the
   right shapes, ATE < 5 cm, every tracked frame through all three kernels; prints
   the app's tracking-time summary and StageTimers report beside phase 4's
   median, and the PNG decode time. ``dump_map_ply`` and ``dump_map_npz`` of
   run 2's map, the NPZ read back equal to the map's arrays.
17. distribution at world size 1: a one-rank NCCL group (``file://`` init;
   no NCCL is a failure). The sharded point BA, LIL BA and essential graph
   (``parallel/``) on tests/test_parallel.py's problems, built here in
   numpy, bit-identical to the single-device solvers, with both times; then
   config 1 with ``distributed=True`` over phase 4's 60 frames, its
   trajectory bit-identical to phase 4's and every tracked frame through both
   kernels. The group is destroyed at the end.
18. the long run: ``apps.run_long.run`` pipelined with the default config
   (BASELINE config 4) over 300 frames of its double-loop circuit
   (``loop_trajectory(300, loops=2.0)`` in ``ClosedRoom(seed=9)``, 640x480):
   no reset, at least one loop closed, at least one keyframe culled, at
   least one keyframe slot reused (``kf_inserted`` above the slots ever
   used), ATE < 10 cm (scripts/run_long.py's bar), every tracked frame
   through all three kernels. Prints the evaluation row (times, peak device
   memory, K1, K2 and LM step launches per tracked frame).
19. the low-texture ladder: ``apps.lowtex.run`` at its default 120 frames
   (points, +lines, +LILs in ``LowTextureRoom(seed=5)``): every config
   completes with a finite ATE; the +lines and +LILs runs hold map lines,
   unless the system never initialized and no frame of the scene carries
   the depth-backed features the RGB-D initialization needs (then no
   kernel runs: nothing is tracked). Prints the three rows; no bar on which
   config wins.
20. the stage profilers at full width: ``apps.profile_frame.run``,
   ``apps.profile_backend.run`` and ``apps.roofline.run`` on the card, each
   table printed under the card's ``nvidia-smi`` name and power limit (and
   written to ``build/chip_smoke/``), each app in a spawned process of its
   own (the profiler's trace degrades late in a long-profiled process), its
   kernel launches counted in its rows. Every row finite, ``event_ms > 0``,
   ``device_ms <= 1.05 x event_ms`` where the profiler measured it, every
   share <= 1.05; ``track_against_points`` (and the roofline's match+pose)
   1 K1 and 49 K2 launches a call; ``frame_step (real map)`` at least 2 K1
   and 98 K2 a frame, as phase 4; the one-rank sharded rows bit-identical to
   the plain ones (``max|dT|`` = 0).

The kernels' launch counters (K1, K2 and the LM step) are set to 0 just
before each main path
(phases 4, 6, 10-14, 16-19, the relocalization call of phase 8 and the
resumed frames of phase 15) and read just after. The line before the last is a JSON
object with one entry per kernel, its launches summed over those paths; the
last line is ``{"ok": true, "device": {...}}``.

``--measure ROOT`` compares two trees on one card: it imports
``pslam_tpu_torch`` from ROOT (for example a ``git archive`` of the parent
commit unpacked under ``build/``), runs phases 0-3 with this script's
checks, then both 60-frame slices with torch.profiler over frames 15-29,
and prints one JSON line: the kernels' times, each slice's median ms/frame
(frames 5+ outside the profiled window) and its device time per frame.
Run it in turns (parent, change, change, parent) inside one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM bytes/s and f32
# operations/s outside the tensor cores. A bound is the larger of the bytes a
# call must move (each input read once, each output written once) over the
# first and the operations it does over the second.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# K1: the window and validity test of every pair (2 subtractions, 2
# absolutes, 2 radius and 2 octave comparisons, 1 flag test) and the distance
# of every pair that passes it (8 XOR, 8 popcounts, 8 adds). The integer
# operations are counted at the f32 rate, which no integer unit exceeds.
K1_PAIR_OPS = 9
K1_CAND_OPS = 24
# K2 per edge, counted from csrc/fused_pose.cu: transform 18, projection,
# residuals and chi2 29, robust weight 6, Jacobian factors 10, Jacobians 26,
# H 21 x 7, b 6 x 7, cost 2.
K2_EDGE_OPS = 280
KERNELS = ("fused_match", "fused_pose")


def _identity():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"[0 identity] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def _median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_us(prof):
    """(summed device time in us, number of device activities) of a
    torch.profiler run: the CUDA kernels and copies, without host gaps."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events), len(events)


def _device_ms(fn, runs: int = 20):
    """Device time per call (ms) from torch.profiler; None when the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us, _ = _device_us(prof)
    return us / runs / 1e3 if us > 0 else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _host_us(fn, calls: int = 200) -> float:
    """Host time per call (us) of ``calls`` back-to-back calls: what the
    wrapper and its launches cost the host, the device keeping up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _bound(n_bytes, n_ops):
    """(least ms the card could take, the side that sets it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _timings(kernel, plain, n_bytes, n_ops):
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return dict(ms=_median_ms(kernel), plain_ms=_median_ms(plain),
                device_ms=_device_ms(kernel), plain_device_ms=_device_ms(plain),
                host_us=_host_us(kernel), bound_ms=bound_ms, bound_by=bound_by)


def _fmt_timings(t):
    return (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (median of 20 calls); "
            f"device time kernel {_fmt_ms(t['device_ms'])}, plain "
            f"{_fmt_ms(t['plain_device_ms'])} per call; kernel host enqueue "
            f"{t['host_us']:.1f} us a call; bound {t['bound_ms'] * 1e3:.4f} us "
            f"({t['bound_by']})")


def _phase_build(_build, check_spill):
    """Both kernels, one nvcc each, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(_build.library, name) for name in KERNELS]:
            fut.result()
    for name in KERNELS:
        secs, log = _build.BUILD_INFO[name]
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[1 build] {name}: nvcc {secs:.1f} s; " + " | ".join(regs[:6]))
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                         _build.BUILD_INFO["fused_pose"][1])]
    print(f"[1 build] both kernels ready in {time.perf_counter() - t0:.1f} s; "
          f"K2 spill bytes {spills}")
    if check_spill and (not spills or any(spills)):
        raise AssertionError(f"K2 spills registers (or ptxas said nothing): {spills}")


def _match_case(na, nb, seed):
    """Random descriptors with planted near-duplicates inside the windows
    (the generator of tests/test_torch_fused_match.py)."""
    rng = np.random.default_rng(seed)
    desc_a = rng.integers(0, 256, (na, 32), dtype=np.uint8)
    desc_b = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    plant = rng.permutation(min(na, nb))[: min(na, nb) // 2]
    for i, j in enumerate(plant):
        desc_b[j] = desc_a[i]
        desc_b[j, rng.integers(0, 32)] ^= np.uint8(1 << rng.integers(0, 8))
    uv_a = rng.uniform(0, 640, (na, 2)).astype(np.float32)
    uv_b = uv_a[rng.integers(0, na, nb)] + rng.normal(0, 6, (nb, 2)).astype(np.float32)
    lev_a = rng.integers(0, 8, na).astype(np.int32)
    lev_b = rng.integers(0, 8, nb).astype(np.int32)
    for i, j in enumerate(plant):
        uv_b[j] = uv_a[i] + rng.normal(0, 2, 2).astype(np.float32)
        lev_b[j] = lev_a[i]
    # A few exact duplicates force distance ties in rows and columns.
    for i in range(0, min(na, nb) // 8, 2):
        j = int(plant[i])
        desc_b[(j + 1) % nb] = desc_b[j]
        uv_b[(j + 1) % nb] = uv_b[j] + 0.5
        lev_b[(j + 1) % nb] = lev_b[j]
    val_a = rng.uniform(size=na) > 0.1
    val_b = rng.uniform(size=nb) > 0.1
    radius = rng.uniform(5, 25, na).astype(np.float32)
    return desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius


def _cross_slab_case(seed):
    """Equal distances in different 128-column slabs of one row. Rows 0-63
    each find distance 1 twice: even rows at columns i and 256 + i, odd rows
    at 128 + i and 256 + i after a distance 2 at column i. So the best must go
    to the lowest of the equal columns and second == best. Rows 64 + i
    (i % 4 == 0) copy row i, which ties the column minima across rows."""
    rng = np.random.default_rng(seed)
    na, nb = 512, 640
    desc_a = rng.integers(0, 256, (na, 32), dtype=np.uint8)
    desc_b = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    uv_a = rng.uniform(0, 640, (na, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 640, (nb, 2)).astype(np.float32)
    lev_a = rng.integers(0, 8, na).astype(np.int32)
    lev_b = rng.integers(0, 8, nb).astype(np.int32)
    for i in range(64):
        one = desc_a[i].copy()
        one[0] ^= 1
        two = one.copy()
        two[1] ^= 1
        plant = {i: one, 256 + i: one} if i % 2 == 0 else {i: two, 128 + i: one, 256 + i: one}
        for j, d in plant.items():
            desc_b[j], uv_b[j], lev_b[j] = d, uv_a[i] + 0.5, lev_a[i]
    for i in range(0, 64, 4):
        desc_a[64 + i], uv_a[64 + i], lev_a[64 + i] = desc_a[i], uv_a[i], lev_a[i]
    return (desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, np.ones(na, bool),
            np.ones(nb, bool), np.full(na, 12.0, np.float32))


def _k1_inputs(fused_match, dev, case):
    desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius = (
        torch.from_numpy(x).to(dev) for x in case)
    a_par, b_par = fused_match.pack_params(
        uv_a, radius, lev_a - 1, lev_a + 1, val_a, uv_b, lev_b, val_b)
    return desc_a, a_par, desc_b, b_par


def _k1_check(fused_match, args, label):
    """Kernel vs plain on one input: every output exactly equal, col_argmin
    wherever the column has a candidate."""
    from pslam_tpu_torch.ops.match import BIG

    got = [g.cpu().numpy() for g in fused_match.fused_projection_match(*args)]
    ref = [r.cpu().numpy() for r in fused_match.fused_projection_match_plain(*args)]
    for k, name in enumerate(("best", "second", "best_j", "col_min")):
        if not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"K1 {name} differs at {label}: "
                                 f"{int((got[k] != ref[k]).sum())} entries")
    has = ref[3] < BIG
    if not np.array_equal(got[4][has], ref[4][has]):
        raise AssertionError(f"K1 col_argmin differs at {label}")
    return got, ref


def _k1_pairs_in_window(a_par, b_par):
    """How many pairs pass K1's windows and flags: the distances its inputs
    need."""
    au, av, ar, alo, ahi = (a_par[k][:, None] for k in range(5))
    bu, bv, bl = (b_par[k][None, :] for k in range(3))
    mask = ((torch.abs(au - bu) <= ar) & (torch.abs(av - bv) <= ar) & (bl >= alo)
            & (bl <= ahi) & (a_par[5][:, None] > 0.5) & (b_par[3][None, :] > 0.5))
    return int(mask.sum())


def _phase_k1(fused_match, dev):
    from pslam_tpu_torch.ops.match import BIG, accept_matches

    result = None
    for na, nb, seed in ((4096, 1000, 0), (200, 300, 1)):
        args = _k1_inputs(fused_match, dev, _match_case(na, nb, seed))
        got, ref = _k1_check(fused_match, args, f"({na}, {nb})")
        idx_k = accept_matches(*(torch.from_numpy(x).long() for x in
                                 (got[0], got[1], got[2], got[4])), 100, 0.9).numpy()
        idx_p = accept_matches(*(torch.from_numpy(x).long() for x in
                                 (ref[0], ref[1], ref[2], ref[4])), 100, 0.9).numpy()
        if not np.array_equal(idx_k, idx_p) or (idx_k >= 0).sum() == 0:
            raise AssertionError(f"K1 final matches differ at ({na}, {nb})")
        err = max(int(np.abs(got[k].astype(np.int64) - ref[k]).max()) for k in range(4))
        n_cand = _k1_pairs_in_window(args[1], args[3])
        t = _timings(lambda: fused_match.fused_projection_match(*args),
                     lambda: fused_match.fused_projection_match_plain(*args),
                     (32 + 8 * 4 + 3 * 4) * na + (32 + 8 * 4 + 2 * 4) * nb,
                     K1_PAIR_OPS * na * nb + K1_CAND_OPS * n_cand)
        print(f"[2 K1] ({na}, {nb}): outputs exactly equal, {(idx_k >= 0).sum()} matches, "
              f"row ties {int(((got[0] == got[1]) & (got[0] < BIG)).sum())}, {n_cand} "
              f"pairs in the window; {_fmt_timings(t)}")
        if result is None:
            result = dict(max_abs_err=float(err), **t)
            main_args = args

    got, ref = _k1_check(fused_match, _k1_inputs(fused_match, dev, _cross_slab_case(2)),
                         "the cross-slab case")
    rows = np.arange(64)
    if not ((ref[0][:64] == 1).all() and (ref[1][:64] == 1).all()
            and np.array_equal(ref[2][:64], np.where(rows % 2 == 0, rows, 128 + rows))):
        raise AssertionError("the cross-slab case did not plant its ties")
    print(f"[2 K1] (512, 640) equal distances across column slabs: outputs exactly "
          f"equal; {int(((got[0] == got[1]) & (got[0] < BIG)).sum())} rows with "
          f"second == best, {int((got[2][:64] >= 128).sum())} best columns past slab 0")

    for na, nb, seed in ((4097, 1, 3), (1, 1000, 4), (4096, 257, 5)):
        got, _ = _k1_check(fused_match, _k1_inputs(fused_match, dev, _match_case(na, nb, seed)),
                           f"({na}, {nb})")
        print(f"[2 K1] ragged ({na}, {nb}): outputs exactly equal, "
              f"{int((got[0] < BIG).sum())} rows with a candidate")

    first = [o.clone() for o in fused_match.fused_projection_match(*main_args)]
    again = fused_match.fused_projection_match(*main_args)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("two K1 launches of one input differ")
    print("[2 K1] (4096, 1000): two launches bit-identical")
    return result


def _pose_inputs(fused_pose, dev, E, seed, cam, off_truth=False, mono=False):
    """(data (8, E), T (4, 4)) on ``dev``: noisy RGB-D and mono observations
    of random points at a random pose (the generator of
    tests/test_torch_fused_pose.py); with ``mono`` every edge is mono
    (``obs_ur = -1``), as on the monocular path. T is that pose, or with ``off_truth``
    the pose moved by ~0.01 rad and ~3 cm, as in the solver's first LM
    iterations. At the truth b is a sum of noise: its entries can sit near
    0, where the relative bar measures the f32 rounding of the residuals in
    both versions (at E = 8192 the plain version alone is 1.8e-4 from a
    float64 evaluation); off the truth the two agree to ~1e-6."""
    from pslam_tpu_torch.geometry import se3_exp
    from pslam_tpu_torch.solver.pose_opt import PoseObs

    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (E, 3)).astype(np.float32)
    xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)].astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).numpy()
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx + rng.normal(0, 2, E)
    v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy + rng.normal(0, 2, E)
    ur = u - cam.bf / Xc[:, 2] + rng.normal(0, 1, E)
    ur[rng.uniform(size=E) < 0.3] = -1.0
    if mono:
        ur[:] = -1.0
    obs = np.stack([u, v, ur], axis=1).astype(np.float32)
    po = PoseObs(X_w=torch.from_numpy(X).to(dev), obs=torch.from_numpy(obs).to(dev),
                 inv_sigma2=torch.from_numpy(rng.uniform(0.3, 1.0, E).astype(np.float32)).to(dev),
                 valid=torch.from_numpy(rng.uniform(size=E) > 0.15).to(dev))
    data = fused_pose.pack_pose_data(po).contiguous()
    data[7] *= torch.from_numpy((rng.uniform(size=E) > 0.1).astype(np.float32)).to(dev)
    if off_truth:
        dxi = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.03, 3)].astype(np.float32)
        T = se3_exp(torch.from_numpy(dxi)).numpy() @ T
    return data, torch.from_numpy(T).to(dev)


def _k2_chi2_bound(data, par):
    """Per-edge bound on |chi2_kernel - chi2_plain| from f32 rounding, in
    float64 from the inputs (first-order forward error, unit roundoff
    eps = 2^-24, any summation order or contraction):
    - x, y, z are 4-term sums R X + t: |dx| <= 4 eps S_x, S_x = sum |R_0j X_j| + |t_0|;
    - u = fx x (1/z) + cx (3 roundings before the add, 1 for the add):
      |du| <= fx |dx| / |z| + |u - cx| (|dz| / |z| + 3 eps) + eps |u|, the
      same for v, and |dur| <= |du| + bf (|dz| / z^2 + 2 eps / |z|) + eps |ur|;
    - r = obs - u adds eps |r|.
    Each version's r_i is within d_i of the exact one, so the two chi2 differ
    by at most inv_sigma2 sum_i 4 d_i (|r_i| + d_i). Returns (the bound (E,),
    d_u in ulps of the edge's largest pixel coordinate (E,))."""
    d = data.double().cpu().numpy()
    p = par.double().cpu().numpy().reshape(-1)
    eps = 2.0 ** -24
    R, t = p[:16].reshape(4, 4)[:3, :3], p[:16].reshape(4, 4)[:3, 3]
    fx, fy, cx, cy, bf = p[16:21]
    X, obs, inv_s2 = d[0:3].T, d[3:6].T, d[6]
    xc = X @ R.T + t
    dxc = 4 * eps * (np.abs(X) @ np.abs(R).T + np.abs(t))
    x, y, z = xc.T
    iz = 1.0 / z
    rel_z = dxc[:, 2] * np.abs(iz)
    pu, pv = fx * x * iz, fy * y * iz
    proj = np.stack([pu + cx, pv + cy, pu + cx - bf * iz], axis=1)
    stereo = obs[:, 2] >= 0
    r = (obs - proj) * np.stack([np.ones_like(z), np.ones_like(z), stereo], axis=1)
    du = fx * np.abs(iz) * dxc[:, 0] + np.abs(pu) * (rel_z + 3 * eps) + eps * np.abs(proj[:, 0])
    dv = fy * np.abs(iz) * dxc[:, 1] + np.abs(pv) * (rel_z + 3 * eps) + eps * np.abs(proj[:, 1])
    dur = du + bf * np.abs(iz) * (rel_z + 2 * eps) + eps * np.abs(proj[:, 2])
    dr = np.stack([du, dv, dur * stereo], axis=1) + eps * np.abs(r)
    bound = inv_s2 * np.sum(4 * dr * (np.abs(r) + dr), axis=1)
    ulp = np.spacing(np.abs(proj).max(axis=1).astype(np.float32)).astype(np.float64)
    return bound, du / ulp


def _k2_check(fused_pose, data, par, label, rounding_bound=False):
    """Kernel vs plain within the tests/test_pallas_pose.py tolerances: chi2
    within that 1e-4 bar, or with ``rounding_bound`` (only every edge mono at
    the truth) within the bar plus the per-edge f32 rounding bound of
    ``_k2_chi2_bound``; returns (the kernel's outputs, the largest absolute
    difference)."""
    got = [g.cpu().numpy() for g in fused_pose.pose_terms(data, par)]
    ref = [r.cpu().numpy() for r in fused_pose.pose_terms_plain(data, par)]
    checks = (
        ("H", got[0], ref[0], dict(rtol=2e-4, atol=1e-3)),
        ("b", got[1], ref[1], dict(rtol=2e-4, atol=1e-2)),
        ("cost", got[2], ref[2], dict(rtol=1e-5, atol=0)),
    )
    worst, rel = 0.0, {}
    for name, g, r, tol in checks:
        np.testing.assert_allclose(g, r, err_msg=f"K2 {name} ({label})", **tol)
    bound, k_ulp = _k2_chi2_bound(data, par)
    if not rounding_bound:
        bound = np.zeros_like(bound)
    d = np.abs(np.asarray(got[3], np.float64) - ref[3])
    bar = 1e-4 + 1e-4 * np.abs(ref[3])
    if np.any(d > bar + bound):
        i = int(np.argmax(d - bar - bound))
        raise AssertionError(f"K2 chi2 ({label}): edge {i} differs by {d[i]:.3e}, beyond "
                             f"the bar {bar[i]:.3e} + rounding bound {bound[i]:.3e}")
    for name, g, r, _ in checks + (("chi2", got[3], ref[3], None),):
        worst = max(worst, float(np.abs(np.asarray(g, np.float64) - r).max()))
        rel[name] = float(np.abs(np.asarray(g, np.float64) - r).max()
                          / max(float(np.abs(r).max()), 1e-30))
    held = "1e-4 bar + rounding bound" if rounding_bound else "1e-4 bar"
    print(f"[3 K2] {label}: within tolerance; max relative error H {rel['H']:.2e} "
          f"b {rel['b']:.2e} cost {rel['cost']:.2e} chi2 {rel['chi2']:.2e}; chi2 held to the "
          f"{held}: {int((d > bar).sum())} of {len(d)} edges beyond the bare bar, max |diff| "
          f"{d.max():.3e}, max |diff| / (bar + bound) {float((d / (bar + bound)).max()):.3f}, "
          f"rounding bound of u {np.median(k_ulp):.1f} ulp median, {k_ulp.max():.1f} max")
    return got, worst


def _phase_k2(fused_pose, dev):
    from pslam_tpu_torch.geometry import Camera

    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)

    def params(T, use_huber):
        return fused_pose.pack_pose_params(T, fused_pose.pose_param_tail(cam, use_huber, dev))

    worst = 0.0  # at the main-path shape, E = 4096
    for E, seed, off, hubers in ((4096, 0, False, (True, False)), (128, 1, True, (True,)),
                                 (8192, 2, True, (True,))):
        data, T = _pose_inputs(fused_pose, dev, E, seed, cam, off_truth=off)
        for use_huber in hubers:
            _, err = _k2_check(fused_pose, data, params(T, use_huber),
                               f"E={E} huber={use_huber}" + (" off the truth" if off else ""))
            if E == 4096:
                worst = max(worst, err)
        if E == 4096:
            main = (data, params(T, False))

    # Every edge mono, as on the monocular path, off the truth (where the
    # pose solve iterates) and at it. At the truth a residual is pure 2 px
    # noise, the difference of two coordinates up to ~1400 px, so the f32
    # rounding of u (both versions; see _k2_chi2_bound) is a visible share of
    # a small chi2: up to 1.2e-3 on a few edges, within their bound. That
    # case alone is held to the bar plus the bound; every other to the bar.
    for off in (True, False):
        data, T = _pose_inputs(fused_pose, dev, 4096, 4, cam, off_truth=off, mono=True)
        _k2_check(fused_pose, data, params(T, True),
                  "E=4096 all mono (obs_ur = -1)" + (" off the truth" if off else " at the truth"),
                  rounding_bound=not off)

    data, T = _pose_inputs(fused_pose, dev, 4096, 3, cam)
    data[7] = 0.0
    got, _ = _k2_check(fused_pose, data, params(T, True), "E=4096 all inactive")
    if np.any(got[0] != 0) or np.any(got[1] != 0) or got[2] != 0:
        raise AssertionError("K2 on an all-inactive input: H, b or cost is not exactly 0")
    print("[3 K2] E=4096 all inactive: H, b and cost exactly 0")

    first = [o.clone() for o in fused_pose.pose_terms(*main)]
    again = fused_pose.pose_terms(*main)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("two K2 launches of one input differ")
    print("[3 K2] E=4096: two launches bit-identical in H, b, cost and chi2")

    E = main[0].shape[1]
    t = _timings(lambda: fused_pose.pose_terms(*main),
                 lambda: fused_pose.pose_terms_plain(*main),
                 (8 * 4 + 4) * E + 128 * 4 + (36 + 6 + 1) * 4, K2_EDGE_OPS * E)
    print(f"[3 K2] E={E}: {_fmt_timings(t)}")
    return dict(max_abs_err=worst, **t)


def _lm_inputs(rng, first, outcome, close, with_lil):
    """One random LM step input (CPU tensors): the state row, K2's terms at
    the proposal, the LIL terms or None, and the (2, 128) rows [proposal,
    classify]. ``outcome`` is "accept", "reject" or "nan" (a NaN evaluation,
    H and cost NaN)."""
    from pslam_tpu_torch.geometry import Camera, se3_exp
    from pslam_tpu_torch.ops import fused_pose as fp

    def terms(scale):
        J = rng.normal(size=(40, 6)) * np.array([500, 500, 500, 100, 100, 100]) * scale
        return (torch.from_numpy((J.T @ J).astype(np.float32)),
                torch.from_numpy((rng.normal(size=6) * 1e3 * scale).astype(np.float32)),
                torch.tensor(rng.uniform(50, 500) * scale, dtype=torch.float32))

    def pose(s0, s1):
        xi = np.r_[rng.normal(0, s0, 3), rng.normal(0, s1, 3)].astype(np.float32)
        return se3_exp(torch.from_numpy(xi))

    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    T = pose(0.05, 0.2)
    rows = fp.lm_rows(cam, T)
    H, b, cost = terms(1.0)
    state = rows[0]
    state[fp.LM_LAM] = 10.0 ** rng.uniform(-6, 2)
    state[fp.LM_COST] = cost
    state[fp.LM_H:fp.LM_H + 36] = H.reshape(36)
    state[fp.LM_B:fp.LM_B + 6] = b
    state[fp.LM_FIRST] = 1.0 if first else 0.0
    if not first:
        rows[1, :16] = (pose(0.01, 0.03) @ T).reshape(16)
    H_new, b_new, cost_new = terms(1.0)
    if outcome == "accept":
        cost_new = cost * 0.5
    elif outcome == "reject":
        cost_new = cost * 2.0
    else:
        H_new = torch.full_like(H_new, float("nan"))
        cost_new = torch.tensor(float("nan"))
    lil = terms(0.01) if with_lil else None
    return state, (H_new, b_new, cost_new), lil, rows[1:].clone(), close


def _lm_run(fused_pose, inp, dev):
    """One LM step on ``dev`` (the plain version on the CPU); returns the
    state and the rows, on the CPU."""
    state, (H, b, cost), lil, rows, close = inp
    state, rows = state.clone().to(dev), rows.clone().to(dev)
    H, b, cost = H.to(dev), b.to(dev), cost.to(dev)
    lil = None if lil is None else tuple(t.to(dev) for t in lil)
    par, par_cls = rows[0:1], rows[1:2]
    if close:
        fused_pose.lm_step(state, H, b, cost, par, par_cls, lil=lil, close=True)
    else:
        fused_pose.lm_step(state, H, b, cost, par, par, lil=lil)
    return state.cpu().numpy(), rows.cpu().numpy()


def _solve_problem(rng, N, with_lil, origin=False):
    """(T0, PoseObs, LILPoseObs or None) in numpy-built CPU tensors: noisy
    RGB-D / mono observations with 10% outliers, T0 ~0.01 rad and ~3 cm off
    the truth (tests/test_torch_fused_pose.py's generator); with
    ``with_lil`` 8 LILs seen exactly from the truth (tests/test_torch_lil.py's
    construction), one of them with its crosspoint 300 px off. With
    ``origin`` the solve starts at the identity, as the first frame after a
    map's initialization does, and the unmatched slots hold the world origin,
    as empty map slots do."""
    from pslam_tpu_torch.geometry import se3_exp
    from pslam_tpu_torch.solver.lil import LILPoseObs
    from pslam_tpu_torch.solver.pose_opt import PoseObs

    def pose(s0, s1):
        xi = np.r_[rng.normal(0, s0, 3), rng.normal(0, s1, 3)].astype(np.float32)
        return se3_exp(torch.from_numpy(xi)).numpy()

    fx, fy, cx, cy, bf = 517.3, 516.5, 318.6, 255.3, 40.0
    T = pose(0.05, 0.2)
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (N, 3)).astype(np.float32)
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = fx * Xc[:, 0] / Xc[:, 2] + cx + rng.normal(0, 1, N)
    v = fy * Xc[:, 1] / Xc[:, 2] + cy + rng.normal(0, 1, N)
    ur = u - bf / Xc[:, 2] + rng.normal(0, 0.5, N)
    ur[rng.uniform(size=N) < 0.3] = -1.0
    bad = rng.uniform(size=N) < 0.1
    u[bad] += rng.uniform(-60, 60, bad.sum())
    v[bad] += rng.uniform(-60, 60, bad.sum())
    po = PoseObs(X_w=torch.from_numpy(X),
                 obs=torch.from_numpy(np.stack([u, v, ur], 1).astype(np.float32)),
                 inv_sigma2=torch.from_numpy(rng.uniform(0.3, 1.0, N).astype(np.float32)),
                 valid=torch.from_numpy(rng.uniform(size=N) > 0.15))
    T0 = torch.from_numpy(pose(0.01, 0.03) @ T)
    if origin:
        T = pose(0.01, 0.03)
        po = po._replace(X_w=torch.from_numpy(np.where(po.valid.numpy()[:, None], X, 0.0)
                                              .astype(np.float32)))
        Xc = X @ T[:3, :3].T + T[:3, 3]
        u = fx * Xc[:, 0] / Xc[:, 2] + cx + rng.normal(0, 1, N)
        v = fy * Xc[:, 1] / Xc[:, 2] + cy + rng.normal(0, 1, N)
        obs = po.obs.numpy().copy()
        obs[:, 0], obs[:, 1] = u, v
        obs[:, 2] = np.where(obs[:, 2] >= 0, u - bf / Xc[:, 2], -1.0)
        po = po._replace(obs=torch.from_numpy(obs.astype(np.float32)))
        T0 = torch.eye(4)
    if not with_lil:
        return T0, po, None

    def line(a, b_):
        la, lb, lc = a[1] - b_[1], b_[0] - a[0], a[0] * b_[1] - a[1] * b_[0]
        return np.array([la, lb, lc]) / np.hypot(la, lb)

    states, obs = [], []
    for _ in range(8):
        Xi = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0])
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = rng.normal(size=3)
        d2 -= d1 * (d1 @ d2)
        d2 /= np.linalg.norm(d2)
        st = np.concatenate([Xi - 0.5 * d1, Xi + 0.7 * d1, Xi - 0.6 * d2, Xi + 0.4 * d2, Xi])
        P = st.reshape(5, 3) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
        uv = np.stack([fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy], 1)
        states.append(st)
        obs.append(np.concatenate([line(uv[0], uv[1]), line(uv[2], uv[3]), uv[4]]))
    obs = np.asarray(obs, np.float32)
    obs[0, 6:8] += 300.0
    lil = LILPoseObs(state=torch.from_numpy(np.asarray(states, np.float32)),
                     obs=torch.from_numpy(obs), valid=torch.from_numpy(np.r_[[True] * 7, False]))
    return T0, po, lil


def _phase_lm(fused_pose, dev, small_cfgs):
    """Phase 3b: the LM step kernel against its plain version, whole pose
    solves on the card against the CPU, and the launches of a tracked frame."""
    import itertools

    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.io.synthetic import arc_trajectory
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.solver.pose_opt import pose_optimization

    # (a) Random states: every mix of first evaluation, outcome, closing step
    # and LIL terms, 11 states each. The state row is a selection of inputs
    # and exact products (lambda x 0.5 or x 4, H + H_lil): it must be equal
    # bit for bit, and with it every accept / reject decision. The proposal
    # (a 6x6 solve and se3_exp) is held to K2's H bar, rtol 2e-4, with atol
    # 1e-5; where the plain proposal is NaN the kernel's must be NaN too.
    rng = np.random.default_rng(33)
    combos = list(itertools.product((True, False), ("accept", "reject", "nan"),
                                    (False, True), (False, True))) * 11
    worst, n_accept = 0.0, 0
    for k, (first, outcome, close, with_lil) in enumerate(combos):
        inp = _lm_inputs(rng, first, outcome, close, with_lil)
        s_got, r_got = _lm_run(fused_pose, inp, dev)
        s_ref, r_ref = _lm_run(fused_pose, inp, "cpu")
        label = f"LM state {k} (first {first}, {outcome}, close {close}, LIL {with_lil})"
        np.testing.assert_array_equal(s_got, s_ref, err_msg=label)
        np.testing.assert_array_equal(r_got[1], r_ref[1], err_msg=label)
        p_got, p_ref = r_got[0, :16], r_ref[0, :16]
        np.testing.assert_array_equal(np.isnan(p_got), np.isnan(p_ref), err_msg=label)
        fin = ~np.isnan(p_ref)
        np.testing.assert_allclose(p_got[fin], p_ref[fin], rtol=2e-4, atol=1e-5,
                                   err_msg=label)
        worst = max(worst, float(np.abs(p_got[fin] - p_ref[fin]).max(initial=0.0)))
        n_accept += int(not first and outcome == "accept")
    print(f"[3b LM] {len(combos)} random states: state rows bit-identical (every accept / "
          f"reject decision equal, {n_accept} accepts), proposals within rtol 2e-4 / atol "
          f"1e-5, max |diff| {worst:.3e}, NaN evaluations NaN on both")

    # (b) Whole solves, card against CPU (the bars of
    # tests/test_torch_fused_pose.py), and the launches of a solve.
    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    rng = np.random.default_rng(34)
    for N, with_lil, origin in ((300, False, False), (1000, False, False),
                                (4096, False, False), (80, True, False), (4096, True, False),
                                (1024, False, True), (1024, True, True)):
        T0, po, lil = _solve_problem(rng, N, with_lil, origin)
        ref = pose_optimization(cam, T0, po, lil=lil)
        k2, lm = fused_pose.LAUNCHES, fused_pose.LM_LAUNCHES
        got = pose_optimization(cam, T0.to(dev), type(po)(*(t.to(dev) for t in po)),
                                lil=None if lil is None else type(lil)(*(t.to(dev) for t in lil)))
        k2, lm = fused_pose.LAUNCHES - k2, fused_pose.LM_LAUNCHES - lm
        Tg, Tr = got[0].cpu().numpy(), ref[0].numpy()
        D = Tr[:3, :3].astype(np.float64).T @ Tg[:3, :3]
        rot = float(np.linalg.norm(0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                                                    D[1, 0] - D[0, 1]])))
        trans = float(np.abs(Tg[:3, 3] - Tr[:3, 3]).max())
        same_in = np.array_equal(got[1].cpu().numpy(), ref[1].numpy())
        same_lil = with_lil and np.array_equal(got[3].cpu().numpy(), ref[3].numpy())
        print(f"[3b LM] solve N={N}{' + 8 LILs' if with_lil else ''}"
              f"{' from the identity, empty slots at the origin' if origin else ''}: card vs cpu rotation "
              f"{rot:.2e} rad, translation {trans:.2e} m, inliers equal {same_in} "
              f"({int(got[1].sum())}){f', LIL inliers equal {same_lil}' if with_lil else ''}; "
              f"launches K2 {k2}, LM {lm}")
        if rot > 1e-4 or trans > 1e-4 or not same_in or (with_lil and not same_lil):
            raise AssertionError(f"LM solve N={N} lil={with_lil}: card and CPU disagree")
        if k2 != 49 or lm != 44:
            raise AssertionError(f"a solve launched K2 {k2} and LM {lm} times, not 49 and 44")

    # (c) A tracked frame: 98 K2 and 88 LM step launches a frame_step (two
    # solves), and stats["pose_lm_steps"] counts the LM ones.
    poses = arc_trajectory(24)[:8]
    for name, cfg in small_cfgs:
        from pslam_tpu_torch.io.synthetic import render_sequence

        grays, depths, _ = render_sequence(cfg.camera, n_frames=8, poses=poses, seed=0)
        slam = SlamSystem(cfg, device=dev)
        rows = []
        for i in range(len(grays)):
            k2, lm = fused_pose.LAUNCHES, fused_pose.LM_LAUNCHES
            st = dict(slam.stats)
            slam.track_rgbd(grays[i], depths[i], i / 30.0)
            if slam.state != TrackState.OK:
                raise AssertionError(f"{name}: frame {i} ended {slam.state.name}")
            if i == 0:
                continue
            d = {k: slam.stats.get(k, 0) - st.get(k, 0)
                 for k in ("track_steps", "track_fallbacks", "pose_lm_steps")}
            rows.append((fused_pose.LAUNCHES - k2, fused_pose.LM_LAUNCHES - lm, d))
        print(f"[3b LM] {name}, 7 tracked frames: K2 / LM launches a frame "
              f"{[r[:2] for r in rows]}, steps {[r[2]['track_steps'] for r in rows]}")
        for k2, lm, d in rows:
            if d["pose_lm_steps"] != lm or 44 * k2 != 49 * lm:
                raise AssertionError(f"{name}: a frame launched K2 {k2}, LM {lm}, counted {d}")
            if d["track_steps"] == 1 and not d["track_fallbacks"] and (k2, lm) != (98, 88):
                raise AssertionError(f"{name}: a one-step frame launched K2 {k2}, LM {lm}")
        if not any(r[2]["track_steps"] == 1 and r[:2] == (98, 88) for r in rows):
            raise AssertionError(f"{name}: no frame of one step")

    # Times of one step, and of one K2 + step iteration as the solve runs it.
    inp = _lm_inputs(np.random.default_rng(35), False, "accept", False, False)
    state, (H, b, cost), _, rows, _ = inp
    state, rows, H, b, cost = (t.to(dev) for t in (state, rows, H, b, cost))
    par = rows[0:1]
    data, _ = _pose_inputs(fused_pose, dev, 4096, 5, cam, off_truth=True)
    t = _timings(lambda: fused_pose.lm_step(state, H, b, cost, par, par),
                 lambda: fused_pose.lm_step_plain(state, H, b, cost, par, par),
                 (36 + 6 + 1 + 16 + 61 + 61 + 16) * 4, 400)

    def iteration():
        Hn, bn, cn, _ = fused_pose.pose_terms(data, par)
        fused_pose.lm_step(state, Hn, bn, cn, par, par)

    it_host = _host_us(iteration)
    print(f"[3b LM] step: {_fmt_timings(t)}; one K2 + step iteration {it_host:.1f} us of host")
    return dict(it_host_us=it_host, **t)


def _phase_ba_graph(dev):
    """Phase 3c: the local BA through ``local_ba.BA_GRAPHS`` (one captured
    CUDA graph a problem shape) against the eager solver, at the main path's
    capacities, for the point and the LIL solver; the counters; a held
    result under the next replay; host ms a call and peak memory."""
    from torch.utils._pytree import tree_map_only

    from pslam_tpu_torch.apps.profile_backend import random_ba_problem, random_lil_problem
    from pslam_tpu_torch.solver import local_ba
    from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
    from pslam_tpu_torch.utils.config import SlamConfig
    from pslam_tpu_torch.utils.cuda_graph import GraphCache

    cfg = SlamConfig()
    cam, n_free = cfg.camera, cfg.caps.ba_free
    rng = np.random.default_rng(36)
    big, _, _ = random_ba_problem(cfg, rng, cfg.caps.ba_points, cfg.caps.ba_edges, dev)
    small, _, _ = random_ba_problem(cfg, rng, cfg.caps.ba_points // 2, cfg.caps.ba_edges // 2,
                                    dev)
    lil_big = random_lil_problem(cfg, rng, dev, Q=64)
    lil_small = random_lil_problem(cfg, rng, dev, Q=32)

    def nudged(prob, k):
        # Another problem of the same key: the same edges, moved points.
        g = torch.Generator(device=dev).manual_seed(k)
        return prob._replace(X_w=prob.X_w + 0.01 * torch.randn(prob.X_w.shape, generator=g,
                                                               device=dev))

    solvers = {
        "points": (lambda p, lil, r: local_ba.local_bundle_adjustment(cam, p, n_free, ranks=r),
                   (big, None), (small, None)),
        "LIL": (lambda p, lil, r: local_bundle_adjustment_lil(cam, p, *lil, n_free, ranks=r),
                (big, lil_big), (small, lil_small)),
    }
    # Not ONE_DEVICE: the eager solver, on the same fixed-width tables.
    eager_ranks = local_ba.OneDevice()
    saved = local_ba.BA_GRAPHS
    try:
        for name, (solve, (p_a, lil_a), (p_b, lil_b)) in solvers.items():
            g = local_ba.BA_GRAPHS = GraphCache()
            calls = [nudged(p_a, k) for k in range(4)] + [p_b, nudged(p_b, 9)]
            lils = [lil_a] * 4 + [lil_b] * 2
            mem0 = torch.cuda.max_memory_allocated(dev)
            worst, outs, host = 0.0, [], []
            for k, (p, lil) in enumerate(zip(calls, lils)):
                want = solve(p, lil, eager_ranks)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                got = solve(p, lil, local_ba.ONE_DEVICE)
                t1 = time.perf_counter()
                torch.cuda.synchronize(dev)
                host.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
                for a, b in zip(got, want):
                    if not torch.equal(a, b):
                        d = float((a.float() - b.float()).abs().max())
                        raise AssertionError(f"3c {name} call {k}: graph path differs from "
                                             f"eager by {d}")
                    worst = max(worst, float((a.float() - b.float()).abs().max()))
                outs.append(got)
            # The result of call 1 (the capture) after the replays of calls
            # 2 and 3 of its graph: unchanged.
            again = solve(calls[1], lils[1], eager_ranks)
            for a, b in zip(outs[1], again):
                if not torch.equal(a, b):
                    raise AssertionError(f"3c {name}: a held result changed under a replay")
            counts = (g.eager, g.captures, g.replays, len(g.graphs))
            # The card's solve (fixed-width tables) against the CPU's (exact
            # widths: the solver tier-1 holds against the JAX package) on
            # the first problem: rounding apart, the same solve.
            cpu = solve(*tree_map_only(torch.Tensor, torch.Tensor.cpu, (calls[0], lils[0])),
                        local_ba.ONE_DEVICE)
            d_T, d_X = (float((outs[0][k].cpu() - cpu[k]).abs().max()) for k in (0, 1))
            flags = range(3, 5) if name == "LIL" else (2,)
            same = min(float((outs[0][k].cpu() == cpu[k]).float().mean()) for k in flags)
            print(f"[3c BA graph] {name}: card vs CPU max |dT| {d_T:.2e}, max |dX| {d_X:.2e}, "
                  f"inlier flags equal {same:.4%}")
            if not (d_T < 1e-2 and same >= 0.99):
                raise AssertionError(f"3c {name}: the card's solve is not the CPU's")
            print(f"[3c BA graph] {name}: 6 calls over 2 keys, graph path vs eager max |diff| "
                  f"{worst:.1e} (bit-identical), eager / captures / replays / graphs "
                  f"{counts}; host ms a call (enqueue, to synchronized) eager "
                  f"{host[0][0]:.1f} / {host[0][1]:.1f}, capture {host[1][0]:.1f} / "
                  f"{host[1][1]:.1f}, replay {np.median([h[0] for h in host[2:4]]):.2f} / "
                  f"{np.median([h[1] for h in host[2:4]]):.2f}; peak memory "
                  f"{mem0 / 2**20:.0f} -> {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} "
                  "MiB")
            if counts != (2, 2, 4, 2):
                raise AssertionError(f"3c {name}: eager / captures / replays / graphs {counts},"
                                     " not 1 eager, 1 capture and 1-2 replays a key")
        # A replay's device time, between CUDA events.
        p = calls[2]
        ms = _median_ms(lambda: solvers["points"][0](p, None, local_ba.ONE_DEVICE), runs=10,
                        warmup=1)
        print(f"[3c BA graph] points replay at {tuple(p.cam_idx.shape)} edges: {ms:.2f} ms "
              "between events")
    finally:
        local_ba.BA_GRAPHS = saved


def _run_slice(cfg, device, n_frames, poses=None, profile=None):
    """Track ``n_frames`` of the synthetic arc; every frame must end OK.
    ``profile=(a, b)`` runs torch.profiler over frames a..b-1 and returns
    their device ms and device activities per frame as the last item."""
    from torch.profiler import ProfilerActivity
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=n_frames,
                                              poses=poses, seed=0)
    slam = SlamSystem(cfg, device=device)
    ms, is_kf, states, centres = [], [], [], []
    per_frame = None
    with contextlib.ExitStack() as window:
        for i in range(len(grays)):
            if profile and i == profile[0]:
                prof = window.enter_context(torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            n_kf = slam.stats["kf_inserted"]
            t0 = time.perf_counter()
            T = slam.track_rgbd(grays[i], depths[i], i / 30.0)
            if device != "cpu":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            is_kf.append(slam.stats["kf_inserted"] > n_kf)
            states.append(slam.state)
            centres.append(-T[:3, :3].T @ T[:3, 3])
            if slam.state != TrackState.OK:
                raise AssertionError(f"frame {i} ended {slam.state.name} on {device}")
            if profile and i == profile[1] - 1:
                window.close()
                us, n = _device_us(prof)
                per_frame = (us / 1e3 / (profile[1] - profile[0]),
                             n / (profile[1] - profile[0]))
    ate = ate_rmse(trajectory_positions(slam.poses), trajectory_positions(poses_gt))
    return (slam, np.asarray(ms), np.asarray(is_kf), states, np.asarray(centres), ate,
            per_frame)


def _drive_main_path(name, cfg, n_frames, fused_match, fused_pose):
    """One main path on the card with the launch counters read around it."""
    _zero_counts(fused_match, fused_pose)
    run = _run_slice(cfg, "cuda", n_frames)
    launches = _counts(fused_match, fused_pose)
    slam, ms, is_kf, _, _, ate, _ = run
    tracked = n_frames - 1  # frame 0 initializes the map
    n_kf = int(slam.map.kf_valid.sum())
    print(f"[{name}] 640x480, {n_frames} frames on the card: all OK; keyframes "
          f"{n_kf} (inserted {slam.stats['kf_inserted']}), local BAs "
          f"{slam.stats['ba_runs']}, ATE {ate * 100:.3f} cm; median "
          f"{np.median(ms[5:]):.2f} ms/frame (frames 5+), keyframe frames mean "
          f"{ms[is_kf][1:].mean():.2f} ms, first frame {ms[0]:.1f} ms; "
          f"launches {launches} {_per_frame(launches, tracked)}, stats['pose_lm_steps'] "
          f"{slam.stats.get('pose_lm_steps', 0)}")
    if n_kf < 3 or slam.stats["ba_runs"] < 1 or not ate < 0.05:
        raise AssertionError(f"{name}: too few keyframes or local BAs, or ATE >= 5 cm")
    _check_launches(name, "cuda", launches, tracked)
    if slam.stats.get("pose_lm_steps", 0) != launches["lm_step"]:
        raise AssertionError(f"{name}: stats['pose_lm_steps'] does not count every LM step")
    return slam, launches, tracked, float(np.median(ms[5:]))


def _map_arrays(slam):
    return {k: v for k, v in vars(slam.map).items() if isinstance(v, np.ndarray)}


def _phase_repeat(small_lines):
    """The small structural-line slice twice on the card, once on the CPU."""
    from pslam_tpu_torch.io.synthetic import arc_trajectory

    poses = arc_trajectory(24)[:8]
    runs = [_run_slice(small_lines, dev, 8, poses) for dev in ("cuda", "cuda", "cpu")]
    (g1, g2, cpu) = runs
    same_poses = np.array_equal(np.stack(g1[0].poses), np.stack(g2[0].poses))
    m1, m2 = _map_arrays(g1[0]), _map_arrays(g2[0])
    differ = [k for k in m1 if not np.array_equal(m1[k], m2[k])]
    diff = float(np.linalg.norm(g1[4] - cpu[4], axis=1).max())
    same_kf = np.array_equal(g1[2], cpu[2])
    m = g1[0].map
    print(f"[7 repeat] 320x240 config 3, 8 frames: card runs bit-identical "
          f"poses {same_poses}, map arrays differing {differ}; card vs cpu same "
          f"states {g1[3] == cpu[3]}, same keyframes {same_kf}, max centre "
          f"difference {diff * 1000:.3f} mm; map lines {int(m.ml_valid.sum())}, "
          f"LILs {int(m.il_valid.sum())}, LIL BA edges {g1[0].stats.get('lil_ba_edges', 0)}")
    if not same_poses or differ:
        raise AssertionError("two card runs of the same input differ")
    if g1[3] != cpu[3] or not same_kf or diff > 0.02:
        raise AssertionError("card and CPU runs of the small structural-line slice disagree")


def _phase_reloc(device, fused_match, fused_pose, cam=None):
    """The kidnap: 10 arc frames, LOST, frame 3 again, then frame 4. Returns
    the kernels' launches during the relocalization call."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig(use_lines=False)
    if cam is not None:
        cfg = dataclasses.replace(cfg, camera=cam)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, reset_if_lost_with_kfs=0, kf_max_interval=3))
    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=10, seed=0)
    slam = SlamSystem(cfg, device=device)
    for i in range(10):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    if slam.state != TrackState.OK or slam.map.n_kf < 3:
        raise AssertionError("8 reloc: the map before the kidnap is not tracked")
    slam.state = TrackState.LOST
    _zero_counts(fused_match, fused_pose)
    t0 = time.perf_counter()
    T = slam.track_rgbd(grays[3], depths[3], 11 / 30.0)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = _counts(fused_match, fused_pose)
    state = slam.state
    err = float(np.linalg.norm(_centre(T) - _centre(poses_gt[3])))
    slam.track_rgbd(grays[4], depths[4], 12 / 30.0)
    print(f"[8 reloc] {cfg.camera.width}x{cfg.camera.height}, {slam.map.n_kf} keyframes: "
          f"state {state.name}, relocs {slam.stats.get('relocs', 0)}, centre "
          f"{err * 100:.3f} cm from the truth, next frame {slam.state.name}; the "
          f"relocalizing frame took {ms:.1f} ms; launches {launches}")
    if state != TrackState.OK or slam.stats.get("relocs", 0) != 1 or not err < 0.05:
        raise AssertionError("8 reloc: no relocalization, or its centre is >= 5 cm off")
    if slam.state != TrackState.OK:
        raise AssertionError("8 reloc: the frame after the relocalization is not OK")
    if device != "cpu" and min(launches.values()) < 1:
        raise AssertionError(f"8 reloc: the relocalization did not launch all three "
                             f"kernels: {launches}")
    return launches


def _drifted_world(device):
    """tests/test_loop_closing.py's drifted world on ``device``: KFs 0-2 see
    cloud A, 3-5 B, 6-8 C, and 9-13 A again through drifted duplicate
    points and poses. Returns (slam, true poses)."""
    from pslam_tpu_torch.geometry import project, se3_exp
    from pslam_tpu_torch.ops.orb import OrbConfig
    from pslam_tpu_torch.pipeline.system import SlamSystem
    from pslam_tpu_torch.utils.config import Capacities, SlamConfig

    def exp(xi):
        return se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()

    cfg = SlamConfig(orb=OrbConfig(n_features=256), use_lines=False, bow_k=8, bow_levels=3,
                     caps=Capacities(max_keyframes=32, max_map_points=4096, local_points=512,
                                     gba_cams=32, gba_free=16, gba_points=1024,
                                     gba_edges=4096))
    slam = SlamSystem(cfg, device=device)
    m, cam, N, P_CLOUD = slam.map, cfg.camera, cfg.orb.capacity, 150
    rng = np.random.default_rng(0)
    clouds = [rng.uniform([-1.5, -1.0, 2.0 + 2.5 * ci], [1.5, 1.0, 4.0 + 2.5 * ci],
                          (P_CLOUD, 3)).astype(np.float32) for ci in range(3)]
    descs = [rng.integers(0, 256, (P_CLOUD, 32), dtype=np.uint8) for _ in range(3)]
    segments = [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0]
    poses_true = []
    for k, ci in enumerate(segments):
        off = rng.normal(0, 0.08, 3).astype(np.float32)
        T = exp(np.r_[rng.normal(0, 0.02, 3), [0.15 * (k % 3) + off[0], off[1], off[2]]])
        T[2, 3] -= 2.5 * ci
        poses_true.append(T.astype(np.float32))
    W = exp([0.02, -0.03, 0.025, 0.25, -0.18, 0.22])
    W_inv = np.linalg.inv(W)
    cloud_ids = {}
    for k, ci in enumerate(segments):
        revisit = k >= 9
        X_w, T_cw = clouds[ci], poses_true[k]
        if revisit:
            X_w = (X_w @ W[:3, :3].T) + W[:3, 3]
            T_cw = (poses_true[k] @ W_inv).astype(np.float32)
        Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = project(cam, torch.from_numpy(np.ascontiguousarray(Xc, np.float32))).numpy()
        z = Xc[:, 2]
        ok = ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) & (uv[:, 1] >= 0)
              & (uv[:, 1] < cam.height))
        nsel = min(int(ok.sum()), N)
        sel = np.flatnonzero(ok)[:nsel]
        uv_f = np.zeros((N, 2), np.float32)
        ur_f = np.full(N, -1.0, np.float32)
        depth_f = np.zeros(N, np.float32)
        desc_f = np.zeros((N, 32), np.uint8)
        valid_f = np.zeros(N, bool)
        uv_f[:nsel], depth_f[:nsel] = uv[sel], z[sel]
        ur_f[:nsel] = uv[sel, 0] - cam.bf / z[sel]
        desc_f[:nsel], valid_f[:nsel] = descs[ci][sel], True
        kf = m.add_keyframe(k, float(k), T_cw, uv_f, ur_f, np.zeros(N, np.int32),
                            np.zeros(N, np.float32), desc_f, valid_f, depth_f,
                            np.full(N, -1, np.int32))
        if (ci, revisit) not in cloud_ids:
            ids = m.create_points_from_depth(kf, np.arange(nsel), X_w[sel].astype(np.float32))
            table = np.full(P_CLOUD, -1, np.int32)
            table[sel] = ids
            cloud_ids[(ci, revisit)] = table
        else:
            table = cloud_ids[(ci, revisit)]
            have = table[sel] >= 0
            m.kf_feat_mp[kf, np.arange(nsel)[have]] = table[sel][have]
            np.add.at(m.mp_n_obs, table[sel][have], 1)
            m._update_covisibility(kf)
        slam.kf_db.add(kf, *slam.kf_db.compute_bow(desc_f, valid_f))
    return slam, poses_true


def _close_loop(device):
    slam, poses_true = _drifted_world(device)
    closed_at = next((kf for kf in (9, 10, 11, 12, 13)
                      if slam.loop_closer.on_new_keyframe(kf)), None)
    return slam, poses_true, closed_at


def _phase_loop(devices=("cuda", "cuda", "cpu")):
    """The drifted world closed twice on the card and once on the CPU."""
    t0 = time.perf_counter()
    (g1, truth, at1), (g2, _, at2), (c, _, atc) = (_close_loop(d) for d in devices)
    m1, m2, mc = _map_arrays(g1), _map_arrays(g2), _map_arrays(c)
    differ = [k for k in m1 if not np.array_equal(m1[k], m2[k])]
    K = g1.map.n_kf
    pose_diff = float(np.abs(g1.map.kf_pose[:K] - c.map.kf_pose[:K]).max())
    s1, sc = g1.loop_closer.stats, c.loop_closer.stats
    stats_differ = [k for k in set(s1) | set(sc)
                    if isinstance(s1.get(k), float) and abs(s1[k] - sc.get(k, np.inf)) > 1e-3
                    or not isinstance(s1.get(k), float) and s1.get(k) != sc.get(k)]
    m = g1.map
    err = float(np.abs(m.kf_pose[at1] - truth[at1]).max()) if at1 is not None else np.inf
    median = np.inf
    if at1 is not None:
        mp = m.kf_feat_mp[at1]
        pos = m.mp_pos[mp[mp >= 0]]
        orig = m.mp_pos[m.mp_valid & (m.mp_first_kf == 0)]
        median = float(np.median(np.linalg.norm(pos[:, None] - orig[None], axis=-1).min(1)))
    print(f"[9 loop] drifted world, {devices}: closed at {at1}, {at2}, {atc}; card runs "
          f"map arrays differing {differ}; stats card {s1}, cpu {sc}; card vs cpu "
          f"keyframe poses within {pose_diff:.2e}, points within "
          f"{float(np.abs(m1['mp_pos'][m.mp_valid] - mc['mp_pos'][m.mp_valid]).max()):.2e} m; "
          f"closing keyframe {err:.4f} from its true pose, fused points' median distance "
          f"to cloud A {median * 100:.3f} cm; {time.perf_counter() - t0:.1f} s")
    if at1 is None or at1 != at2 or at1 != atc:
        raise AssertionError("9 loop: no closure, or not at the same keyframe")
    if differ:
        raise AssertionError(f"9 loop: two card runs differ in {differ}")
    if stats_differ or pose_diff > 1e-3:
        raise AssertionError(f"9 loop: card and CPU disagree (stats {stats_differ}, "
                             f"poses {pose_diff})")
    if not (err < 0.03 and median < 0.05):
        raise AssertionError("9 loop: the loop was not corrected")


def _phase_config4(device, fused_match, fused_pose, n_frames=160, cfg=None):
    """BASELINE config 4 on the loop circuit; returns (launches, tracked)."""
    from pslam_tpu_torch.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
    from pslam_tpu_torch.pipeline import loop_closing
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.config import SlamConfig
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    cfg = cfg or SlamConfig()
    t0 = time.perf_counter()
    grays, depths, poses_gt = render_sequence(
        cfg.camera, poses=loop_trajectory(n_frames, loops=1.0),
        room=ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3))
    render_s = time.perf_counter() - t0
    slam = SlamSystem(cfg, device=device)
    closer = slam.loop_closer
    # Wall ms of every call of the loop closer's stages; a loop event is a
    # call of on_new_keyframe that handled a loop.
    stage_ms = {}
    run_global_ba = loop_closing.run_global_ba
    for owner, name in ((closer, "on_new_keyframe"), (closer, "compute_sim3"),
                        (closer, "_run_essential_graph"), (loop_closing, "run_global_ba")):
        _time_calls(owner, name, device, stage_ms.setdefault(name, []))
    try:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        _zero_counts(fused_match, fused_pose)
        ms, is_kf, est = [], [], []
        for i in range(n_frames):
            n_kf = slam.stats["kf_inserted"]
            t = time.perf_counter()
            est.append(slam.track_rgbd(grays[i], depths[i], i / 30.0))
            _sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
            is_kf.append(slam.stats["kf_inserted"] > n_kf)
            if slam.state != TrackState.OK:
                raise AssertionError(f"10 config 4: frame {i} ended {slam.state.name}")
        launches = _counts(fused_match, fused_pose)
        corrected = slam.poses  # flushes; rows chained to the corrected keyframes
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
        if slam.loop_closer is not closer:
            raise AssertionError("10 config 4: the system was reset")
        gt = trajectory_positions(poses_gt)
        ate = ate_rmse(trajectory_positions(corrected), gt)
        online = ate_rmse(trajectory_positions(np.stack(est)), gt)
        ms, is_kf = np.asarray(ms), np.asarray(is_kf)
        events = [(t, out) for t, out in stage_ms["on_new_keyframe"] if out]
        lc = closer.stats
        tracked = n_frames - 1
        peak_txt = "not measured (CPU)" if peak is None else f"{peak / 2**20:.1f} MiB"
        print(f"[10 config 4] {cfg.camera.width}x{cfg.camera.height}, {n_frames} frames of the "
              f"loop circuit on {device} (rendered in {render_s:.1f} s): all OK; median "
              f"{np.median(ms[5:]):.2f} ms/frame (frames 5+), keyframe frames mean "
              f"{ms[is_kf][1:].mean():.2f} ms over {int(is_kf[1:].sum())}, other frames median "
              f"{np.median(ms[1:][~is_kf[1:]]):.2f} ms; loop events "
              f"{[round(t, 1) for t, _ in events]} ms, of them Sim3 {_ms_list(stage_ms['compute_sim3'])}, essential graph "
              f"{_ms_list(stage_ms['_run_essential_graph'])}, global BA "
              f"{_ms_list(stage_ms['run_global_ba'])} ms; loop checks at keyframes without a loop "
              f"{np.mean([t for t, out in stage_ms['on_new_keyframe'] if not out]):.2f} ms mean; "
              f"keyframes "
              f"{int(slam.map.kf_valid.sum())} (inserted {slam.stats['kf_inserted']}); loop "
              f"stats {lc}; ATE online {online * 100:.3f} cm, corrected {ate * 100:.3f} cm; "
              f"peak device memory {peak_txt}; launches {launches} "
              f"{_per_frame(launches, tracked)}")
        n_fuse_only = lc.get("fuse_only", 0) // 2  # counted twice a call, as in pslam_tpu
        if lc["detected"] < 1 or lc["closed"] + lc.get("fuse_only", 0) < 1:
            raise AssertionError("10 config 4: no loop handled")
        if lc["gba_runs"] != lc["closed"] - n_fuse_only:
            raise AssertionError("10 config 4: a loop correction without its global BA")
        if not ate < 0.05:
            raise AssertionError(f"10 config 4: corrected ATE {ate * 100:.3f} cm >= 5 cm")
        _check_launches("10 config 4", device, launches, tracked)
        return launches, tracked
    finally:
        loop_closing.run_global_ba = run_global_ba


def _time_calls(owner, name, device, log):
    """Replace ``owner.name`` by a wrapper that appends (wall ms, result) of
    every call to ``log``, the device synchronized on both sides."""
    fn = getattr(owner, name)

    def timed(*args, **kw):
        _sync(device)
        t = time.perf_counter()
        out = fn(*args, **kw)
        _sync(device)
        log.append(((time.perf_counter() - t) * 1e3, out))
        return out

    setattr(owner, name, timed)


def _ms_list(log):
    return [round(t, 1) for t, _ in log]


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _zero_counts(fused_match, fused_pose):
    fused_match.LAUNCHES = 0
    fused_pose.LAUNCHES = 0
    fused_pose.LM_LAUNCHES = 0


def _counts(fused_match, fused_pose):
    """Launches since ``_zero_counts``: K1, K2 and the LM step."""
    return {"fused_match": fused_match.LAUNCHES, "fused_pose": fused_pose.LAUNCHES,
            "lm_step": fused_pose.LM_LAUNCHES}


def _short(launches, tracked):
    """Fewer launches than every tracked frame needs: 2 K1, 98 K2 and 88 LM
    steps (two pose solves of 49 K2 calls and 44 steps)."""
    return (launches["fused_match"] < 2 * tracked or launches["fused_pose"] < 98 * tracked
            or launches["lm_step"] < 88 * tracked)


def _check_launches(label, device, launches, tracked):
    """Every tracked frame went through all three kernels (on the card)."""
    if device != "cpu" and _short(launches, tracked):
        raise AssertionError(f"{label} did not run through all three kernels: {launches} "
                             f"for {tracked} tracked frames")


def _per_frame(launches, tracked):
    return (f"({launches['fused_match'] / tracked:.2f}, "
            f"{launches['fused_pose'] / tracked:.2f} and "
            f"{launches['lm_step'] / tracked:.2f} per tracked frame)")


def _phase_stereo(device, fused_match, fused_pose, n_frames=60):
    """``track_stereo`` over the stereo arc; returns (launches, tracked)."""
    from pslam_tpu_torch.io.synthetic import BoxRoom, render_sequence, render_stereo_sequence
    from pslam_tpu_torch.pipeline.frame_ops import make_frame_stereo
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.config import SlamConfig
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig(sensor="stereo", use_lines=False, use_lils=False, use_bow=False,
                     use_loop_closing=False)
    cam = cfg.camera
    t0 = time.perf_counter()
    gl, gr, poses_gt = render_stereo_sequence(cam, n_frames=n_frames)
    # The stereo depths of tests/test_round5.py's frame against its rendered
    # depth.
    room = BoxRoom(seed=1)
    l1, r1, _ = render_stereo_sequence(cam, n_frames=1, room=room)
    _, depth0, _ = render_sequence(cam, n_frames=1, room=room)
    render_s = time.perf_counter() - t0
    fd = make_frame_stereo(torch.from_numpy(l1[0]).to(device), torch.from_numpy(r1[0]).to(device),
                           cam, cfg.orb)
    z, uv = fd.depth.cpu().numpy(), fd.uv.cpu().numpy()
    ok = (z > 0) & fd.valid.cpu().numpy()
    z_gt = depth0[0][np.clip(np.round(uv[ok, 1]).astype(int), 0, cam.height - 1),
                     np.clip(np.round(uv[ok, 0]).astype(int), 0, cam.width - 1)]
    rel = np.abs(z[ok] - z_gt) / np.maximum(z_gt, 1e-6)

    slam = SlamSystem(cfg, device=device)
    _zero_counts(fused_match, fused_pose)
    ms = []
    for i in range(n_frames):
        t = time.perf_counter()
        slam.track_stereo(gl[i], gr[i], i / 30.0)
        _sync(device)
        ms.append((time.perf_counter() - t) * 1e3)
        if slam.state != TrackState.OK:
            raise AssertionError(f"11 stereo: frame {i} ended {slam.state.name}")
    launches = _counts(fused_match, fused_pose)
    ate = ate_rmse(trajectory_positions(slam.poses), trajectory_positions(poses_gt))
    n_kf, tracked = int(slam.map.kf_valid.sum()), n_frames - 1
    print(f"[11 stereo] {cam.width}x{cam.height}, {n_frames} stereo pairs on {device} (rendered "
          f"in {render_s:.1f} s): all OK; tests/test_round5.py's frame: {int(ok.sum())} stereo "
          f"depths, median relative "
          f"error {np.median(rel) * 100:.3f}%, {(rel < 0.05).mean() * 100:.1f}% within 5%; "
          f"keyframes {n_kf}, local BAs {slam.stats['ba_runs']}, ATE {ate * 100:.3f} cm; median "
          f"{np.median(ms[5:]):.2f} ms/frame (frames 5+); launches {launches} "
          f"{_per_frame(launches, tracked)}")
    if n_kf < 3 or slam.stats["ba_runs"] < 1 or not ate < 0.06:
        raise AssertionError("11 stereo: too few keyframes or local BAs, or ATE >= 6 cm")
    if not np.median(rel) < 0.02:
        raise AssertionError("11 stereo: the median relative stereo depth error is >= 2%")
    _check_launches("11 stereo", device, launches, tracked)
    return launches, tracked


def _phase_mono(device, fused_match, fused_pose, n_frames=14):
    """``track_mono`` on tests/test_round4.py's sequence; then the two-view
    initializer again on the card, twice, on the input of the run's
    initialization. Returns (launches, tracked)."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline import system as system_mod
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.config import SlamConfig
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig(sensor="mono", use_lines=False, use_loop_closing=False)
    grays, _, poses_gt = render_sequence(cfg.camera, n_frames=n_frames, seed=6)
    calls = []
    init = system_mod.initialize_two_view

    def recorded(*args, **kw):
        calls.append((args, kw))
        return init(*args, **kw)

    system_mod.initialize_two_view = recorded
    try:
        slam = SlamSystem(cfg, device=device)
        _zero_counts(fused_match, fused_pose)
        init_at, ms = None, []
        for i in range(n_frames):
            t = time.perf_counter()
            slam.track_mono(grays[i], i / 30.0)
            _sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
            if init_at is None and slam.state == TrackState.OK:
                init_at = i
            elif init_at is not None and slam.state != TrackState.OK:
                raise AssertionError(f"12 mono: frame {i} ended {slam.state.name}")
        launches = _counts(fused_match, fused_pose)
    finally:
        system_mod.initialize_two_view = init
    if init_at is None:
        raise AssertionError("12 mono: the two-view initialization never succeeded")
    m = slam.map
    depth_max = float(m.kf_feat_depth[m.kf_valid].max())
    est = trajectory_positions(slam.poses)
    ate = ate_rmse(est, trajectory_positions(poses_gt)[: len(est)], with_scale=True)
    tracked = n_frames - 1 - init_at

    # The initializer on the card, twice, on the input of the successful
    # initialization (the last call), against each other and the run.
    args, kw = calls[-1]
    runs = [[o.clone() for o in init(*args, **kw)] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    worst = max(float((a.double() - b.double()).abs().max()) for a, b in zip(*runs))
    cpu = init(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw)
    cpu_rt = max(float((a.cpu().double() - b.double()).abs().max())
                 for a, b in ((runs[0][2], cpu.R21), (runs[0][3], cpu.t21)))
    print(f"[12 mono] {cfg.camera.width}x{cfg.camera.height}, {n_frames} frames on {device}: "
          f"initialized at frame {init_at} ({len(calls)} two-view attempts, used_H "
          f"{bool(runs[0][1])}, n_good {int(runs[0][6])}), then all OK; keyframes "
          f"{int(m.kf_valid.sum())}, map points {int(m.mp_valid.sum())}, keyframe depth max "
          f"{depth_max}, scale-aligned ATE {ate * 100:.3f} cm; median {np.median(ms[5:]):.2f} "
          f"ms/frame (frames 5+); launches {launches} {_per_frame(launches, tracked)}; "
          f"initializer twice on the card bit-identical {same} (max difference {worst:.3e}), "
          f"card vs cpu R and t within {cpu_rt:.3e}")
    if depth_max != 0.0 or not ate < 0.08:
        raise AssertionError("12 mono: a keyframe depth is not 0, or the ATE is >= 8 cm")
    if not same and worst > 1e-5:
        raise AssertionError(f"12 mono: two card runs of the initializer differ by {worst}")
    _check_launches("12 mono", device, launches, tracked)
    return launches, tracked


def _excursion_poses(n_out=14):
    """tests/test_round5.py's excursion: map the back wall, yaw out to
    150 deg (the map out of view), yaw back."""
    def yaw_pose(yaw, C):
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ np.asarray(C)
        return T

    C0 = np.array([0.0, 0.0, 1.0])
    poses = [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0]) for i in range(12)]
    out_yaws = np.linspace(0.44, 2.6, n_out)
    poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws]
    poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws[::-1][1:]]
    poses += [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0]) for i in range(11, 7, -1)]
    return np.stack(poses).astype(np.float32)


def _phase_vo(device, fused_match, fused_pose):
    """Localization-only mode: the excursion of tests/test_round5.py, then
    the freeze of tests/test_round4.py. Returns (launches, tracked, the
    frozen config-4 system, its frames)."""
    from pslam_tpu_torch.io.synthetic import ClosedRoom, render_sequence
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig(use_lines=False, use_lils=False)
    grays, depths, _ = render_sequence(
        cfg.camera, poses=_excursion_poses(),
        room=ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=4))
    slam = SlamSystem(cfg, device=device)
    for i in range(12):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    if slam.state != TrackState.OK:
        raise AssertionError("13 vo: the map before the excursion is not tracked")
    slam.activate_localization_mode()
    _zero_counts(fused_match, fused_pose)
    states, vo_ms, n_tracked = [], [], 0
    for i in range(12, len(grays)):
        n_vo = slam.stats.get("vo_frames", 0)
        n_tracked += slam.state == TrackState.OK  # a LOST frame tries relocalization instead
        t = time.perf_counter()
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
        _sync(device)
        if slam.stats.get("vo_frames", 0) > n_vo:
            vo_ms.append((time.perf_counter() - t) * 1e3)
        states.append(slam.state)
    launches = _counts(fused_match, fused_pose)
    n_lost = sum(st == TrackState.LOST for st in states)
    n_vo = slam.stats.get("vo_frames", 0)
    print(f"[13 vo] excursion, {len(grays)} frames at {cfg.camera.width}x{cfg.camera.height} on "
          f"{device}: VO frames {n_vo}, LOST frames {n_lost}, relocalizations "
          f"{slam.stats.get('relocs', 0)}, ends {slam.state.name} with VO mode "
          f"{slam._vo_mode}; VO frames median {np.median(vo_ms) if vo_ms else float('nan'):.2f} "
          f"ms; launches {launches} over {len(states)} frames")
    if n_vo < 3 or slam.state != TrackState.OK or slam._vo_mode or n_lost > 4:
        raise AssertionError("13 vo: the excursion was not survived on visual odometry")
    if device != "cpu" and (launches["fused_match"] < 2 * n_tracked + n_vo
                            or launches["fused_pose"] < 98 * n_tracked
                            or launches["lm_step"] < 88 * n_tracked):
        raise AssertionError(f"13 vo: the excursion did not run through all three kernels: "
                             f"{launches}")

    cfg4 = SlamConfig()
    grays, depths, _ = render_sequence(cfg4.camera, n_frames=70, seed=2)
    slam = SlamSystem(cfg4, device=device)
    for i in range(15):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    if slam.state != TrackState.OK:
        raise AssertionError("13 vo: the map before the freeze is not tracked")
    kfs = slam.stats["kf_inserted"]
    slam.activate_localization_mode()
    n_mp = int(slam.map.mp_valid.sum())
    _zero_counts(fused_match, fused_pose)
    for i in range(15, 65):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
        if slam.state != TrackState.OK:
            raise AssertionError(f"13 vo: frozen frame {i} ended {slam.state.name}")
    frozen = _counts(fused_match, fused_pose)
    black, no_depth = np.zeros_like(grays[0]), np.zeros_like(depths[0])
    for j in range(3):
        slam.track_rgbd(black, no_depth, 3.0 + j / 30.0)
    blackout = slam.state
    for j in range(3):
        slam.track_rgbd(grays[20 + j], depths[20 + j], 4.0 + j / 30.0)
        if slam.state == TrackState.OK:
            break
    print(f"[13 vo] freeze, config 4 on {device}: 50 frames tracked against the frozen map "
          f"(keyframes inserted {slam.stats['kf_inserted'] - kfs}, map points "
          f"{int(slam.map.mp_valid.sum()) - n_mp:+d}); blackout ends {blackout.name} with "
          f"resets {slam.stats.get('resets', 0)}; revisit {slam.state.name}, relocalizations "
          f"{slam.stats.get('relocs', 0)}; launches {frozen} {_per_frame(frozen, 50)}")
    if slam.stats["kf_inserted"] != kfs or int(slam.map.mp_valid.sum()) != n_mp:
        raise AssertionError("13 vo: localization-only mode changed the map")
    if blackout != TrackState.LOST or slam.stats.get("resets", 0) != 0:
        raise AssertionError("13 vo: the blackout did not end LOST without a reset")
    if slam.state != TrackState.OK or slam.stats.get("relocs", 0) < 1:
        raise AssertionError("13 vo: no relocalization after the blackout")
    _check_launches("13 vo freeze", device, frozen, 50)
    launches = {k: launches[k] + frozen[k] for k in launches}
    return launches, n_tracked + 50, slam, (grays, depths)


def _phase_pipelined(device, fused_match, fused_pose, cfg, n_frames=60):
    """Config 1 over the arc through ``track_rgbd_pipelined`` + ``finish()``,
    beside a synchronous run; then the mixed-mode drain. Returns (launches,
    tracked, the pipelined system)."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=n_frames, seed=0)
    gt = trajectory_positions(poses_gt)
    out = {}
    for mode in ("sync", "pipelined"):
        slam = SlamSystem(cfg, device=device)
        step = slam.track_rgbd if mode == "sync" else slam.track_rgbd_pipelined
        _zero_counts(fused_match, fused_pose)
        ms = []
        _sync(device)
        t_all = time.perf_counter()
        for i in range(n_frames):
            t = time.perf_counter()
            step(grays[i], depths[i], i / 30.0)
            ms.append((time.perf_counter() - t) * 1e3)
            if slam.state != TrackState.OK:
                raise AssertionError(f"14 {mode}: frame {i} ended {slam.state.name}")
        slam.finish()
        _sync(device)
        wall = (time.perf_counter() - t_all) * 1e3 / n_frames
        out[mode] = dict(slam=slam, ms=np.asarray(ms), wall=wall,
                         launches=_counts(fused_match, fused_pose),
                         ate=ate_rmse(trajectory_positions(slam.poses), gt))
    pipe, sync = out["pipelined"], out["sync"]
    slam = pipe["slam"]
    tracked = n_frames - 1

    drain = SlamSystem(cfg, device=device)
    for i in range(4):
        drain.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
    drain.track_rgbd(grays[4], depths[4], 4 / 30.0)
    drained = drain._inflight is None and len(drain.trajectory) == 5
    for i in range(5, 8):
        drain.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
    drain.finish()
    drained = drained and len(drain.trajectory) == 8
    print(f"[14 pipelined] config 1, {n_frames} frames on {device}: {len(slam.trajectory)} "
          f"trajectory rows, keyframes {int(slam.map.kf_valid.sum())}; ATE pipelined "
          f"{pipe['ate'] * 100:.3f} cm, sync {sync['ate'] * 100:.3f} cm; median call "
          f"{np.median(pipe['ms'][5:]):.2f} ms pipelined, {np.median(sync['ms'][5:]):.2f} ms sync "
          f"(frames 5+); wall {pipe['wall']:.2f} ms/frame pipelined, {sync['wall']:.2f} sync; "
          f"mixed-mode drain {drained}; launches {pipe['launches']} "
          f"{_per_frame(pipe['launches'], tracked)}")
    if len(slam.trajectory) != n_frames or not pipe["ate"] < 0.05:
        raise AssertionError("14 pipelined: trajectory rows missing or ATE >= 5 cm")
    if not pipe["ate"] < max(2.5 * sync["ate"], 0.03):
        raise AssertionError("14 pipelined: ATE far above the synchronous run's")
    if not drained:
        raise AssertionError("14 pipelined: the mixed-mode drain failed")
    _check_launches("14 pipelined", device, pipe["launches"], tracked)
    for mode, run in out.items():
        if run["slam"].stats.get("pose_lm_steps", 0) != run["launches"]["lm_step"]:
            raise AssertionError(f"14 {mode}: stats['pose_lm_steps'] does not count every "
                                 f"LM step")
    return pipe["launches"], tracked, slam


def _phase_checkpoint(device, fused_match, fused_pose, slam14, slam13, frames13):
    """Save + load on the card: the phase-14 system (config 1) and the
    phase-13 frozen config-4 system, which then tracks 5 more frames.
    Returns the launches of those 5 frames."""
    from pslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from pslam_tpu_torch.pipeline.system import TrackState

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    differ = {}
    loaded = {}
    for name, slam in (("config 1", slam14), ("config 4", slam13)):
        path = out_dir / f"checkpoint_{name.replace(' ', '')}.npz"
        t = time.perf_counter()
        save_checkpoint(slam, str(path))
        again = load_checkpoint(str(path), slam.cfg, device=device)
        ms = (time.perf_counter() - t) * 1e3
        a, b = _map_arrays(slam), _map_arrays(again)
        differ[name] = [k for k in a if not np.array_equal(a[k], b[k])]
        if not np.array_equal(slam.poses, again.poses) or again.device.type != device:
            differ[name].append("poses or device")
        loaded[name] = (again, path.stat().st_size / 2**20, ms)
    resumed = loaded["config 4"][0]
    grays, depths = frames13
    _zero_counts(fused_match, fused_pose)
    states = []
    for i in range(23, 28):
        resumed.track_rgbd(grays[i], depths[i], 5.0 + i / 30.0)
        states.append(resumed.state.name)
    launches = _counts(fused_match, fused_pose)
    print(f"[15 checkpoint] on {device}: "
          + "; ".join(f"{n}: {size:.1f} MiB, save + load {ms:.0f} ms, map arrays differing "
                      f"{differ[n]}" for n, (_, size, ms) in loaded.items())
          + f"; the resumed config-4 system tracks frames 23-27: {states}, relocalizations "
          f"{resumed.stats.get('relocs', 0)}; launches {launches}")
    if any(differ.values()):
        raise AssertionError(f"15 checkpoint: a loaded system differs: {differ}")
    if states != ["OK"] * 5:
        raise AssertionError("15 checkpoint: the resumed system did not track on")
    if device != "cpu" and _short(launches, 1):
        raise AssertionError(f"15 checkpoint: the resumed frames did not launch all three "
                             f"kernels")
    if resumed.state != TrackState.OK:
        raise AssertionError("15 checkpoint: the resumed system is not OK")
    return launches


# tests/test_tum_io.py's settings (Examples/RGB-D/TUM1.yaml: the distorted
# TUM1 lens).
TUM1_SETTINGS = """\
%YAML:1.0
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _write_png(path, arr, paeth=False):
    """A minimal PNG writer (the card's machine has no PIL): 8-bit gray or
    RGB, or 16-bit gray; every row filter type 0, or with ``paeth`` type 4
    (the decoder's slowest case)."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    colour = 2 if arr.ndim == 3 else 0
    depth = 16 if arr.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr).reshape(h, -1)
    data = raw.view(np.uint8).astype(np.int64)
    if paeth:
        bpp = data.shape[1] // w
        up = np.r_[np.zeros((1, data.shape[1]), np.int64), data[:-1]]
        left = np.pad(data, ((0, 0), (bpp, 0)))[:, :-bpp]
        ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        data = (data - pred) % 256
    rows = np.concatenate([np.full((h, 1), 4 if paeth else 0), data], axis=1).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _tum_dataset(root, n_frames=12, seed=4):
    """tests/test_tum_io.py's distorted dataset at 640x480: settings, PNGs
    and association file under ``root``. Returns (settings path, true
    poses)."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.io.tum import config_from_settings, load_settings_yaml

    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    settings = root / "settings.yaml"
    settings.write_text(TUM1_SETTINGS)
    cam = config_from_settings(load_settings_yaml(str(settings))).camera
    grays, depths, poses_gt = render_sequence(cam, n_frames=n_frames, seed=seed,
                                              use_distortion=True)
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = 1305031102.0 + i / 30.0
        rgb8 = np.stack([np.clip(g, 0, 255).astype(np.uint8)] * 3, -1)
        d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
        _write_png(root / "rgb" / f"{i}.png", rgb8)
        _write_png(root / "depth" / f"{i}.png", d16)
        if i == 0:  # frame 0 again with every row Paeth-filtered, to time the decoder
            _write_png(root / "rgb_paeth.png", rgb8, paeth=True)
            _write_png(root / "depth_paeth.png", d16, paeth=True)
        rows.append(f"{t:.6f} rgb/{i}.png {t:.6f} depth/{i}.png")
    (root / "assoc.txt").write_text("\n".join(rows) + "\n")
    return settings, poses_gt


def _run_app(args, fused_match, fused_pose):
    """``apps.rgbd_tum.main(args)`` with the system it builds recorded, its
    stderr captured and the launch counters read around it. Returns
    (system, the states after each frame, stderr, launches, seconds)."""
    import io
    from pslam_tpu_torch.apps.rgbd_tum import main
    from pslam_tpu_torch.pipeline import system as sysmod

    made, states = [], []
    base = sysmod.SlamSystem

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def track_rgbd(self, *a, **kw):
            T = super().track_rgbd(*a, **kw)
            states.append(self.state.name)
            return T

    err = io.StringIO()
    sysmod.SlamSystem = Recorded
    _zero_counts(fused_match, fused_pose)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = main(args)
    finally:
        sysmod.SlamSystem = base
    seconds = time.perf_counter() - t0
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"16 tum app: main returned {rc}\n{err.getvalue()}")
    return made[0], states, err.getvalue(), _counts(fused_match, fused_pose), seconds


def _phase_tum_app(device, fused_match, fused_pose, ms4):
    """The TUM app at full width on ``device``, twice; returns (launches,
    tracked frames) of both runs."""
    from pslam_tpu_torch.apps.visualize import dump_map_npz, dump_map_ply
    from pslam_tpu_torch.io.tum import load_depth, load_rgb_gray
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / "tum"
    t0 = time.perf_counter()
    settings, poses_gt = _tum_dataset(out / "seq")
    write_s = time.perf_counter() - t0
    seq = out / "seq"
    decode_ms = {}
    for name, load in (("rgb", load_rgb_gray), ("depth", load_depth)):
        decoded = []
        for label, path in (("filter 0", seq / name / "0.png"),
                            ("Paeth", seq / f"{name}_paeth.png")):
            t0 = time.perf_counter()
            decoded.append(load(str(path)))
            decode_ms[f"{name} {label}"] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(*decoded):
            raise AssertionError(f"16 tum app: the Paeth-filtered {name} PNG decodes otherwise")
    gt = trajectory_positions(poses_gt)
    base = [str(settings), str(seq), str(seq / "assoc.txt")]
    n = len(poses_gt)
    dev_flag = ["--device", device]
    results = {}
    with contextlib.chdir(out):
        for name, flags in (("run1", ["--no-lines", "--no-loop", "--kitti"]), ("run2", [])):
            slam, states, err, launches, secs = _run_app(base + [name] + flags + dev_flag,
                                                         fused_match, fused_pose)
            f = np.loadtxt(f"f_{name}.txt")
            kf = np.atleast_2d(np.loadtxt(f"kf_{name}.txt"))
            ate = ate_rmse(f[:, 1:4], gt)
            summary = [ln for ln in err.splitlines() if "tracking time" in ln]
            report = err[err.index("stage "):].split("\nsaved")[0]
            print(f"[16 tum app] {name} {' '.join(flags) or '(default flags: config 4)'}: "
                  f"{len(f)} rows, {len(kf)} keyframe rows, states {states}, ATE "
                  f"{ate * 100:.3f} cm, {secs:.1f} s; {'; '.join(summary)} (phase 4: median "
                  f"{ms4:.2f} ms/frame); launches {launches} {_per_frame(launches, n - 1)}")
            print("[16 tum app] " + report.replace("\n", "\n[16 tum app] "))
            if f.shape != (n, 8) or kf.shape[1] != 8 or states != ["OK"] * n:
                raise AssertionError(f"16 tum app {name}: wrong trajectory files or a frame "
                                     f"not tracked: {f.shape}, {kf.shape}, {states}")
            if not ate < 0.05:
                raise AssertionError(f"16 tum app {name}: ATE {ate * 100:.3f} cm >= 5 cm")
            results[name] = (slam, launches)
        kitti = np.loadtxt("kitti_run1.txt")
        if kitti.shape != (n, 12):
            raise AssertionError(f"16 tum app: KITTI file of shape {kitti.shape}")
        _check_launches("16 tum app run 1", device, results["run1"][1], n - 1)
        _check_launches("16 tum app run 2", device, results["run2"][1], n - 1)
        slam = results["run2"][0]
        m = slam.map
        ply = dump_map_ply(m, "map.ply")
        npz = np.load(dump_map_npz(m, "map.npz"))
        k = m.n_kf
        expect = dict(mp_pos=m.mp_pos[m.mp_valid], mp_n_obs=m.mp_n_obs[m.mp_valid],
                      ml_pos=m.ml_pos[m.ml_valid], ml_n_obs=m.ml_n_obs[m.ml_valid],
                      il_state=m.il_state[m.il_valid], il_plane=m.il_plane[m.il_valid],
                      kf_pose=m.kf_pose[:k][m.kf_valid[:k]],
                      kf_timestamp=m.kf_timestamp[:k][m.kf_valid[:k]])
        differ = [key for key, v in expect.items() if not np.array_equal(npz[key], v)]
        n_vertex = int(Path(ply).read_text().split("element vertex ")[1].split()[0])
        want = (len(expect["mp_pos"]) + 2 * len(expect["ml_pos"]) + 5 * len(expect["il_state"]))
    print(f"[16 tum app] dataset written in {write_s:.1f} s; PNG decode at 640x480 (host): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in decode_ms.items()) + "; map dump of run 2: "
          f"{len(expect['mp_pos'])} points, {len(expect['ml_pos'])} lines, "
          f"{len(expect['il_state'])} LILs, PLY vertices {n_vertex}, NPZ arrays differing "
          f"{differ}")
    if differ or n_vertex != want or not len(expect["mp_pos"]):
        raise AssertionError(f"16 tum app: the map dumps disagree with the map: {differ}, "
                             f"{n_vertex} vs {want} vertices")
    l1, l2 = results["run1"][1], results["run2"][1]
    return {k: l1[k] + l2[k] for k in l1}, 2 * (n - 1)


def _se3_exp_np(xi):
    from pslam_tpu_torch.geometry import se3_exp

    return se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def _ba_problem(seed=11, n_cams=6, n_pts=300, n_fixed=2, pad_to=8):
    """tests/test_solver.py's ``TestLocalBA._ba_problem(seed=11)`` in numpy,
    padded as tests/test_parallel.py pads it: a numpy BAProblem dict, the
    true poses, n_free."""
    from pslam_tpu_torch.geometry import Camera, project_stereo

    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 2.0], [3, 2, 8.0], size=(n_pts, 3)).astype(np.float32)
    T_true = np.stack([_se3_exp_np(np.concatenate(
        [rng.normal(0, 0.02, 3), [0.3 * i - 0.75, 0, 0.05 * i]])) for i in range(n_cams)])
    cam_idx, pt_idx, obs = [], [], []
    for c in range(n_cams):
        Xc = X @ T_true[c, :3, :3].T + T_true[c, :3, 3]
        uvr = project_stereo(cam, torch.from_numpy(Xc)).numpy()
        vis = ((Xc[:, 2] > 0.3) & (uvr[:, 0] > 0) & (uvr[:, 0] < 640) & (uvr[:, 1] > 0)
               & (uvr[:, 1] < 480))
        idx = np.where(vis)[0]
        cam_idx.append(np.full(len(idx), c))
        pt_idx.append(idx)
        obs.append(uvr[idx] + rng.normal(0, 0.3, size=(len(idx), 3)).astype(np.float32))
    cam_idx = np.concatenate(cam_idx).astype(np.int64)
    pt_idx = np.concatenate(pt_idx).astype(np.int64)
    obs = np.concatenate(obs).astype(np.float32)
    T_pert = T_true.copy()
    for c in range(n_fixed, n_cams):
        xi = rng.normal(0, 0.01, 6).astype(np.float32)
        xi[3:] *= 5.0
        T_pert[c] = _se3_exp_np(xi) @ T_pert[c]
    X_pert = X + rng.normal(0, 0.03, size=X.shape).astype(np.float32)
    free_slot = np.full(n_cams, -1, np.int64)
    free_slot[n_fixed:] = np.arange(n_cams - n_fixed)

    def pad(a, fill=0):
        n = -(-len(a) // pad_to) * pad_to
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    E = len(cam_idx)
    prob = dict(T_cw=T_pert, free_slot=free_slot, X_w=pad(X_pert),
                point_valid=pad(np.ones(n_pts, bool), False), cam_idx=pad(cam_idx),
                pt_idx=pad(pt_idx), obs=pad(obs), inv_sigma2=pad(np.ones(E, np.float32), 1.0),
                edge_valid=pad(np.ones(E, bool), False))
    return prob, T_true, n_cams - n_fixed, cam


def _lil_problem(T_true, Q=8, pad_to=8):
    """tests/test_parallel.py's LIL problem (``_make_lils`` of
    tests/test_lil.py, its camera) in numpy: (ledges dict, lil_state,
    lil_valid)."""
    from pslam_tpu_torch.geometry import Camera, project

    lil_cam = Camera(fx=400.0, fy=400.0, cx=320.0, cy=240.0, bf=40.0)

    def make_lils(rng, T):
        states, obses = [], []
        for _ in range(Q):
            X = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0]).astype(np.float32)
            d1 = rng.normal(size=3)
            d1 /= np.linalg.norm(d1)
            d2 = rng.normal(size=3)
            d2 -= d1 * (d1 @ d2)
            d2 /= np.linalg.norm(d2)
            state = np.concatenate([X - 0.5 * d1, X + 0.7 * d1, X - 0.6 * d2, X + 0.4 * d2,
                                    X]).astype(np.float32)
            pts_c = state.reshape(5, 3) @ T[:3, :3].T + T[:3, 3]
            uv = project(lil_cam, torch.from_numpy(pts_c.astype(np.float32))).numpy()

            def line_eq(a, b):
                la, lb, lc = a[1] - b[1], b[0] - a[0], a[0] * b[1] - a[1] * b[0]
                n_ = np.hypot(la, lb)
                return np.array([la / n_, lb / n_, lc / n_])

            obses.append(np.concatenate([line_eq(uv[0], uv[1]), line_eq(uv[2], uv[3]),
                                         uv[4]]).astype(np.float32))
            states.append(state)
        return np.stack(states), np.stack(obses)

    rng = np.random.default_rng(7)
    le_cam, le_lil, le_obs, lil_states = [], [], [], None
    for c in range(len(T_true)):
        st_c, obs_c = make_lils(np.random.default_rng(7), T_true[c])
        lil_states = st_c if lil_states is None else lil_states
        le_cam.extend([c] * Q)
        le_lil.extend(range(Q))
        le_obs.append(obs_c)
    El = len(le_cam)
    n = -(-El // pad_to) * pad_to

    def pad(a, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:El] = a
        return out

    ledges = dict(cam_idx=pad(np.asarray(le_cam, np.int64)),
                  lil_idx=pad(np.asarray(le_lil, np.int64)),
                  obs=pad(np.concatenate(le_obs)), valid=pad(np.ones(El, bool), False))
    state = lil_states + np.tile(rng.normal(0, 0.05, (Q, 3)).astype(np.float32), (1, 5))
    return ledges, state.astype(np.float32), np.ones(Q, bool)


def _drift_pose_graph(K=12, E_pad=16, seed=1):
    """tests/test_parallel.py's ``_drift_pose_graph``: an odometry circle
    with drift and one loop edge, in numpy with the port's Sim3."""
    from pslam_tpu_torch.geometry.lie import Sim3, sim3_compose, sim3_exp, sim3_inverse

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    rng = np.random.default_rng(seed)
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = _se3_exp_np([0.0, a, 0.0, np.cos(a), 0.0, np.sin(a)])
        gt.append(Sim3(s=t(1.0), R=t(T[:3, :3]), t=t(T[:3, 3])))
    meas = [sim3_compose(gt[i + 1], sim3_inverse(gt[i])) for i in range(K - 1)]
    est = [gt[0]]
    for i in range(K - 1):
        noisy = sim3_compose(sim3_exp(t(np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3),
                                              rng.normal(0, 0.005)])), meas[i])
        est.append(sim3_compose(noisy, est[i]))
    all_meas = meas + [sim3_compose(gt[0], sim3_inverse(gt[K - 1]))]
    E = len(all_meas)
    e_i, e_j = np.zeros(E_pad, np.int64), np.zeros(E_pad, np.int64)
    e_i[:E] = np.r_[np.arange(K - 1), [K - 1]]
    e_j[:E] = np.r_[np.arange(1, K), [0]]
    s, R = np.ones(E_pad, np.float32), np.tile(np.eye(3, dtype=np.float32), (E_pad, 1, 1))
    tt, ok = np.zeros((E_pad, 3), np.float32), np.zeros(E_pad, bool)
    s[:E] = [float(m.s) for m in all_meas]
    R[:E] = np.stack([m.R.numpy() for m in all_meas])
    tt[:E] = np.stack([m.t.numpy() for m in all_meas])
    ok[:E] = True
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(s=np.stack([float(e.s) for e in est]).astype(np.float32),
                R=np.stack([e.R.numpy() for e in est]), t=np.stack([e.t.numpy() for e in est]),
                fixed=fixed, vertex_valid=np.ones(K, bool), e_i=e_i, e_j=e_j, e_s=s, e_R=R,
                e_t=tt, e_valid=ok)


def _solver_inputs(dev):
    """The three solvers' problems of tests/test_parallel.py on ``dev``."""
    from pslam_tpu_torch.geometry.lie import Sim3
    from pslam_tpu_torch.solver.ba_lil import LILBAEdges
    from pslam_tpu_torch.solver.local_ba import BAProblem
    from pslam_tpu_torch.solver.sim3_graph import PoseGraphProblem

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    ba, T_true, n_free, cam = _ba_problem()
    ledges, lil_state, lil_valid = _lil_problem(T_true)
    g = _drift_pose_graph()
    prob = BAProblem(**{k: t(v) for k, v in ba.items()})
    graph = PoseGraphProblem(S=Sim3(t(g["s"]), t(g["R"]), t(g["t"])), fixed=t(g["fixed"]),
                             vertex_valid=t(g["vertex_valid"]), e_i=t(g["e_i"]),
                             e_j=t(g["e_j"]), e_Sji=Sim3(t(g["e_s"]), t(g["e_R"]), t(g["e_t"])),
                             e_valid=t(g["e_valid"]))
    return (cam, n_free, prob, t(lil_state), t(lil_valid),
            LILBAEdges(**{k: t(v) for k, v in ledges.items()}), graph)


def _phase_distributed(device, fused_match, fused_pose, cfg, base, n_frames=60):
    """A one-rank process group (NCCL on the card): the sharded solvers
    against the single-device ones, bit for bit, and ``cfg`` with
    distributed=True over ``n_frames`` of the arc against ``base``, the
    system of the same frames without it (phase 4). Returns (launches,
    tracked)."""
    import torch.distributed as dist
    from pslam_tpu_torch.parallel.sharded_ba import (
        sharded_local_bundle_adjustment,
        sharded_local_bundle_adjustment_lil,
    )
    from pslam_tpu_torch.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
    from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment
    from pslam_tpu_torch.solver.sim3_graph import optimize_essential_graph

    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl" and not dist.is_nccl_available():
        raise AssertionError("17 distributed: this torch has no NCCL")
    init = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dist_init"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=0, world_size=1)
    try:
        cam, n_free, prob, lil_state, lil_valid, ledges, graph = _solver_inputs(device)
        pairs = {
            "point BA": (lambda: sharded_local_bundle_adjustment(cam, prob, n_free),
                         lambda: local_bundle_adjustment(cam, prob, n_free)),
            "LIL BA": (lambda: sharded_local_bundle_adjustment_lil(
                           cam, prob, lil_state, lil_valid, ledges, n_free),
                       lambda: local_bundle_adjustment_lil(
                           cam, prob, lil_state, lil_valid, ledges, n_free)),
            "essential graph": (lambda: optimize_essential_graph_sharded(graph, n_iters=20),
                                lambda: optimize_essential_graph(graph, n_iters=20)),
        }
        for name, (sharded, single) in pairs.items():
            outs, ms = {}, {"sharded": [], "single": []}
            for label, fn in (("sharded", sharded), ("single", single)) * 2:
                _sync(device)
                t0 = time.perf_counter()
                outs[label] = fn()
                _sync(device)
                ms[label].append((time.perf_counter() - t0) * 1e3)
            same = all(torch.equal(x, y) for x, y in zip(outs["sharded"], outs["single"]))
            print(f"[17 distributed] one {backend} rank, {name}: bit-identical to the "
                  f"single-device solver {same}; ms per call (the first with warm-up) sharded "
                  f"{[round(x, 2) for x in ms['sharded']]}, single "
                  f"{[round(x, 2) for x in ms['single']]}")
            if not same:
                d = max(float((x.double() - y.double()).abs().max())
                        for x, y in zip(outs["sharded"], outs["single"]))
                raise AssertionError(f"17 distributed: sharded {name} differs from the "
                                     f"single-device solver by {d:.3e}")
        _zero_counts(fused_match, fused_pose)
        slam, ms, *_ = _run_slice(dataclasses.replace(cfg, distributed=True), device, n_frames)
        launches = _counts(fused_match, fused_pose)
        same = np.array_equal(slam.poses, base.poses)
        print(f"[17 distributed] {'config 1' if not cfg.use_lines else 'config'} with "
              f"distributed=True at world size 1 over {n_frames} frames: trajectory "
              f"bit-identical to the run without it {same}; local BAs {slam.stats['ba_runs']}, "
              f"median {np.median(ms[5:]):.2f} ms/frame; launches {launches} "
              f"{_per_frame(launches, n_frames - 1)}")
        if not same:
            raise AssertionError("17 distributed: the distributed=True run differs")
        _check_launches("17 distributed", device, launches, n_frames - 1)
    finally:
        dist.destroy_process_group()
    return launches, n_frames - 1


def _phase_long(device, fused_match, fused_pose, n_frames=300):
    """``apps.run_long``'s function, pipelined, with the default config over
    ``n_frames`` of its double-loop circuit. Returns (launches, tracked)."""
    from pslam_tpu_torch.apps import run_long

    _zero_counts(fused_match, fused_pose)
    row = run_long.run(n_frames, pipelined=True, device=device)
    launches = _counts(fused_match, fused_pose)
    tracked = row["tracked"]
    print(f"[18 long] config 4, {n_frames} frames pipelined on {device}: "
          f"{json.dumps(row)}; launches {launches} {_per_frame(launches, tracked)}")
    if row["resets"] != 0 or row["loops"] < 1:
        raise AssertionError("18 long: a reset, or no loop closed")
    if row["kf_culled"] < 1 or not row["kf_inserted"] > row["kf_slots"]:
        raise AssertionError("18 long: no keyframe culled, or no keyframe slot reused")
    if not row["ate_cm"] < run_long.ATE_BAR_M * 100:
        raise AssertionError(f"18 long: ATE {row['ate_cm']:.3f} cm >= 10 cm")
    _check_launches("18 long", device, launches, tracked)
    return launches, tracked


def _phase_lowtex(device, fused_match, fused_pose):
    """``apps.lowtex`` at its default 120 frames: every config completes with
    a finite ATE, and the +lines and +LILs runs hold map lines unless the
    system never initialized, which must then be the RGB-D gate's doing: no
    frame of the scene carries the depth-backed features it needs. Returns
    the launches."""
    from pslam_tpu_torch.apps import lowtex
    from pslam_tpu_torch.pipeline.frame_ops import make_frame
    from pslam_tpu_torch.utils.config import SlamConfig

    _zero_counts(fused_match, fused_pose)
    rows = lowtex.run(device=device)
    launches = _counts(fused_match, fused_pose)
    cfg = SlamConfig()
    gate = min(500, cfg.orb.capacity // 2)  # SlamSystem._initialize
    grays, depths, _ = lowtex.frames(cfg.camera, rows[0]["n_frames"])
    n_depth = []
    for g, d in zip(grays, depths):
        fd = make_frame(torch.from_numpy(np.asarray(g, np.float32)).to(device),
                        torch.from_numpy(np.asarray(d, np.float32)).to(device),
                        cfg.camera, cfg.orb)
        n_depth.append(int((fd.depth > 0).sum()))  # what _initialize counts
    print(f"[19 lowtex] {len(grays)} frames on {device}: features with depth a frame "
          f"{min(n_depth)}-{max(n_depth)} (the RGB-D initialization gate needs {gate}); "
          f"launches {launches}")
    for row in rows:
        print(f"[19 lowtex] {json.dumps(row)}")
        if not np.isfinite(row["ate_cm"]) or not np.isfinite(row["online_cm"]):
            raise AssertionError(f"19 lowtex: {row['name']} has no finite ATE")
        if row["name"] != "points" and row["map_lines"] < 1:
            if row["kf_inserted"] > 0 or max(n_depth) >= gate:
                raise AssertionError(f"19 lowtex: {row['name']} holds no map line")
    return launches


PROFILE_REPS = dict(frame=10, backend=5, ba=3, graph=2)  # the scripts' R are ceilings


def _check_profile_rows(label, rows):
    """Phase 20's bars on one app's rows."""
    for r in rows:
        nums = [v for k, v in r.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
        if not all(np.isfinite(v) for v in nums):
            raise AssertionError(f"20 {label}: {r['name']} has a non-finite number: {r}")
        if not r["event_ms"] > 0:
            raise AssertionError(f"20 {label}: {r['name']} event_ms {r['event_ms']}")
        if isinstance(r["device_ms"], float) and r["device_ms"] > 1.05 * r["event_ms"]:
            raise AssertionError(f"20 {label}: {r['name']} device {r['device_ms']} ms above "
                                 f"1.05 x event {r['event_ms']} ms")
        if r["share"] is None or r["share"] > 1.05:
            raise AssertionError(f"20 {label}: {r['name']} share {r['share']}")


def _in_own_process(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a fresh spawned process, which ends with
    the call: the profiler's trace degrades after a few hundred thousand
    activities in one process (utils/profile.py)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(fn, args, kwargs)


def _phase_profiles(device):
    """The three stage profilers at full width on ``device`` (phase 20),
    each app in a process of its own. Its launches are counted by the rows
    (K1 / K2 a call), in those processes."""
    from pslam_tpu_torch.apps import profile_backend, profile_frame, roofline
    from pslam_tpu_torch.utils import profile as P

    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    frame = _in_own_process(profile_frame.run, device, reps=PROFILE_REPS["frame"])
    t1 = time.perf_counter()
    backend = _in_own_process(profile_backend.run, device, reps=PROFILE_REPS["backend"],
                              ba_reps=PROFILE_REPS["ba"], graph_reps=PROFILE_REPS["graph"])
    t2 = time.perf_counter()
    roof = _in_own_process(roofline.run, device, reps=PROFILE_REPS["frame"],
                           ba_reps=PROFILE_REPS["ba"])
    t3 = time.perf_counter()
    tables = {
        "profile_frame": P.table(frame, "Frame program (apps.profile_frame)", device),
        "profile_backend": P.table(backend, "Backend (apps.profile_backend)", device),
        "roofline": roofline.table(roof, device),
    }
    for name, text in tables.items():
        (out / f"{name}.md").write_text(text)
        print(text)
    print(f"[20 profiles] profile_frame {t1 - t0:.1f} s, profile_backend {t2 - t1:.1f} s, "
          f"roofline {t3 - t2:.1f} s (each in its own process); tables in {out}")
    for label, rows in (("profile_frame", frame), ("profile_backend", backend),
                        ("roofline", roof)):
        _check_profile_rows(label, rows)
    by_name = {r["name"]: r for r in frame + roof}
    for name in ("track_against_points", "match+pose (motion model)"):
        r = by_name[name]
        if (r["k1"], r["k2"]) != (1, 49):
            raise AssertionError(f"20 profiles: {name} launched K1 {r['k1']} and K2 {r['k2']} "
                                 "times a call, not 1 and 49")
    r = by_name["frame_step (real map)"]
    if r["k1"] < 2 or r["k2"] < 98:
        raise AssertionError(f"20 profiles: frame_step (real map) launched K1 {r['k1']} and "
                             f"K2 {r['k2']} times a frame")
    for r in backend:
        if "max_dT" in r and r["max_dT"] != 0.0:
            raise AssertionError(f"20 profiles: {r['name']} differs from the plain solver by "
                                 f"{r['max_dT']}")


def _configs():
    """(config 1, config 3, the small config 1 of phase 5)."""
    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.ops.orb import OrbConfig
    from pslam_tpu_torch.utils.config import Capacities, SlamConfig

    small_cam = Camera(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                       width=320, height=240)
    small = SlamConfig(camera=small_cam, orb=OrbConfig(n_features=500),
                       caps=Capacities(local_points=1024), use_lines=False,
                       use_bow=False, use_loop_closing=False)
    return (SlamConfig(use_lines=False, use_bow=False, use_loop_closing=False),
            SlamConfig(use_bow=False, use_loop_closing=False), small)


def _kernel_entries(k1, k2, lm, launches, per_frame):
    """The ``kernels`` line: K1, K2 and (when phase 3b ran, ``lm`` not None)
    the LM step, which replaces no TPU kernel."""
    rows = [("fused_match", "fused_match", "pslam_tpu/ops/pallas_match.py:40", k1),
            ("fused_pose", "fused_pose", "pslam_tpu/ops/pallas_pose.py:36", k2)]
    if lm is not None:
        rows.append(("lm_step", "fused_pose", None, lm))
    return [dict(name=name, route="cuda", source=f"pslam_tpu_torch/csrc/{src}.cu",
                 replaces=replaces, launches=launches.get(name),
                 launches_per_tracked_frame=per_frame.get(name), library_ms=None, **k)
            for name, src, replaces, k in rows]


def measure(root):
    """Phases 0-3 and both 60-frame slices with the package at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    _identity()
    dev = torch.device("cuda", 0)
    import pslam_tpu_torch  # noqa: F401  (turns TF32 off)
    from pslam_tpu_torch.ops import _build, fused_match, fused_pose

    print(f"[measure] pslam_tpu_torch from {Path(pslam_tpu_torch.__file__).parent}")
    _phase_build(_build, check_spill=False)
    k1, k2 = _phase_k1(fused_match, dev), _phase_k2(fused_pose, dev)
    cfg1, cfg3, _ = _configs()
    window = (15, 30)
    slices = {}
    for name, cfg in (("config 1", cfg1), ("config 3", cfg3)):
        slam, ms, _, _, _, ate, (dev_ms, n_dev) = _run_slice(cfg, "cuda", 60, profile=window)
        outside = np.delete(ms, np.arange(*window))[5:]
        slices[name] = dict(median_ms_per_frame=float(np.median(outside)),
                            device_ms_per_frame=dev_ms, device_activities_per_frame=n_dev,
                            ate_cm=ate * 100)
        print(f"[measure] {name}: median {slices[name]['median_ms_per_frame']:.2f} ms/frame "
              f"(frames 5+ outside {window[0]}-{window[1] - 1}); device {dev_ms:.3f} ms and "
              f"{n_dev:.0f} activities a frame over frames {window[0]}-{window[1] - 1}; "
              f"ATE {ate * 100:.3f} cm")
    print(json.dumps({"measure": {"root": str(root), "kernels": _kernel_entries(k1, k2, None, {}, {}),
                                  "slices": slices}}))


def main():
    _identity()
    dev = torch.device("cuda", 0)
    import pslam_tpu_torch  # noqa: F401  (turns TF32 off)
    from pslam_tpu_torch.ops import _build, fused_match, fused_pose
    from pslam_tpu_torch.ops.lines import LineConfig

    _phase_build(_build, check_spill=True)
    k1 = _phase_k1(fused_match, dev)
    k2 = _phase_k2(fused_pose, dev)
    cfg, cfg3, small = _configs()
    small3 = dataclasses.replace(small, use_lines=True, use_lils=True,
                                 lines=LineConfig(tile=8))
    lm = _phase_lm(fused_pose, dev, (("config 1 320x240", small), ("config 3 320x240", small3)))
    _phase_ba_graph(dev)

    slam4, launches, tracked, ms4 = _drive_main_path("4 slice", cfg, 60, fused_match,
                                                     fused_pose)

    from pslam_tpu_torch.io.synthetic import arc_trajectory

    poses = arc_trajectory(24)[:8]
    g_run = _run_slice(small, "cuda", 8, poses)
    c_run = _run_slice(small, "cpu", 8, poses)
    diff = float(np.linalg.norm(g_run[4] - c_run[4], axis=1).max())
    same_kf = np.array_equal(g_run[2], c_run[2])
    print(f"[5 card vs cpu] 320x240, 8 frames: same states {g_run[3] == c_run[3]}, "
          f"same keyframes {same_kf}, max centre difference {diff * 1000:.3f} mm, "
          f"ATE card {g_run[5] * 100:.3f} cm, cpu {c_run[5] * 100:.3f} cm")
    if g_run[3] != c_run[3] or not same_kf or diff > 0.02:
        raise AssertionError("card and CPU runs of the small slice disagree")

    slam3, launches3, tracked3, _ = _drive_main_path("6 lines", cfg3, 60, fused_match,
                                                     fused_pose)
    m = slam3.map
    n_ml, n_il = int(m.ml_valid.sum()), int(m.il_valid.sum())
    n_reobs = int((m.il_n_obs[m.il_valid] >= 2).sum())
    print(f"[6 lines] map lines {n_ml}, LIL landmarks {n_il} ({n_reobs} re-observed), "
          f"LIL BA edges {slam3.stats.get('lil_ba_edges', 0)}, lines triangulated "
          f"{slam3.stats.get('lines_triangulated', 0)}, fused "
          f"{slam3.stats.get('lines_fused', 0)}, LILs culled "
          f"{slam3.stats.get('lils_culled', 0)}")
    if n_ml < 1 or n_il < 1 or n_reobs < 1 or slam3.stats.get("lil_ba_edges", 0) < 1:
        raise AssertionError("structural-line slice: no map lines, no re-observed LIL "
                             "or no local BA with LIL edges")

    _phase_repeat(small3)
    launches8 = _phase_reloc("cuda", fused_match, fused_pose)
    _phase_loop()
    launches10, tracked10 = _phase_config4("cuda", fused_match, fused_pose)
    launches11, tracked11 = _phase_stereo("cuda", fused_match, fused_pose)
    launches12, tracked12 = _phase_mono("cuda", fused_match, fused_pose)
    launches13, tracked13, slam13, frames13 = _phase_vo("cuda", fused_match, fused_pose)
    launches14, tracked14, slam14 = _phase_pipelined("cuda", fused_match, fused_pose, cfg)
    launches15 = _phase_checkpoint("cuda", fused_match, fused_pose, slam14, slam13, frames13)
    launches16, tracked16 = _phase_tum_app("cuda", fused_match, fused_pose, ms4)
    launches17, tracked17 = _phase_distributed("cuda", fused_match, fused_pose, cfg, slam4)
    launches18, tracked18 = _phase_long("cuda", fused_match, fused_pose)
    launches19 = _phase_lowtex("cuda", fused_match, fused_pose)
    _phase_profiles("cuda")
    # Launches: every path summed; per tracked frame: the paths that track
    # every frame (phases 4, 6, 10-14, 16 runs 1 and 2, 17 and 18).
    tracked_paths = ((launches, tracked), (launches3, tracked3), (launches10, tracked10),
                     (launches11, tracked11), (launches12, tracked12),
                     (launches13, tracked13), (launches14, tracked14),
                     (launches16, tracked16), (launches17, tracked17),
                     (launches18, tracked18))
    on_frames = {k: sum(l[k] for l, _ in tracked_paths) for k in launches}
    n_tracked = sum(n for _, n in tracked_paths)
    print(json.dumps({"kernels": _kernel_entries(
        k1, k2, lm, {k: on_frames[k] + launches8[k] + launches15[k] + launches19[k]
                 for k in launches},
        {k: v / n_tracked for k, v in on_frames.items()})}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        sys.exit(measure(sys.argv[2]))
    if len(sys.argv) != 1:
        raise SystemExit(__doc__)
    sys.exit(main())
