"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line of evidence; any failure ends the run with a
non-zero exit and no result line):

0. identity: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
1. build: both CUDA kernels compiled from ``pslam_tpu_torch/csrc`` by nvcc.
2. K1 (fused projection matcher) against its plain PyTorch version on the
   card at the main-path shape (4096 map points x 1000 features) and at
   (200, 300): every output exactly equal; median times over 20 runs.
3. K2 (fused pose terms) against its plain version at E = 4096.
4. the slice: ``SlamSystem(SlamConfig(use_lines=False, use_bow=False,
   use_loop_closing=False), device="cuda")`` at 640x480 with default
   capacities over 60 synthetic frames; every frame tracked, >= 3 keyframes,
   >= 1 local BA, ATE < 5 cm, and the launch counters prove that every
   tracked frame went through both kernels.
5. the same slice, small (320x240, 8 frames), on the card and on the CPU:
   the same tracking states and keyframes, camera centres within 2 cm.
6. the structural-line slice: ``SlamSystem(SlamConfig(use_bow=False,
   use_loop_closing=False), device="cuda")`` (BASELINE config 3: lines,
   LILs, the LIL composite error in the pose solve and the joint point + LIL
   local BA) at 640x480 with default capacities and line settings over 60
   frames; every frame tracked, >= 3 keyframes, >= 1 local BA with LIL
   edges, map lines, LIL landmarks with one re-observed, ATE < 5 cm, and
   every tracked frame through both kernels.
7. the structural-line slice, small (320x240, 8 frames, 8 px line tiles),
   twice on the card and once on the CPU: the two card runs bit-identical
   (poses and every map array), card vs CPU the same states and keyframes
   with camera centres within 2 cm.

The kernels' launch counters are set to 0 just before each main path
(phases 4 and 6) and read just after. The line before the last is a JSON
object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch


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


def _device_ms(fn, runs: int = 20):
    """Device time per call (ms) from torch.profiler: the summed duration of
    the CUDA kernels and copies ``fn`` enqueues, without the host-side gaps
    that the event-timed ``_median_ms`` includes. None when the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / runs / 1e3 if us > 0 else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def _phase_k1(fused_match, dev):
    from pslam_tpu_torch.ops.match import BIG, accept_matches

    result = None
    for na, nb, seed in ((4096, 1000, 0), (200, 300, 1)):
        c = [torch.from_numpy(x).to(dev) for x in _match_case(na, nb, seed)]
        desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius = c
        a_par, b_par = fused_match.pack_params(
            uv_a, radius, lev_a - 1, lev_a + 1, val_a, uv_b, lev_b, val_b
        )
        got = fused_match.fused_projection_match(desc_a, a_par, desc_b, b_par)
        ref = fused_match.fused_projection_match_plain(desc_a, a_par, desc_b, b_par)
        torch.cuda.synchronize()
        got = [g.cpu().numpy() for g in got]
        ref = [r.cpu().numpy() for r in ref]
        for k, name in enumerate(("best", "second", "best_j", "col_min")):
            if not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"K1 {name} differs at ({na}, {nb}): "
                                     f"{int((got[k] != ref[k]).sum())} entries")
        has = ref[3] < BIG
        if not np.array_equal(got[4][has], ref[4][has]):
            raise AssertionError(f"K1 col_argmin differs at ({na}, {nb})")
        idx_k = accept_matches(*(torch.from_numpy(x).long() for x in
                                 (got[0], got[1], got[2], got[4])), 100, 0.9).numpy()
        idx_p = accept_matches(*(torch.from_numpy(x).long() for x in
                                 (ref[0], ref[1], ref[2], ref[4])), 100, 0.9).numpy()
        if not np.array_equal(idx_k, idx_p) or (idx_k >= 0).sum() == 0:
            raise AssertionError(f"K1 final matches differ at ({na}, {nb})")
        err = max(int(np.abs(got[k].astype(np.int64) - ref[k]).max()) for k in range(4))
        def kernel():
            return fused_match.fused_projection_match(desc_a, a_par, desc_b, b_par)

        def plain():
            return fused_match.fused_projection_match_plain(desc_a, a_par, desc_b, b_par)

        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        print(f"[2 K1] ({na}, {nb}): outputs exactly equal, {(idx_k >= 0).sum()} matches, "
              f"row ties {int(((got[0] == got[1]) & (got[0] < BIG)).sum())}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20 calls); "
              f"device time kernel {_fmt_ms(_device_ms(kernel))}, "
              f"plain {_fmt_ms(_device_ms(plain))} per call")
        if result is None:
            result = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms)
    return result


def _phase_k2(fused_pose, dev):
    from pslam_tpu_torch.geometry import Camera, se3_exp
    from pslam_tpu_torch.solver.pose_opt import PoseObs

    rng = np.random.default_rng(0)
    E = 4096
    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (E, 3)).astype(np.float32)
    xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)].astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).numpy()
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx + rng.normal(0, 2, E)
    v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy + rng.normal(0, 2, E)
    ur = u - cam.bf / Xc[:, 2] + rng.normal(0, 1, E)
    ur[rng.uniform(size=E) < 0.3] = -1.0
    obs = np.stack([u, v, ur], axis=1).astype(np.float32)
    po = PoseObs(X_w=torch.from_numpy(X).to(dev), obs=torch.from_numpy(obs).to(dev),
                 inv_sigma2=torch.from_numpy(rng.uniform(0.3, 1.0, E).astype(np.float32)).to(dev),
                 valid=torch.from_numpy(rng.uniform(size=E) > 0.15).to(dev))
    data = fused_pose.pack_pose_data(po).contiguous()
    data[7] *= torch.from_numpy((rng.uniform(size=E) > 0.1).astype(np.float32)).to(dev)
    worst = 0.0
    for use_huber in (True, False):
        par = fused_pose.pack_pose_params(
            torch.from_numpy(T).to(dev), fused_pose.pose_param_tail(cam, use_huber, dev))
        got = [g.cpu().numpy() for g in fused_pose.pose_terms(data, par)]
        ref = [r.cpu().numpy() for r in fused_pose.pose_terms_plain(data, par)]
        checks = (
            ("H", got[0], ref[0], dict(rtol=2e-4, atol=1e-3)),
            ("b", got[1], ref[1], dict(rtol=2e-4, atol=1e-2)),
            ("cost", got[2], ref[2], dict(rtol=1e-5, atol=0)),
            ("chi2", got[3], ref[3], dict(rtol=1e-4, atol=1e-4)),
        )
        rel = {}
        for name, g, r, tol in checks:
            np.testing.assert_allclose(g, r, err_msg=f"K2 {name} (huber={use_huber})", **tol)
            worst = max(worst, float(np.abs(np.asarray(g, np.float64) - r).max()))
            rel[name] = float(np.abs(np.asarray(g, np.float64) - r).max()
                              / max(float(np.abs(r).max()), 1e-30))
        print(f"[3 K2] E={E} huber={use_huber}: within tolerance; max relative "
              f"error H {rel['H']:.2e} b {rel['b']:.2e} cost {rel['cost']:.2e} "
              f"chi2 {rel['chi2']:.2e}")
    def kernel():
        return fused_pose.pose_terms(data, par)

    def plain():
        return fused_pose.pose_terms_plain(data, par)

    ms, plain_ms = _median_ms(kernel), _median_ms(plain)
    print(f"[3 K2] E={E}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20 "
          f"calls); device time kernel {_fmt_ms(_device_ms(kernel))}, plain "
          f"{_fmt_ms(_device_ms(plain))} per call")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def _run_slice(cfg, device, n_frames, poses=None):
    """Track ``n_frames`` of the synthetic arc; every frame must end OK."""
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=n_frames,
                                              poses=poses, seed=0)
    slam = SlamSystem(cfg, device=device)
    ms, is_kf, states, centres = [], [], [], []
    for i in range(len(grays)):
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
    ate = ate_rmse(trajectory_positions(slam.poses), trajectory_positions(poses_gt))
    return slam, np.asarray(ms), np.asarray(is_kf), states, np.asarray(centres), ate


def _drive_main_path(name, cfg, n_frames, fused_match, fused_pose):
    """One main path on the card with the launch counters read around it."""
    fused_match.LAUNCHES = 0
    fused_pose.LAUNCHES = 0
    run = _run_slice(cfg, "cuda", n_frames)
    launches = {"fused_match": fused_match.LAUNCHES, "fused_pose": fused_pose.LAUNCHES}
    slam, ms, is_kf, _, _, ate = run
    tracked = n_frames - 1  # frame 0 initializes the map
    n_kf = int(slam.map.kf_valid.sum())
    print(f"[{name}] 640x480, {n_frames} frames on the card: all OK; keyframes "
          f"{n_kf} (inserted {slam.stats['kf_inserted']}), local BAs "
          f"{slam.stats['ba_runs']}, ATE {ate * 100:.3f} cm; median "
          f"{np.median(ms[5:]):.2f} ms/frame (frames 5+), keyframe frames mean "
          f"{ms[is_kf][1:].mean():.2f} ms, first frame {ms[0]:.1f} ms; "
          f"launches {launches} ({launches['fused_match'] / tracked:.2f} and "
          f"{launches['fused_pose'] / tracked:.2f} per tracked frame)")
    if n_kf < 3 or slam.stats["ba_runs"] < 1 or not ate < 0.05:
        raise AssertionError(f"{name}: too few keyframes or local BAs, or ATE >= 5 cm")
    if launches["fused_match"] < 2 * tracked or launches["fused_pose"] < 98 * tracked:
        raise AssertionError(f"{name} did not run through both kernels: {launches}")
    return slam, launches


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


def main():
    _identity()
    dev = torch.device("cuda", 0)
    import pslam_tpu_torch  # noqa: F401  (turns TF32 off)
    from pslam_tpu_torch.ops import _build, fused_match, fused_pose
    from pslam_tpu_torch.utils.config import Capacities, SlamConfig
    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.ops.orb import OrbConfig

    t0 = time.perf_counter()
    for name in ("fused_match", "fused_pose"):
        _build.library(name)
    for name in ("fused_match", "fused_pose"):
        secs, log = _build.BUILD_INFO[name]
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[1 build] {name}: nvcc {secs:.1f} s; " + " | ".join(regs[:4]))
    print(f"[1 build] both kernels ready in {time.perf_counter() - t0:.1f} s")

    k1 = _phase_k1(fused_match, dev)
    k2 = _phase_k2(fused_pose, dev)

    cfg = SlamConfig(use_lines=False, use_bow=False, use_loop_closing=False)
    _, launches = _drive_main_path("4 slice", cfg, 60, fused_match, fused_pose)

    small_cam = Camera(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                       width=320, height=240)
    small = SlamConfig(camera=small_cam, orb=OrbConfig(n_features=500),
                       caps=Capacities(local_points=1024), use_lines=False,
                       use_bow=False, use_loop_closing=False)
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

    cfg3 = SlamConfig(use_bow=False, use_loop_closing=False)
    slam3, launches3 = _drive_main_path("6 lines", cfg3, 60, fused_match, fused_pose)
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

    from pslam_tpu_torch.ops.lines import LineConfig

    _phase_repeat(dataclasses.replace(small, use_lines=True, use_lils=True,
                                      lines=LineConfig(tile=8)))
    launches = {k: launches[k] + launches3[k] for k in launches}

    kernels = [
        dict(name="fused_match", route="cuda", source="pslam_tpu_torch/csrc/fused_match.cu",
             replaces="pslam_tpu/ops/pallas_match.py:40", launches=launches["fused_match"],
             **k1),
        dict(name="fused_pose", route="cuda", source="pslam_tpu_torch/csrc/fused_pose.cu",
             replaces="pslam_tpu/ops/pallas_pose.py:36", launches=launches["fused_pose"],
             **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
