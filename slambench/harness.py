"""One run of one cell of ``BENCHMARK.json``.

Set-up (``setup_s``, from the process's start): import torch and the port,
load K1 and K2 (built into ``build/pslam_tpu_torch/`` inside the checkout
on a first run), render one pass of the traffic's sequence on the card and
hold it in host memory as decoded frames, build ``SlamSystem`` from the
configuration file and track the traffic's ``warm_frames`` on it.

A traffic that names ``resume_frames`` N resumes a saved session instead:
the system is loaded with ``load_checkpoint`` from
``build/slambench/resume-<key>.npz``, which the first run in a checkout
writes after tracking stream frames 0..N-1 (``resume_key`` hashes what the
saved map depends on), and the warm-up tracks from stream frame N on.
Before that, a throwaway copy of the session runs the loop closer's two
steps once (``warm_loop_path``), so that what they load on first use falls
in set-up and not in the window's loop frame. In a cell that reports
``loop_stall_ms`` the window also watches the loop closer.

Window: the same stream goes on through the configuration's drive as a
closed loop until ``--seconds`` have passed; then one synchronize. The
harness adds no other synchronize. The drive (``slam.drive``) is how the
client calls the system:

- ``track_rgbd`` (where the key is absent): each frame is handed over when
  the previous pose has returned; a frame's latency is its call;
- ``track_rgbd_pipelined``: depth 1, frame i+1 handed over when the call
  that took frame i returns (with the pose of frame i-1). ``Pipelined``
  learns which frames a call finished from ``SlamSystem._commit_frame``,
  wrapped on this system alone, and a frame's latency runs from the start
  of the call that took it to the end of the call that committed it. The
  warm-up ends with ``finish()``, so the window opens with nothing in
  flight; after the window's synchronize, ``finish()`` (untimed) commits
  the frame left in flight for the comparison.

``--trace 1`` wraps the spans the cell's per-layer readers name, times them
over the window, then profiles ``TRACE_FRAMES`` more frames of the stream
(pipelined cells: then ``finish()``) for the device metrics.

After the window: the peak device memory is read, the map is flushed, the
comparison decides ``correct`` (``check.py``), the program's state is
freed, and the run fails if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pslam_tpu")
TRACE_FRAMES = 6
RENDER_BATCH = 16
RESUME_DIR = ROOT / "build" / "slambench"
# The benchmark's own files that make the frames a saved session was built from.
FRAME_FILES = ("harness.py", "scene.py", "traffic.py")
# How a client can call the system (``slam.drive``); the first is the default.
DRIVES = ("track_rgbd", "track_rgbd_pipelined")


class NoResult(Exception):
    """The run cannot give a result (exit code 2, nothing on stdout)."""


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``pslam_tpu_torch`` is not ``pslam_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_cell(workload: str):
    """(cell, configuration file, traffic file, end-to-end metrics, per-layer
    metrics) of ``workload``, each found by its name."""
    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        raise NoResult(f"{spec_path} not found")
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    per_layer = [m for m in spec["per_layer"] if applies(m)]
    return cell, cfg, traffic, e2e, per_layer


def layer_reader(name: str):
    """The reader module of per-layer metric ``name``:
    ``slambench/layers/<name>.py``."""
    path = BENCH / "layers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_layer_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_of(cfg: dict) -> str:
    """The configuration's drive (``slam.drive``, by default ``track_rgbd``);
    another value gives no result."""
    drive = cfg["slam"].get("drive", DRIVES[0])
    if drive not in DRIVES:
        raise NoResult(f"unknown drive {drive!r}: one of {', '.join(DRIVES)}")
    return drive


def slam_config(cfg: dict):
    """The configuration file's ``slam`` block, less its ``drive``, as a
    ``SlamConfig``: each group replaces the defaults' fields of the same
    name; an unknown key raises."""
    from pslam_tpu_torch.utils.config import SlamConfig

    base = SlamConfig()
    s = dict(cfg["slam"])
    s.pop("drive", None)
    groups = {g: dataclasses.replace(getattr(base, g), **s.pop(g))
              for g in ("camera", "orb", "lines", "caps", "tracking", "plane_assoc") if g in s}
    return dataclasses.replace(base, **groups, **s)


def render_pass(cfg: dict, traffic: dict, seed: int, device):
    """One pass of the sequence as decoded frames in host memory:
    (grays, depths) lists of (H, W) float32 arrays."""
    import torch

    from slambench import scene
    from slambench.traffic import path_poses

    cam = cfg["slam"]["camera"]
    room = scene.Room.from_seed(seed, device=device, **traffic["room"])
    dist = tuple(cam[k] for k in ("k1", "k2", "p1", "p2", "k3"))
    rays = scene.camera_rays((cam["fx"], cam["fy"], cam["cx"], cam["cy"]), cam["width"],
                             cam["height"], dist, device)
    poses = torch.from_numpy(path_poses(traffic))
    grays, depths = [], []
    for i in range(0, len(poses), RENDER_BATCH):
        g, z = scene.render(room, rays, poses[i:i + RENDER_BATCH].to(device))
        g, z = scene.sensor_frames(g, z, float(cfg["sensor"]["depth_map_factor"]))
        grays.extend(g.cpu().numpy())
        depths.extend(z.cpu().numpy())
    return grays, depths


def resume_key(cfg: dict, traffic: dict, seed: int, port: Path | None = None) -> str:
    """Hash of what a saved session depends on: every file of the port
    (``port``, by default ``pslam_tpu_torch/`` beside the benchmark), the
    benchmark's files that make the frames, the configuration, the traffic
    and the seed."""
    port = port or ROOT / "pslam_tpu_torch"
    named = [(f"port/{f.relative_to(port)}", f) for f in sorted(port.rglob("*"))
             if f.is_file() and "__pycache__" not in f.parts]
    named += [(f"slambench/{name}", BENCH / name) for name in FRAME_FILES]
    h = hashlib.sha256()
    for name, f in named:
        h.update(name.encode() + b"\0" + f.read_bytes())
    h.update(json.dumps([cfg, traffic, int(seed)], sort_keys=True).encode())
    return h.hexdigest()[:24]


def build_resume(cfg: dict, grays, depths, seq, fps: float, n: int, device, path: Path) -> int:
    """Track stream frames 0..n-1 on a new ``SlamSystem`` and save it to
    ``path`` (written under another name, then renamed, so that a run cut
    short leaves no half file). Returns the frames it left not OK."""
    from pslam_tpu_torch.io.checkpoint import save_checkpoint
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState

    slam = SlamSystem(slam_config(cfg), device=device)
    lost = 0
    for i in range(n):
        k = seq(i)
        slam.track_rgbd(grays[k], depths[k], i / fps)
        lost += slam.state != TrackState.OK
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.stem + ".part.npz")
    save_checkpoint(slam, str(part))
    os.replace(part, path)
    return lost


def warm_loop_path(cfg: dict, path: Path, device, tries: int = 5) -> bool:
    """Run the loop closer's ``compute_sim3`` and ``correct_loop`` once on a
    throwaway copy of the saved session at ``path``, with its newest keyframe
    and a strongly covisible one standing in for a loop. On the card the
    first ``compute_sim3`` that reaches its RANSAC in a process took ~6.7 s
    more than later ones (8.4-10.1 s loop frames in new processes against
    2.6-2.8 s in a warm one, one H100): without this the window's loop frame
    would time that. Returns whether a correction ran."""
    from pslam_tpu_torch.io.checkpoint import load_checkpoint

    slam = load_checkpoint(str(path), slam_config(cfg), device)
    lc, m = slam.loop_closer, slam.map
    if lc is None:
        return False
    kfs = np.flatnonzero(m.kf_valid[: m.n_kf])
    kf = int(kfs[np.argmax(m.kf_frame_id[kfs])])
    for cand in m.best_covisible(kf, tries):
        out = lc.compute_sim3(kf, [int(cand)])
        if out is not None:
            loop_kf, Scw, mp_ids, proj_idx, _ = out
            lc.correct_loop(kf, loop_kf, Scw, mp_ids, proj_idx)
            return True
    return False


def _map_arrays(m) -> dict:
    keys = ("kf_valid", "kf_pose", "kf_frame_id", "kf_uv", "kf_level", "kf_desc", "kf_feat_depth",
            "kf_feat_mp",
            "kf_feat_valid", "mp_valid", "mp_pos")
    return {k: getattr(m, k)[: m.n_kf] if k.startswith("kf_") else getattr(m, k) for k in keys}


def _counters(slam) -> dict:
    c = {k: int(v) for k, v in slam.stats.items()}
    if slam.loop_closer is not None:
        st = slam.loop_closer.stats
        c["loops_closed"] = int(st.get("closed", 0))
        for k in ("detected", "gba_runs", "fuse_only"):
            c[f"loop_{k}"] = int(st.get(k, 0))
    return c


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Pipelined:
    """The client of a ``track_rgbd_pipelined`` cell. ``call`` hands a frame
    over and returns what the call committed; which frames those are comes
    from ``SlamSystem._commit_frame``, wrapped on ``slam`` alone, each
    committed ``frame_id`` mapped to its stream index through the
    ``slam.frame_id`` recorded at its hand-over. ``is_ok(slam)`` reads the
    state just after a commit."""

    def __init__(self, slam, is_ok, clock=time.perf_counter):
        self.slam, self.clock = slam, clock
        self.handed = {}  # frame id -> (stream index, start of the call that took it)
        self._done = []
        commit = slam._commit_frame

        def wrapped(hf):
            commit(hf)
            self._done.append((hf.frame_id, np.array(hf.T_cw, np.float64), is_ok(slam)))

        slam._commit_frame = wrapped

    def call(self, i: int, gray, depth, timestamp: float):
        """Hand stream frame ``i`` over. Returns (end of the call,
        [(stream index, pose, OK, latency s)] of the frames it committed)."""
        a = self.clock()
        self.handed[self.slam.frame_id] = (i, a)
        self.slam.track_rgbd_pipelined(gray, depth, timestamp)
        b = self.clock()
        return b, self._collect(b)

    def finish(self):
        """``finish()``: commit the frame in flight; returns as ``call``."""
        self.slam.finish()
        return self._collect(self.clock())

    def _collect(self, b: float):
        out = []
        for fid, T, ok in self._done:
            i, a = self.handed.pop(fid)
            out.append((i, T, ok, b - a))
        self._done.clear()
        return out


class LayerRun:
    """What a per-layer reader reads: the spans, the device trace of the
    profiled frames, and the program's counters over the window."""

    def __init__(self, spans, trace, counters):
        self.spans, self.trace, self.counters = spans, trace, counters

    def counter(self, key: str) -> int:
        return int(self.counters.get(key, 0))


def run(workload: str, seed: int, seconds: float, trace: bool, *, process_age=None,
        control: bool = False, device: str = "cuda", config_override: dict | None = None,
        traffic_override: dict | None = None, resume_dir: Path | None = None) -> dict:
    """One run; returns the result object (``checks`` last). With
    ``control`` the control's readings are judged in the program's place and
    decide ``correct``; the program's verdict goes on an earlier line. The
    tests pass the CPU, small stand-ins for the cell's files and a directory
    for saved sessions."""
    t_start = time.perf_counter()
    age0 = process_age() if process_age is not None else 0.0
    cell, cfg, traffic, e2e, per_layer = resolve_cell(workload)
    if config_override is not None:
        cfg = config_override
    if traffic_override is not None:
        traffic = traffic_override
    drive = drive_of(cfg)
    pipelined = drive == "track_rgbd_pipelined"

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoResult("CUDA is not available")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                           f"{cell['chips']}")
    import pslam_tpu_torch  # noqa: F401  (TF32 off, package-wide)
    from pslam_tpu_torch.ops import _build, fused_match, fused_pose
    from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState

    from slambench import check, stats
    from slambench.trace import Spans, device_trace
    from slambench.traffic import replay_index

    parts = {"imports": time.perf_counter() - t_start}
    dev = torch.device(device)
    if dev.type == "cuda":
        for name in ("fused_match", "fused_pose"):
            _build.library(name)
    parts["kernels"] = time.perf_counter() - t_start - sum(parts.values())
    grays, depths = render_pass(cfg, traffic, seed, dev)
    parts["render"] = time.perf_counter() - t_start - sum(parts.values())
    n_pass = len(grays)
    fps = float(cfg["sensor"]["fps"])

    def seq(i: int) -> int:
        return replay_index(traffic, n_pass, i)

    start = int(traffic.get("resume_frames", 0))
    resume = None
    if start:
        resume = (resume_dir or RESUME_DIR) / f"resume-{resume_key(cfg, traffic, seed)}.npz"
        resume_info = {"frames": start, "built": not resume.exists(), "lost": None}
        if resume_info["built"]:
            resume_info["lost"] = build_resume(cfg, grays, depths, seq, fps, start, device,
                                               resume)
            gc.collect()
        parts["resume_build"] = time.perf_counter() - t_start - sum(parts.values())
        resume_info["loop_warmed"] = warm_loop_path(cfg, resume, device)
        gc.collect()
        parts["loop_warm"] = time.perf_counter() - t_start - sum(parts.values())

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    readers = {m["name"]: layer_reader(m["name"]) for m in per_layer} if trace else {}
    spans = Spans()
    if trace:
        seen = set()
        for r in readers.values():
            for target, name, *cap in r.SPANS:
                if (target, name) not in seen:
                    seen.add((target, name))
                    spans.install(target, name, cap[0] if cap else None)

    if resume is not None:
        from pslam_tpu_torch.io.checkpoint import load_checkpoint

        slam = load_checkpoint(str(resume), slam_config(cfg), device)
        parts["resume_load"] = time.perf_counter() - t_start - sum(parts.values())
    else:
        slam = SlamSystem(slam_config(cfg), device=device)
        parts["system"] = time.perf_counter() - t_start - sum(parts.values())
    first = start + int(traffic["warm_frames"])
    track = slam.track_rgbd_pipelined if pipelined else slam.track_rgbd
    for i in range(start, first):
        k = seq(i)
        track(grays[k], depths[k], i / fps)
    if pipelined:
        slam.finish()
        pipe = Pipelined(slam, lambda s: s.state == TrackState.OK)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # The window. In a cell that reports loop_stall_ms, a frame in whose
    # track_rgbd call the loop closer accepted a loop is a loop frame.
    before = _counters(slam)
    lc = slam.loop_closer
    closed0 = lc.stats["closed"] if lc is not None else 0
    edges0 = set(lc.loop_edges) if lc is not None else set()
    watch = lc if any(m_["name"] == "loop_stall_ms" for m_ in e2e) else None
    closed, loop_frames = closed0, []
    launches0 = (fused_match.LAUNCHES, fused_pose.LAUNCHES)
    spans.timing = trace
    frames, latency = [], []
    i = first
    t0 = time.perf_counter()
    parts["warm"] = t0 - t_start - sum(parts.values())
    parts["before_main"] = age0
    setup_s = age0 + (t0 - t_start)
    if pipelined:
        while True:
            k = seq(i)
            b, done = pipe.call(i, grays[k], depths[k], i / fps)
            for j, T, ok, lat in done:
                frames.append((j, T, ok))
                latency.append(lat)
            i += 1
            if b - t0 >= seconds:
                break
    else:
        while True:
            k = seq(i)
            a = time.perf_counter()
            T = slam.track_rgbd(grays[k], depths[k], i / fps)
            b = time.perf_counter()
            latency.append(b - a)
            frames.append((i, np.array(T, np.float64), slam.state == TrackState.OK))
            if watch is not None and watch.stats["closed"] != closed:
                closed = watch.stats["closed"]
                loop_frames.append((i, b - a))
            i += 1
            if b - t0 >= seconds:
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    spans.timing = False
    counters = _delta(_counters(slam), before)
    launches = (fused_match.LAUNCHES - launches0[0], fused_pose.LAUNCHES - launches0[1])
    if pipelined:
        frames.extend(f[:3] for f in pipe.finish())

    dtrace = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        spans.capture = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for _ in range(TRACE_FRAMES):
                k = seq(i)
                if pipelined:
                    _, done = pipe.call(i, grays[k], depths[k], i / fps)
                    frames.extend(f[:3] for f in done)
                else:
                    T = slam.track_rgbd(grays[k], depths[k], i / fps)
                    frames.append((i, np.array(T, np.float64), slam.state == TrackState.OK))
                i += 1
            if pipelined:
                frames.extend(f[:3] for f in pipe.finish())
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            traced_s = time.perf_counter() - p0
        spans.capture = False
        dtrace = device_trace(prof, traced_s)
        del prof

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # End-to-end metrics (the window alone).
    n_win = len(latency)
    head_frames = int(traffic["head_frames"])
    e2e_values = {
        "setup_s": setup_s,
        "frames_per_s": stats.rate(n_win, window_s),
        "frame_ms_p90": stats.p90(latency) * 1e3,
        "loop_stall_ms": max((s for _, s in loop_frames), default=math.inf) * 1e3,
    }
    layer_values = {}
    if trace:
        lr = LayerRun(spans, dtrace, counters)
        for name, r in readers.items():
            v = r.read(lr)
            if v is not None:
                layer_values[name] = (float(v), next(m["unit"] for m in per_layer
                                                     if m["name"] == name))
    spans.remove()

    # The comparison, on what the window (and the traced frames) produced.
    slam.flush()
    m = _map_arrays(slam.map)
    loops = None
    if lc is not None and slam.loop_closer is lc:
        # Loops accepted from the first window frame to the end of the run.
        loops = {"closed": lc.stats["closed"] - closed0,
                 "edges": [e for e in lc.loop_edges if e not in edges0]}
    failed = sum(not ok for _, _, ok in frames[:n_win]) + max(0, head_frames - n_win)
    def image_of(i: int):
        return grays[seq(i)]

    values = check.readings(cfg, traffic, seed, frames, m, seq, first, image_of, loops=loops)
    correct, rows = check.judge(values, cfg["limits"])
    if control:
        # The reference computed in TF32 in the program's place, judged as
        # the program is: the precision numbers are the control's.
        print(json.dumps({"program": {"correct": correct, "checks": values}}))
        values = {**values,
                  **check.control_readings(cfg, traffic, seed, frames, m, seq, first, image_of)}
        correct, rows = check.judge(values, cfg["limits"])
    del slam
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    print(json.dumps({"seed": seed, "drive": drive, "counters": counters, "window_frames": n_win,
                      "window_s": window_s, "traced_frames": TRACE_FRAMES if trace else 0,
                      "k1_per_frame": launches[0] / n_win, "k2_per_frame": launches[1] / n_win,
                      "frame_ms_median": float(np.median(latency)) * 1e3,
                      "frame_ms_max": float(np.max(latency)) * 1e3,
                      "memory_peak_mib": peak / 2**20, "first_pass_frames": n_pass,
                      "setup_parts_s": parts, "stream_frames": i,
                      "loop_frames": [[f, s * 1e3] for f, s in loop_frames],
                      **({"resume": resume_info} if resume is not None else {})}))
    if trace and dtrace is not None:
        print(json.dumps({"trace": {"activities": len(dtrace.activities),
                                    "unlinked": sum(a[3] is None for a in dtrace.activities),
                                    "ranges": {k: len(v) for k, v in dtrace.ranges.items()},
                                    "busy_s": dtrace.busy_s(), "window_s": dtrace.window_s}}))

    wanted = e2e if not trace else per_layer
    if trace:
        metrics = {m_["name"]: {"value": layer_values[m_["name"]][0], "unit": m_["unit"]}
                   for m_ in per_layer if m_["name"] in layer_values}
    else:
        metrics = {m_["name"]: {"value": finite(e2e_values[m_["name"]]), "unit": m_["unit"]}
                   for m_ in wanted}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_win, "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if trace and dtrace is not None:
        dev_info["busy_s"] = dtrace.busy_s()
        dev_info["window_s"] = dtrace.window_s
        order = ["pipeline", "system", "tracking", "pipeline.finish", "pipeline.wait", "mapping",
                 "local_ba", "local_ba_commit", "loop", "k1", "k2"]
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_gaps([s for s in order
                                                              if s in dtrace.ranges])}
    result["checks"] = {name: {"value": finite(v), "limit": lim} for name, v, lim, _ in rows}
    bad = forbidden_modules()
    if bad:
        raise NoResult(f"modules of JAX or the JAX package were loaded: {bad}")
    for name, v, lim, ok in rows:
        print(f"check {name} = {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    return result


def finite(x):
    """A number for the result line: JSON has no infinity."""
    return x if math.isfinite(x) else None
