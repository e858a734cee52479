"""The evaluation run shared by the long-run and ladder apps (``run_long``,
``ate_ladder``, ``lowtex``): runs a ``SlamConfig`` over rendered frames and
returns one row of accuracy, map and time figures.

The row has the JAX package's script rows (``scripts/run_long.py``,
``run_ate_ladder.py``, ``run_lowtex.py``): the ATE of the final trajectory
(each row chained to its corrected reference keyframe, ``_abs_pose``) and
of the online output (each row chained as it was committed, before later
corrections; in a synchronous run the poses ``track_rgbd`` returned), keyframes inserted, culled and evicted,
loops closed, relocalizations and resets. Beside them it has the port's own
measures: median ms a frame over frames 5 and later, mean ms of the frames
that inserted a keyframe, the wall ms of each frame that handled a loop,
peak device memory, and the K1 and K2 launches per tracked frame. Times are
host-clock wall times; on the card a synchronous run synchronizes after
every frame, a pipelined one only at the end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pslam_tpu_torch.ops import fused_match, fused_pose
from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
from pslam_tpu_torch.utils.config import SlamConfig
from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions


def require_device(device: str) -> torch.device:
    """The device to run on; a CUDA device without CUDA raises, as
    ``SlamSystem`` does, before any frame is rendered."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the apps run on the CUDA device by default, and CUDA is not "
            "available here; pass --device cpu to run on the CPU"
        )
    return dev


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate(cfg: SlamConfig, grays, depths, poses_gt, *, device: str = "cuda",
             pipelined: bool = False, name: str = "", progress=None) -> dict:
    """Track every frame through ``track_rgbd`` (or ``track_rgbd_pipelined``
    and ``finish()``) and return the row. ``progress(i, slam, secs)`` is
    called after frame ``i``."""
    dev = require_device(device)
    slam = SlamSystem(cfg, device=device)
    step = slam.track_rgbd_pipelined if pipelined else slam.track_rgbd
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k1, k2 = fused_match.LAUNCHES, fused_pose.LAUNCHES
    n = len(grays)
    ms = np.zeros(n)
    is_kf = np.zeros(n, bool)
    loop_ms = []
    online = []
    tracked = 0
    _sync(dev)
    t_start = time.perf_counter()

    def new_rows():
        # Each frame's pose as it was committed: its trajectory row chained
        # to its reference keyframe before any later correction.
        online.extend(slam._abs_pose(T_rel, ref)
                      for _, T_rel, ref in slam.trajectory[len(online):])

    for i in range(n):
        tracked += slam.state == TrackState.OK
        n_kf = slam.stats["kf_inserted"]
        lc = slam.loop_closer
        loops = (lc, lc.stats["closed"]) if lc is not None else None
        t0 = time.perf_counter()
        step(grays[i], depths[i], i / 30.0)
        if not pipelined:
            _sync(dev)
        ms[i] = (time.perf_counter() - t0) * 1e3
        new_rows()
        is_kf[i] = slam.stats["kf_inserted"] > n_kf
        if loops is not None and slam.loop_closer is loops[0] \
                and slam.loop_closer.stats["closed"] > loops[1]:
            loop_ms.append(float(ms[i]))
        if progress is not None:
            progress(i, slam, time.perf_counter() - t_start)
    slam.finish()
    new_rows()  # the pipelined frame that finish() completes
    _sync(dev)
    secs = time.perf_counter() - t_start
    launches = (fused_match.LAUNCHES - k1, fused_pose.LAUNCHES - k2)

    gt = trajectory_positions(np.asarray(poses_gt))
    fixed = np.stack([slam._abs_pose(T_rel, ref) for _, T_rel, ref in slam.trajectory])
    est = trajectory_positions(fixed)
    st = slam.stats
    lc = slam.loop_closer.stats if slam.loop_closer is not None else {}
    kf_ms = ms[is_kf][1:]  # frame 0 initializes the map
    return dict(
        name=name,
        device=str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        pipelined=pipelined,
        n_frames=n,
        ate_cm=ate_rmse(est, gt[: len(est)]) * 100,
        online_cm=ate_rmse(trajectory_positions(np.stack(online)), gt[: len(online)]) * 100,
        kf_inserted=int(st.get("kf_inserted", 0)),
        kf_culled=int(st.get("kf_culled", 0)),
        kf_evicted=int(st.get("kf_evicted", 0)),
        kf_live=int(slam.map.kf_valid.sum()),
        kf_slots=int(slam.map.n_kf),
        loops=int(lc.get("closed", 0)),
        relocs=int(st.get("relocs", 0)),
        resets=int(st.get("resets", 0)),
        map_points=int(slam.map.mp_valid.sum()),
        map_lines=int(slam.map.ml_valid.sum()),
        lils=int(slam.map.il_valid.sum()),
        secs=secs,
        median_ms=float(np.median(ms[5:])) if n > 5 else None,
        kf_ms=float(kf_ms.mean()) if len(kf_ms) else None,
        loop_ms=loop_ms,
        peak_mib=(torch.cuda.max_memory_allocated(dev) / 2**20
                  if dev.type == "cuda" else None),
        tracked=tracked,
        k1_per_frame=launches[0] / max(tracked, 1),
        k2_per_frame=launches[1] / max(tracked, 1),
    )
