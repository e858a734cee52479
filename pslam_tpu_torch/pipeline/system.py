"""System facade + tracking orchestration (port of
``pslam_tpu/pipeline/system.py``).

Replaces System (reference src/System.cc) and the Tracking state machine
(src/Tracking.cc): per-frame entry point, initialization, motion-model
tracking with the widened-window and reference-KF retries, keyframe policy,
the asynchronous backend (local BA, triangulation, fuse) and trajectory
bookkeeping.

Host/device split: the host keeps ``MapState`` (numpy) and makes control
decisions; each frame runs ``frame_step`` on ``self.device`` and reads back
one 24-float summary. Frame arrays are read back only at keyframe insertion.

The port covers the RGB-D (``track_rgbd``), stereo (``track_stereo``) and
monocular (``track_mono``, with two-view initialization) sensors; points
(BASELINE config 1, ``use_lines=False``), map lines (config 2,
``use_lils=False``) or structural lines and the LIL composite error
(config 3), each with or without BoW place recognition, relocalization and
loop closing with the Sim3 essential graph and global BA (config 4, the
default ``SlamConfig()``); localization-only mode with its visual-odometry
fallback; and depth-1 pipelined tracking (``track_rgbd_pipelined``). With
``distributed=True`` and a ``torch.distributed`` process group of more than
one rank, every rank runs the same pipeline and the local BA, global BA and
essential graph run edge-sharded (``parallel/``); with one rank, or no
process group, the plain solvers run, as the reference does on one device.
"""

from __future__ import annotations

import dataclasses
import enum
import logging

import numpy as np
import torch

from pslam_tpu_torch.geometry.lie import rotation_to_quaternion
from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.ops import fused_pose
from pslam_tpu_torch.ops.bow import Vocabulary, default_vocabulary
from pslam_tpu_torch.ops.fans import LILFeatures
from pslam_tpu_torch.ops.match import TH_LOW, hamming_matrix, mutual_nn_match, window_mask
from pslam_tpu_torch.pipeline import frame_step as fstep
from pslam_tpu_torch.pipeline import line_mapping, local_mapping
from pslam_tpu_torch.pipeline.frame_ops import (
    FrameData,
    FrameLineData,
    make_frame,
    make_frame_lines,
    make_frame_stereo,
)
from pslam_tpu_torch.pipeline.keyframe_db import KeyFrameDatabase
from pslam_tpu_torch.pipeline.loop_closing import LoopCloser
from pslam_tpu_torch.pipeline.relocalization import relocalize
from pslam_tpu_torch.parallel.sharded_ba import solver_ranks
from pslam_tpu_torch.pipeline.track_ops import (
    PointSet,
    track_against_points_unwindowed,
    track_frame_to_frame,
    track_frame_to_frame_unwindowed,
)
from pslam_tpu_torch.solver import local_ba
from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
from pslam_tpu_torch.solver.initializer import InitResult, initialize_two_view, two_view_draws
from pslam_tpu_torch.solver.local_ba import graphs_engage, local_bundle_adjustment
from pslam_tpu_torch.utils.config import SlamConfig
from pslam_tpu_torch.utils.trace import span


class TrackState(enum.Enum):
    # Mirrors Tracking::eTrackingState (Tracking.h:90-96).
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class HostFrame:
    """Host copy of a processed frame + its tracking results. On the tracking
    path only (frame_id, timestamp, T_cw) are set per frame; the feature
    arrays are read back at keyframe insertion."""

    frame_id: int
    timestamp: float
    T_cw: np.ndarray  # (4, 4)
    uv: np.ndarray | None = None
    ur: np.ndarray | None = None
    depth: np.ndarray | None = None
    xyz_c: np.ndarray | None = None
    level: np.ndarray | None = None
    angle: np.ndarray | None = None
    desc: np.ndarray | None = None
    valid: np.ndarray | None = None
    feat_mp: np.ndarray | None = None  # map point id per feature, -1 = none
    # Line features (present when cfg.use_lines).
    line_sp: np.ndarray | None = None
    line_ep: np.ndarray | None = None
    line_desc: np.ndarray | None = None
    line_valid: np.ndarray | None = None
    line_p3s: np.ndarray | None = None
    line_p3e: np.ndarray | None = None
    line_ok3d: np.ndarray | None = None
    line_ml: np.ndarray | None = None  # map-line id per line slot, -1 none
    lil: LILFeatures | None = None  # host (numpy) copy of the frame's LILs
    lil_il: np.ndarray | None = None  # map-InsectLine id per LIL slot


def _np(t):
    return t.detach().cpu().numpy()


class SlamSystem:
    def __init__(self, cfg: SlamConfig | None = None, device="cuda",
                 vocab: Vocabulary | None = None):
        """Runs on the card unless ``device`` asks for another; raises
        ``RuntimeError`` for a CUDA device where CUDA is not available.
        ``vocab`` replaces the default BoW vocabulary (``use_bow``)."""
        self.cfg = cfg or SlamConfig()
        c = self.cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlamSystem runs on the CUDA device by default, and CUDA is not "
                "available here; pass device='cpu' to run on the CPU"
            )
        self.map = MapState(self.cfg)
        self.state = TrackState.NO_IMAGES_YET
        self.frame_id = 0
        self.velocity = np.eye(4, dtype=np.float32)
        self.last: HostFrame | None = None
        self.ref_kf = 0
        # Trajectory rows are (ts, T_rel, ref_kf): the frame pose RELATIVE to
        # its reference keyframe (mlRelativeFramePoses, Tracking.cc:534-551),
        # chained against the current KF pose at save time. ref_kf == -1
        # marks a row frozen to an absolute pose (pre-reset history).
        self.trajectory: list[tuple[float, np.ndarray, int]] = []
        self.stats = {"ba_runs": 0, "culled": 0, "kf_inserted": 0}
        # Device-resident tracking snapshot + accumulators (frame_step.py),
        # the (id, generation) identity of the snapshot, and the in-flight
        # backend work committed at the next keyframe event.
        self._snap = None
        self._acc = None
        self._snap_pt_ids = np.zeros(0, np.int64)
        self._snap_ml_ids = np.zeros(0, np.int64)
        self._snap_il_ids = np.zeros(0, np.int64)
        self._snap_pt_gen = np.zeros(0, np.int64)
        self._snap_ml_gen = np.zeros(0, np.int64)
        self._snap_il_gen = np.zeros(0, np.int64)
        self._pending_ba = None
        self._pending_backend = None
        self._snap_epoch = 0
        # The next pipelined dispatch starts from the host state when the
        # snapshot was rebuilt, and the depth-1 pipelined frame in flight.
        self._fresh_acc = False
        self._inflight = None
        # Localization-only mode (System::ActivateLocalizationMode,
        # System.cc:270-283): backend frozen, tracking against the frozen
        # map; _vo_mode mirrors mbVO (Tracking.cc:304-411), and _vo_prev
        # holds the previous frame's device FrameData + pose for the
        # frame-to-frame fallback.
        self.localization_only = False
        self._vo_mode = False
        self._vo_prev = None
        # Monocular initialization reference frame (Tracking.cc:673-686).
        self._mono_ref: HostFrame | None = None
        # Place recognition database (System.cc:61-82) and the loop closer
        # (LoopClosing, shipped disabled in the reference, on in config 4).
        self.kf_db = None
        self.loop_closer = None
        if c.use_bow:
            if vocab is None:
                vocab = default_vocabulary(k=c.bow_k, levels=c.bow_levels, device=self.device)
            vocab = Vocabulary(tuple(d.to(self.device) for d in vocab.node_desc),
                               vocab.idf.to(self.device))
            self.kf_db = KeyFrameDatabase(vocab, c.caps.max_keyframes, c.orb.capacity)
            if c.use_loop_closing:
                self.loop_closer = LoopCloser(self)

    # ------------------------------------------------------------------

    def _count(self, key: str, n: int):
        self.stats[key] = self.stats.get(key, 0) + n

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        """Process one RGB-D frame; returns the (4, 4) world->cam pose
        (System::TrackRGBD, System.cc:169)."""
        with span("frame", frame=self.frame_id):
            return self._track_rgbd(gray, depth, timestamp)

    def _track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        if self._inflight is not None:
            self._drain_pipeline()
        with span("frame.upload"):
            gray_d = self._tensor(gray)
            depth_d = self._tensor(depth)

        if self.state == TrackState.OK:
            hf = self._track_fused(gray_d, depth_d, timestamp)
        else:
            fd = self._make_frame(gray_d, depth_d)
            hf = self._to_host(fd, timestamp)
            if self.cfg.use_lines:
                fl = make_frame_lines(gray_d, depth_d, self.cfg.camera, self.cfg.lines,
                                      self.cfg.caps.frame_lils)
                self._lines_to_host(hf, fl)
            if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
                self._initialize(hf)
                self._invalidate_snapshot(fold=False)
            elif (not self.localization_only
                  and self.map.n_kf <= self.cfg.tracking.reset_if_lost_with_kfs):
                # LOST on a tiny map: hard reset (Tracking.cc:518-526;
                # System::Reset, System.cc:294) and initialize again; never
                # in localization-only mode.
                self.reset()
                self._initialize(hf)
                self._invalidate_snapshot(fold=False)
            elif relocalize(self, hf, fd):
                # LOST: relocalization (Tracking.cc:327), else keep the last
                # pose and stay LOST.
                self.state = TrackState.OK
                self.velocity = np.eye(4, dtype=np.float32)
                self._invalidate_snapshot()
            elif self.last is not None:
                hf.T_cw = self.last.T_cw.copy()

        self.frame_id += 1
        self._commit_frame(hf)
        return hf.T_cw

    def _commit_frame(self, hf: HostFrame):
        """Trajectory bookkeeping for a finished frame (Tracking.cc:534-551)."""
        self.last = hf
        if self.state == TrackState.OK and self.map.n_kf > 0:
            T_rel = hf.T_cw @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
            self.trajectory.append(
                (hf.timestamp, T_rel.astype(np.float32), int(self.ref_kf))
            )
        else:
            self.trajectory.append((hf.timestamp, hf.T_cw.copy(), -1))

    def _make_frame(self, gray_d, depth_d) -> FrameData:
        """Sensor-dispatched frame construction (``depth_d`` carries the
        right image in stereo mode)."""
        if self.cfg.sensor == "stereo":
            return make_frame_stereo(gray_d, depth_d, self.cfg.camera, self.cfg.orb)
        return make_frame(gray_d, depth_d, self.cfg.camera, self.cfg.orb)

    # ------------------------------------------------------------------
    # Stereo (System::TrackStereo, Tracking::GrabImageStereo,
    # Tracking.cc:174-213)

    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray, timestamp: float):
        """Process one rectified stereo pair; returns the (4, 4) pose. The
        RGB-D pipeline downstream of the frame constructor; per-feature
        depth comes from the stereo matcher (ops/stereo.py). Requires
        ``cfg.sensor == "stereo"``."""
        if self.cfg.sensor != "stereo":
            raise ValueError("track_stereo needs SlamConfig(sensor='stereo')")
        return self.track_rgbd(gray_l, gray_r, timestamp)

    # ------------------------------------------------------------------
    # Monocular (System::TrackMonocular, Tracking.cc:245-272)

    def track_mono(self, gray: np.ndarray, timestamp: float):
        """Monocular tracking: H/F two-view initialization
        (Tracking::MonocularInitialization, Tracking.cc:659-757) creating a
        median-depth-normalized map, then the tracking path with mono
        (ur < 0) observations. New landmarks come from epipolar
        triangulation only; relocalization takes the uv-only PnP branch.
        Returns the (4, 4) pose."""
        if self.state in (TrackState.OK, TrackState.LOST):
            return self.track_rgbd(gray, np.zeros_like(np.asarray(gray), np.float32), timestamp)
        gray_d = self._tensor(gray)
        fd = make_frame(gray_d, torch.zeros_like(gray_d), self.cfg.camera, self.cfg.orb)
        hf = self._to_host(fd, timestamp)
        ref = self._mono_ref
        if ref is None or not self._try_mono_init(ref, hf):
            # The newest frame becomes the initialization reference (the
            # reference resets mInitialFrame each failed attempt,
            # Tracking.cc:673-686).
            self._mono_ref = hf
            self.state = TrackState.NOT_INITIALIZED
        else:
            self._mono_ref = None
            self.state = TrackState.OK
            self._invalidate_snapshot(fold=False)
        self.frame_id += 1
        self._commit_frame(hf)
        return hf.T_cw

    def _try_mono_init(self, ref: HostFrame, hf: HostFrame) -> bool:
        """Two-view initialization between the reference frame and this one;
        on success builds the two-keyframe map (CreateInitialMapMonocular,
        Tracking.cc:759-884)."""
        cam = self.cfg.camera

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # 100-px window + ratio 0.9 (SearchForInitialization,
        # ORBmatcher.cc:364).
        idx, _ = mutual_nn_match(
            hamming_matrix(t(ref.desc), t(hf.desc)), valid_a=t(ref.valid),
            valid_b=t(hf.valid), max_dist=TH_LOW, ratio=0.9,
            extra_mask=window_mask(t(ref.uv), t(hf.uv), 100.0),
        )
        idx = _np(idx)
        m = idx >= 0
        if m.sum() < 100:  # Tracking.cc:699 (nmatches < 100 -> retry)
            return False
        uv2 = np.zeros_like(ref.uv)
        uv2[m] = hf.uv[idx[m]]
        valid = t(m)
        h_idx, f_idx = two_view_draws(hf.frame_id, valid)
        res = InitResult(*(_np(a) for a in initialize_two_view(
            t(ref.uv), t(uv2), valid, h_idx, f_idx, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        )))
        if not bool(res.ok) or int(res.n_good) < 80:
            return False

        good = res.triangulated & m
        # Scale gauge: median scene depth -> 1 (Tracking.cc:828-840).
        med = float(np.median(res.X1[good][:, 2]))
        if med <= 1e-6:
            return False
        X1 = (res.X1 / med).astype(np.float32)
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = res.R21
        T1[:3, 3] = res.t21 / med

        m_ = self.map
        ref.T_cw = T0
        hf.T_cw = T1
        kf0 = m_.add_keyframe(
            ref.frame_id, ref.timestamp, T0, ref.uv, ref.ur, ref.level, ref.angle,
            ref.desc, ref.valid, ref.depth, np.full_like(ref.feat_mp, -1),
        )
        kf1 = m_.add_keyframe(
            hf.frame_id, hf.timestamp, T1, hf.uv, hf.ur, hf.level, hf.angle,
            hf.desc, hf.valid, hf.depth, np.full_like(hf.feat_mp, -1),
        )
        sel0 = np.flatnonzero(good)
        ids = m_.create_points_from_depth(kf0, sel0, X1[sel0])
        m_.add_point_obs(kf1, idx[sel0], ids)
        ref.feat_mp[sel0] = ids
        hf.feat_mp[idx[sel0]] = ids
        m_._update_covisibility(kf0)
        m_._update_covisibility(kf1)
        m_.update_point_stats(ids)
        self._register_kf_bow(kf0, ref)
        self._register_kf_bow(kf1, hf)
        self.ref_kf = kf1
        self.velocity = np.eye(4, dtype=np.float32)
        self.stats["kf_inserted"] += 2
        return True

    # ------------------------------------------------------------------
    # Depth-1 pipelined tracking

    def track_rgbd_pipelined(self, gray, depth, timestamp: float):
        """Pipelined ``track_rgbd``: enqueues this frame's step chained off
        the previous frame's device-resident pose and velocity (no host read
        on the way), then finishes the previous frame. Returns the previous
        frame's (4, 4) pose, or None on the priming call. Call ``finish()``
        after the last frame."""
        if self.state != TrackState.OK:
            self._drain_pipeline()
            self.track_rgbd(gray, depth, timestamp)
            return self.last.T_cw if self.last is not None else None
        gray_d = self._tensor(gray)
        depth_d = self._tensor(depth)
        if self._snap is None:
            self._rebuild_snapshot()
        prev = self._inflight
        if prev is None or self._fresh_acc or prev["epoch"] != self._snap_epoch:
            # Chain off committed host state (fresh pipeline / new snapshot).
            T_in = (self._tensor(self.last.T_cw) if prev is None else prev["out"].T_cw)
            v_in = self._tensor(self.velocity)
            acc_in = self._acc
            self._fresh_acc = False
        else:
            T_in, v_in, acc_in = prev["out"].T_cw, prev["out"].vel, prev["out"].acc
        self._count("track_frames", 1)
        self._count("track_steps", 1)
        lm_steps = fused_pose.LM_LAUNCHES
        out = fstep.frame_step(
            self.cfg, gray_d, depth_d, T_in, v_in,
            self.cfg.tracking.motion_match_radius, self._snap, acc_in,
        )
        # LM step kernels launched by this frame's pose solves (0 on the CPU).
        self._count("pose_lm_steps", fused_pose.LM_LAUNCHES - lm_steps)
        self._inflight = {
            "out": out,
            "summary": self._start_read(out.summary),
            "gray_d": gray_d,
            "depth_d": depth_d,
            "ts": float(timestamp),
            "fid": self.frame_id,
            "epoch": self._snap_epoch,
            "snap_ids": self._snap_id_pack(),
        }
        self.frame_id += 1
        if prev is None:
            return None
        return self._finish_pipelined(prev)

    @staticmethod
    def _start_read(t):
        """Start reading ``t`` back without waiting for work queued after it:
        on CUDA an asynchronous copy into pinned host memory and an event
        recorded behind it; on the CPU the tensor itself. Pass the result to
        ``_end_read``."""
        if t.device.type != "cuda":
            return t, None
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    @staticmethod
    def _end_read(pending) -> np.ndarray:
        buf, done = pending
        if done is not None:
            done.synchronize()
        return _np(buf)

    def _finish_pipelined(self, item) -> np.ndarray:
        lm_steps = fused_pose.LM_LAUNCHES
        hf = self._finish_frame(
            item["out"], item["gray_d"], item["depth_d"], item["ts"], item["fid"],
            item["epoch"], item["snap_ids"], summary=self._end_read(item["summary"]),
        )
        # The LM steps of the retries and fallback (0 on the CPU).
        self._count("pose_lm_steps", fused_pose.LM_LAUNCHES - lm_steps)
        self._commit_frame(hf)
        return hf.T_cw

    def _drain_pipeline(self):
        item = self._inflight
        self._inflight = None
        if item is not None:
            self._finish_pipelined(item)

    def finish(self):
        """Flush the pipelined tracker: finish the frame in flight (if any)
        and commit pending device work."""
        self._drain_pipeline()
        self.flush()

    def _to_host(self, fd: FrameData, timestamp) -> HostFrame:
        return HostFrame(
            frame_id=self.frame_id,
            timestamp=float(timestamp),
            T_cw=np.eye(4, dtype=np.float32),
            uv=_np(fd.uv), ur=_np(fd.ur), depth=_np(fd.depth),
            xyz_c=_np(fd.xyz_c), level=_np(fd.level), angle=_np(fd.angle),
            desc=_np(fd.desc), valid=_np(fd.valid),
            feat_mp=np.full(fd.uv.shape[0], -1, np.int32),
        )

    def _lines_to_host(self, hf: HostFrame, fl: FrameLineData):
        (hf.line_sp, hf.line_ep, hf.line_desc, hf.line_valid, hf.line_p3s,
         hf.line_p3e, hf.line_ok3d) = (
            _np(a) for a in (fl.sp, fl.ep, fl.desc, fl.valid, fl.p3s, fl.p3e, fl.ok3d)
        )
        hf.line_ml = np.full(len(hf.line_valid), -1, np.int32)
        hf.lil = LILFeatures(*(_np(a) for a in fl.lil))
        hf.lil_il = np.full(self.cfg.caps.frame_lils, -1, np.int32)

    def _initialize(self, hf: HostFrame):
        """StereoInitialization (Tracking.cc:555-657): need enough
        depth-valid features, create the first KF and its map points."""
        n_depth = int((hf.depth > 0).sum())
        # Reference gate is a fixed 500 with a 1000-feature budget
        # (Tracking.cc:560); scaled to the configured capacity.
        if n_depth < min(500, self.cfg.orb.capacity // 2):
            self.state = TrackState.NOT_INITIALIZED
            return
        hf.T_cw = np.eye(4, dtype=np.float32)
        kf = self.map.add_keyframe(
            hf.frame_id, hf.timestamp, hf.T_cw, hf.uv, hf.ur, hf.level, hf.angle,
            hf.desc, hf.valid, hf.depth, np.full_like(hf.feat_mp, -1),
        )
        self._register_kf_bow(kf, hf)
        sel = np.flatnonzero((hf.depth > 0) & hf.valid)
        X_w = hf.xyz_c[sel]  # identity pose: camera frame == world frame
        ids = self.map.create_points_from_depth(kf, sel, X_w)
        hf.feat_mp[sel] = ids
        if self.cfg.use_lines and hf.line_valid is not None:
            line_mapping.create_or_attach_lines(self.map, kf, hf, hf.T_cw)
            if self.cfg.use_lils:
                line_mapping.create_or_attach_lils(self.map, kf, hf, hf.T_cw)
        self.ref_kf = kf
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 1

    # ------------------------------------------------------------------

    def _frame_step(self, gray_d, depth_d, velocity, radius):
        self._count("track_steps", 1)
        return fstep.frame_step(
            self.cfg, gray_d, depth_d, self._tensor(self.last.T_cw),
            self._tensor(velocity), radius, self._snap, self._acc,
        )

    def _track_fused(self, gray_d, depth_d, timestamp: float) -> HostFrame:
        """The per-frame hot path: one frame_step on the device-resident
        snapshot + one 24-float read-back."""
        with span("track"):
            self._count("track_frames", 1)
            lm_steps = fused_pose.LM_LAUNCHES
            if self._snap is None:
                self._rebuild_snapshot()
            with span("track.step", attempt="motion"):
                out = self._frame_step(
                    gray_d, depth_d, self.velocity, self.cfg.tracking.motion_match_radius
                )
            hf = self._finish_frame(
                out, gray_d, depth_d, timestamp, self.frame_id, self._snap_epoch,
                self._snap_id_pack(),
            )
            # LM step kernels launched by this frame's pose solves (0 on the CPU).
            self._count("pose_lm_steps", fused_pose.LM_LAUNCHES - lm_steps)
            return hf

    def _finish_frame(self, out, gray_d, depth_d, timestamp: float, frame_id: int,
                      epoch: int, snap_ids, summary=None) -> HostFrame:
        """Consume one frame_step result: read the summary (unless given),
        retry with the widened window (Tracking.cc:1198-1203) and the
        un-windowed reference-KF search (TrackReferenceKeyFrame,
        Tracking.cc:880) when inliers are scarce, update the state machine,
        and run the keyframe policy. ``epoch`` is the snapshot generation the
        step ran against and ``snap_ids`` that generation's (id, gen) arrays:
        a frame from a superseded snapshot keeps its pose and can become a
        keyframe (its matches resolve through its own (id, gen) pairs), but
        its accumulators are dropped."""
        cfg_t = self.cfg.tracking
        if summary is None:
            with span("track.readback"):
                summary = _np(out.summary)
        # Retry gates: >= 30 TrackLocalMap inliers (Tracking.cc:1400-1406)
        # AND >= 20 motion-window matches (Tracking.cc:1198-1203).
        retry_th = max(cfg_t.min_local_inliers, cfg_t.min_track_inliers)

        def needs_retry(s):
            return (
                s[fstep.S_INLIERS] < retry_th
                or s[fstep.S_INLIERS_1] < cfg_t.min_motion_matches
            )

        if needs_retry(summary):
            self._count("track_retries", 1)
            with span("track.step", attempt="wide"):
                out2 = self._frame_step(
                    gray_d, depth_d, self.velocity, cfg_t.motion_match_radius_wide
                )
            with span("track.readback"):
                s2 = _np(out2.summary)
            if s2[fstep.S_INLIERS] > summary[fstep.S_INLIERS]:
                out, summary = out2, s2
                epoch, snap_ids = self._snap_epoch, self._snap_id_pack()
        if needs_retry(summary):
            self._count("track_fallbacks", 1)
            with span("track.fallback"):
                fb = self._fallback_ref_kf(gray_d, depth_d, out)
            if fb is not None and fb[1][fstep.S_INLIERS] > summary[fstep.S_INLIERS]:
                out, summary = fb
                epoch, snap_ids = self._snap_epoch, self._snap_id_pack()

        hf = HostFrame(
            frame_id=frame_id,
            timestamp=float(timestamp),
            T_cw=np.asarray(summary[fstep.S_T], np.float32).reshape(4, 4).copy(),
        )
        if epoch == self._snap_epoch:
            self._acc = out.acc
        n_inliers = int(summary[fstep.S_INLIERS])
        if n_inliers < cfg_t.min_track_inliers:
            if self.localization_only and self._finish_vo(hf, out, snap_ids):
                return hf
            self.state = TrackState.LOST
            self.velocity = np.eye(4, dtype=np.float32)
            self._vo_prev = None
            hf.T_cw = self.last.T_cw.copy()
            return hf

        self.state = TrackState.OK
        self.velocity = (hf.T_cw @ np.linalg.inv(self.last.T_cw)).astype(np.float32)
        if self.localization_only:
            # mbVO accounting (Tracking.cc:1280: mbVO = nmatchesMap < 10):
            # few map inliers while only tracking means the map has left
            # the view. Keyframe insertion and the backend stay frozen
            # (System.cc:270-283); the frame is kept for the VO fallback.
            self._vo_mode = n_inliers < 10
            self._vo_prev = (out.fd, hf.T_cw.copy())
        elif self._need_new_keyframe(hf, summary):
            with span("keyframe.readback"):
                self._materialize_host_frame(hf, out, snap_ids)
            with span("mapping"):
                self._create_keyframe(hf)
            with span("keyframe.snapshot"):
                self._rebuild_snapshot()
        return hf

    def _finish_vo(self, hf: HostFrame, out, snap_ids) -> bool:
        """The mbVO branch of localization-only tracking (Tracking.cc:304-411,
        1049-1162): when map inliers collapse, (a) try relocalization, which
        wins and clears VO mode (Tracking.cc:367-405); (b) else track
        frame-to-frame against the previous frame's depth-backed features,
        accepted at >= 20 inliers (Tracking.cc:1289). Returns True if the
        frame survives (state OK), False -> LOST."""
        cfg = self.cfg
        self._materialize_host_frame(hf, out, snap_ids)
        if relocalize(self, hf, out.fd):
            self.state = TrackState.OK
            self.velocity = np.eye(4, dtype=np.float32)
            self._vo_mode = False
            self._vo_prev = (out.fd, hf.T_cw.copy())
            self._count("relocs", 1)
            return True
        if self._vo_prev is None:
            return False
        prev_fd, prev_T = self._vo_prev
        T_pred = self._tensor(self.velocity @ self.last.T_cw)
        res = track_frame_to_frame(
            cfg.camera, T_pred, prev_fd, self._tensor(prev_T), out.fd,
            cfg.tracking.motion_match_radius_wide, cfg.orb.scale, cfg.orb.levels,
        )
        if int(res.n_inliers) < 20:
            # Fast pan: the image shift exceeded the wide window; match
            # descriptors with no projection window.
            res = track_frame_to_frame_unwindowed(
                cfg.camera, T_pred, prev_fd, self._tensor(prev_T), out.fd,
                cfg.orb.scale, cfg.orb.levels,
            )
        if int(res.n_inliers) < 20:
            return False
        hf.T_cw = _np(res.T_cw).astype(np.float32)
        self.state = TrackState.OK
        self.velocity = (hf.T_cw @ np.linalg.inv(self.last.T_cw)).astype(np.float32)
        self._vo_mode = True
        self._vo_prev = (out.fd, hf.T_cw.copy())
        self._count("vo_frames", 1)
        return True

    def _fallback_ref_kf(self, gray_d, depth_d, out):
        """Un-windowed descriptor matching against the reference KF's points
        (TrackReferenceKeyFrame / SearchByBoW, Tracking.cc:880), then the
        step again with the recovered pose as prior. Returns (out, summary)
        or None."""
        cfg = self.cfg
        ref_mp = self.map.kf_feat_mp[self.ref_kf]
        pts_ref = self._point_set(ref_mp[ref_mp >= 0], cap=cfg.orb.capacity)
        res = track_against_points_unwindowed(
            cfg.camera, self._tensor(self.last.T_cw), pts_ref, out.fd,
            cfg.orb.scale, cfg.orb.levels,
        )
        if int(res.n_inliers) < cfg.tracking.min_track_inliers:
            return None
        T_fb = _np(res.T_cw)
        vel_fb = (T_fb @ np.linalg.inv(self.last.T_cw)).astype(np.float32)
        with span("track.step", attempt="fallback"):
            out2 = self._frame_step(
                gray_d, depth_d, vel_fb, cfg.tracking.motion_match_radius
            )
        with span("track.readback"):
            return out2, _np(out2.summary)

    def _materialize_host_frame(self, hf: HostFrame, out, snap_ids):
        """Read back the frame's feature arrays + point, line and LIL
        associations (keyframe insertion only). ``snap_ids`` are the (id,
        gen) arrays of the snapshot the frame ran against (one generation
        behind in pipelined mode). Associations to landmarks culled since
        then are masked by validity, to slots culled AND recycled by the
        generation check."""
        m_ = self.map
        ids_s, ml_s, il_s, gen_s, ml_g, il_g = snap_ids
        fd = out.fd
        (hf.uv, hf.ur, hf.depth, hf.xyz_c, hf.level, hf.angle, hf.desc,
         hf.valid, mp, inl) = (
            _np(a) for a in (fd.uv, fd.ur, fd.depth, fd.xyz_c, fd.level,
                             fd.angle, fd.desc, fd.valid, out.match_point,
                             out.inlier)
        )
        hf.feat_mp = np.full(len(hf.valid), -1, np.int32)
        n = len(ids_s)
        good = (
            (mp[:n] >= 0) & inl[:n] & m_.mp_valid[ids_s] & (m_.mp_gen[ids_s] == gen_s)
        )
        hf.feat_mp[mp[:n][good]] = ids_s[good]
        if not (self.cfg.use_lines and out.fl is not None):
            return
        self._lines_to_host(hf, out.fl)
        lm, qm = _np(out.line_match), _np(out.lil_match)
        nl = len(ml_s)
        src = np.flatnonzero((lm[:nl] >= 0) & m_.ml_valid[ml_s] & (m_.ml_gen[ml_s] == ml_g))
        hf.line_ml[lm[:nl][src]] = ml_s[src]
        if self.cfg.use_lils:
            ok = (qm >= 0) & (qm < len(il_s))
            ok[ok] = m_.il_valid[il_s[qm[ok]]] & (m_.il_gen[il_s[qm[ok]]] == il_g[qm[ok]])
            hf.lil_il[ok] = il_s[qm[ok]]

    def _need_new_keyframe(self, hf: HostFrame, summary) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1410-1515), RGB-D branch, from the
        summary counts."""
        t = self.cfg.tracking
        frames_since_kf = hf.frame_id - int(self.map.kf_frame_id[self.map.last_kf])
        ref_tracked = int((self.map.kf_feat_mp[self.ref_kf] >= 0).sum())
        n_inliers = int(summary[fstep.S_INLIERS])
        tracked_close = int(summary[fstep.S_TRACKED_CLOSE])
        untracked_close = int(summary[fstep.S_UNTRACKED_CLOSE])
        need_close = (tracked_close < 100) and (untracked_close > 70)

        c1 = frames_since_kf >= t.kf_max_interval
        c2 = n_inliers < ref_tracked * t.kf_min_inlier_ratio or need_close
        c3 = n_inliers > 15
        return (c1 or c2) and c3 and frames_since_kf >= t.kf_min_interval

    # ------------------------------------------------------------------
    # Snapshot lifecycle

    def _rebuild_snapshot(self):
        """Upload a fresh tracker view of the map (keyframe events only)."""
        self._fold_acc()
        self._snap_epoch += 1
        self._fresh_acc = True
        cfg, m = self.cfg, self.map
        local_kfs = self._local_keyframes()
        pt_ids = m.local_map_points(local_kfs, cfg.caps.local_points)
        ml_ids = np.zeros(0, np.int64)
        il_ids = np.zeros(0, np.int64)
        if cfg.use_lines:
            ml_ids = line_mapping.local_map_lines(m, local_kfs, cfg.caps.local_lines)
            if cfg.use_lils:
                il_ids = np.flatnonzero(m.il_valid)[: cfg.caps.local_lils]
        self._snap = fstep.build_snapshot(m, cfg, pt_ids, self.device, ml_ids, il_ids)
        self._snap_pt_ids = np.asarray(pt_ids, np.int64)
        self._snap_ml_ids = np.asarray(ml_ids, np.int64)
        self._snap_il_ids = np.asarray(il_ids, np.int64)
        self._snap_pt_gen = m.mp_gen[self._snap_pt_ids].copy()
        self._snap_ml_gen = m.ml_gen[self._snap_ml_ids].copy()
        self._snap_il_gen = m.il_gen[self._snap_il_ids].copy()
        self._acc = fstep.make_acc(cfg, self.device)

    def _snap_id_pack(self):
        """The (ids, gens) identity of the current snapshot: what a frame
        that ran against it needs to resolve its matches later, even after
        the snapshot is superseded and slots are recycled."""
        return (
            self._snap_pt_ids, self._snap_ml_ids, self._snap_il_ids,
            self._snap_pt_gen, self._snap_ml_gen, self._snap_il_gen,
        )

    def _fold_acc(self):
        """Fold the device found/visible accumulators into the host map
        (before any landmark mutation, while the snapshot ids are live)."""
        if self._acc is None or self._snap is None:
            return
        m = self.map
        a = type(self._acc)(*(_np(x) for x in self._acc))
        # Gen guard: don't credit a slot recycled since the snapshot.
        n = len(self._snap_pt_ids)
        if n:
            ok = m.mp_gen[self._snap_pt_ids] == self._snap_pt_gen
            ids = self._snap_pt_ids[ok]
            np.add.at(m.mp_visible, ids, a.pt_vis[:n][ok])
            np.add.at(m.mp_found, ids, a.pt_found[:n][ok])
        nl = len(self._snap_ml_ids)
        if nl:
            ok = m.ml_gen[self._snap_ml_ids] == self._snap_ml_gen
            ids = self._snap_ml_ids[ok]
            np.add.at(m.ml_visible, ids, a.ml_vis[:nl][ok])
            np.add.at(m.ml_found, ids, a.ml_found[:nl][ok])
        nq = len(self._snap_il_ids)
        if nq:
            # AddFrameObservation (Map.cc:268 -> insectline.cc:39-43).
            ok = m.il_gen[self._snap_il_ids] == self._snap_il_gen
            np.add.at(m.il_frame_obs, self._snap_il_ids[ok], a.il_obs[:nq][ok])
        self._acc = None

    def _invalidate_snapshot(self, fold: bool = True):
        if fold:
            self._fold_acc()
        self._snap = None
        self._acc = None

    def _point_set(self, mp_ids, cap: int) -> PointSet:
        return fstep.build_point_set(
            self.map, np.asarray(mp_ids, np.int64), cap, self.device
        )

    def _local_keyframes(self):
        """Reference KF + best covisible neighbours (UpdateLocalKeyFrames,
        Tracking.cc:1905-2029, capped at 80)."""
        base = self.ref_kf
        covis = self.map.best_covisible(base, 79)
        return np.unique(np.concatenate([[base], covis]))

    def _create_keyframe(self, hf: HostFrame):
        """CreateNewKeyFrame (Tracking.cc:1516-1605): insert the KF, create
        new map points from depth for unmatched close features, run the
        backend."""
        # Commit the previous keyframe's in-flight local BA and backend
        # before touching the map (the tracker used the pre-BA snapshot).
        self._fold_acc()
        self._commit_pending_ba()
        self._commit_pending_backend()
        with span("mapping.insert"):
            self._evict_for_capacity()
            kf = self.map.add_keyframe(
                hf.frame_id, hf.timestamp, hf.T_cw, hf.uv, hf.ur, hf.level, hf.angle,
                hf.desc, hf.valid, hf.depth, hf.feat_mp,
            )
            self._register_kf_bow(kf, hf)
            self.ref_kf = kf
            self.stats["kf_inserted"] += 1

            # New points from depth: unmatched features sorted by depth, close
            # ones first, at least 100 (Tracking.cc:1545-1599).
            cand = np.flatnonzero((hf.feat_mp < 0) & (hf.depth > 0) & hf.valid)
            if len(cand):
                cand = cand[np.argsort(hf.depth[cand])]
                close = hf.depth[cand] < self.cfg.th_depth
                n_take = max(int(close.sum()), min(100, len(cand)))
                n_take = min(n_take, self.cfg.tracking.max_new_points_per_kf)
                sel = cand[:n_take]
                T_wc = np.linalg.inv(hf.T_cw)
                X_w = (hf.xyz_c[sel] @ T_wc[:3, :3].T) + T_wc[:3, 3]
                ids = self.map.create_points_from_depth(kf, sel, X_w.astype(np.float32))
                hf.feat_mp[sel] = ids

        # Lines & structural lines onto the new KF.
        use_lines = self.cfg.use_lines and hf.line_valid is not None
        if use_lines:
            with span("mapping.lines"):
                line_mapping.create_or_attach_lines(self.map, kf, hf, hf.T_cw)
                if self.cfg.use_lils:
                    line_mapping.create_or_attach_lils(self.map, kf, hf, hf.T_cw)
                    self._count("lils_culled",
                                line_mapping.cull_lils_by_quality(self.map, self.cfg))
                self.stats["culled"] += line_mapping.cull_lines(self.map, self.cfg)

        # Backend (LocalMapping::Run order, LocalMapping.cc:47-120): point
        # culling, epipolar triangulation, line triangulation, neighbour
        # fuse, local BA, keyframe culling. Point triangulation, point fuse
        # and BA are dispatched here and committed at the next keyframe
        # event; the line stages are host numpy and run inline.
        with span("mapping.cull"):
            self.stats["culled"] += local_mapping.cull_points(self.map, self.cfg)
        if use_lines:
            with span("mapping.lines"):
                self._count("lines_triangulated",
                            line_mapping.create_new_map_lines(self.map, kf, self.cfg))
                self._count("lines_fused",
                            line_mapping.fuse_lines_in_neighbors(self.map, kf, self.cfg))
                row = self.map.kf_line_ml[kf]
                self.map.update_line_stats(np.unique(row[row >= 0]))
        with span("backend.dispatch"):
            self._dispatch_backend(kf)
        row = self.map.kf_feat_mp[kf]
        self.map.update_point_stats(np.unique(row[row >= 0]))
        with span("local_ba.dispatch"):
            self._run_local_ba(kf)
        with span("mapping.cull"):
            self._cull_keyframes(kf)

        # Loop closing on the new KF (LoopClosing::Run polls its queue; here
        # it runs synchronously after the local BA).
        if self.loop_closer is not None:
            with span("loop"):
                self.loop_closer.on_new_keyframe(kf)

    def _loop_kfs(self) -> set:
        """KFs holding loop edges (never erased: the reference's mspLoopEdges
        check in KeyFrame::SetBadFlag)."""
        if self.loop_closer is None:
            return set()
        return {k for edge in self.loop_closer.loop_edges for k in edge}

    def _erase_keyframe(self, k: int):
        """Erase KF ``k`` with the bookkeeping the map can't do: re-target
        trajectory rows, drop it from the BoW database."""
        self._retarget_trajectory(k)
        if self.kf_db is not None:
            self.kf_db.erase(k)
        self.map.erase_keyframe(k)

    def _evict_for_capacity(self):
        """When the KF table is full and culling could not keep up, evict the
        most covisibility-redundant unprotected keyframe instead of failing.
        When every unprotected KF holds a loop edge, the most redundant one
        loses its loop edges and goes."""
        m = self.map
        if m.n_kf < m.kf_valid.shape[0] or (~m.kf_valid[: m.n_kf]).any():
            return
        hard_protect = {0, self.ref_kf, int(m.last_kf)}
        protect = hard_protect | self._loop_kfs()
        live = np.asarray([k for k in np.flatnonzero(m.kf_valid) if k not in protect])
        if len(live) == 0:
            live = np.asarray([k for k in np.flatnonzero(m.kf_valid) if k not in hard_protect])
            if len(live) == 0:
                return
            victim = int(live[np.argmax(m.covis[live, : m.n_kf].max(axis=1))])
            if self.loop_closer is not None:
                self.loop_closer.loop_edges = [
                    (a, b) for a, b in self.loop_closer.loop_edges if victim not in (a, b)
                ]
        else:
            victim = int(live[np.argmax(m.covis[live, : m.n_kf].max(axis=1))])
            logging.getLogger(__name__).warning(
                "keyframe capacity full: evicting most-redundant KF %d", victim
            )
        self._erase_keyframe(victim)
        self._count("kf_evicted", 1)

    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling, sparing the reference KF and loop-edge KFs."""
        victims = local_mapping.cull_keyframes(
            self.map, kf, self.cfg, protect={self.ref_kf} | self._loop_kfs()
        )
        for k in victims:
            self._erase_keyframe(k)
        self._count("kf_culled", len(victims))

    def _retarget_trajectory(self, k: int):
        """Re-reference trajectory rows pointing at KF ``k`` to its best
        covisible neighbour before the slot is erased (KeyFrame.cc:533-608)."""
        cov = self.map.best_covisible(k, 1)
        parent = int(cov[0]) if len(cov) else int(self.map.last_kf)
        if parent == k:
            parent = -1
        T_k = self.map.kf_pose[k]
        if parent >= 0:
            T_fix = (T_k @ np.linalg.inv(self.map.kf_pose[parent])).astype(np.float32)
        self.trajectory = [
            (ts, T_rel, ref)
            if ref != k
            else (
                (ts, (T_rel @ T_fix).astype(np.float32), parent)
                if parent >= 0
                else (ts, (T_rel @ T_k).astype(np.float32), -1)
            )
            for ts, T_rel, ref in self.trajectory
        ]

    def _run_local_ba(self, kf_idx: int):
        """Start the local BA on the device without waiting for it; the
        result is committed at the next keyframe event."""
        if self.map.n_kf < 3:
            return
        out = local_mapping.assemble_local_ba(self.map, kf_idx, self.cfg, self.device)
        if out is None:
            return
        prob, cam_ids, pt_ids, e_feat, n_e = out
        cfg = self.cfg
        # Host reads happen before the solve is queued, so they do not wait
        # for it.
        free_slot = _np(prob.free_slot)
        lil_pack = None
        if cfg.use_lines and cfg.use_lils:
            lil_pack = line_mapping.assemble_lil_edges(self.map, cam_ids, cfg, self.device)
        lil_opt = il_ids = None
        n_lil_edges = 0
        # caps.ba_edges and ba_points are powers of two, so the
        # fixed-capacity arrays divide by a power-of-two world size.
        ranks = solver_ranks(cfg)
        graphs = local_ba.BA_GRAPHS
        captures, replays = graphs.captures, graphs.replays
        if lil_pack is not None:
            lil_state, lil_valid, ledges, il_ids = lil_pack
            n_lil_edges = int(_np(ledges.valid).sum())
            T_opt, X_opt, lil_opt, in_p, _ = local_bundle_adjustment_lil(
                cfg.camera, prob, lil_state, lil_valid, ledges, cfg.caps.ba_free, ranks=ranks
            )
            result = (T_opt, X_opt, in_p)
        else:
            result = local_bundle_adjustment(cfg.camera, prob, cfg.caps.ba_free,
                                             ranks=ranks)[:3]
        if graphs_engage(prob.T_cw, ranks):
            self._count("ba_graph_captures", graphs.captures - captures)
            self._count("ba_graph_replays", graphs.replays - replays)
        self._pending_ba = {
            "result": result,
            "lil_opt": lil_opt,
            "il_ids": il_ids,
            "n_lil_edges": n_lil_edges,
            "cam_ids": cam_ids,
            "pt_ids": pt_ids,
            "e_feat": e_feat,
            "n_e": n_e,
            "free_slot": free_slot,
            "frame_id": int(self.map.kf_frame_id[kf_idx]),
        }

    def _commit_pending_ba(self):
        """Read back + write the in-flight local BA (if any)."""
        p = self._pending_ba
        if p is None:
            return
        self._pending_ba = None
        with span("local_ba.commit", cause=p["frame_id"]):
            if p["lil_opt"] is not None:
                # Write back LIL structures + refresh plane offsets (d = -mean
                # n.p; the rigid-translation update leaves n unchanged).
                m = self.map
                il_ids = p["il_ids"]
                sel = il_ids >= 0
                ids = il_ids[sel]
                alive = m.il_valid[ids]
                ids, st = ids[alive], _np(p["lil_opt"])[sel][alive]
                m.il_state[ids] = st
                n = m.il_plane[ids, :3]
                d = -np.einsum("qj,qpj->q", n, st.reshape(-1, 5, 3)) / 5.0
                flip = d < 0
                pl = np.concatenate([np.where(flip[:, None], -n, n), np.abs(d)[:, None]], axis=1)
                m.il_plane[ids] = pl.astype(np.float32)
                self._count("lil_ba_edges", p["n_lil_edges"])
            local_mapping.write_back_ba(
                self.map, tuple(_np(t) for t in p["result"]) + (None,), p["cam_ids"],
                p["pt_ids"], p["e_feat"], p["n_e"], p["free_slot"],
            )
            self.stats["ba_runs"] += 1

    def _dispatch_backend(self, kf: int):
        """Start the new KF's device backend (epipolar triangulation +
        neighbour fuse); committed at the next KF event."""
        self._pending_backend = {
            "tri": local_mapping.dispatch_triangulation(self.map, kf, self.cfg, self.device),
            "fuse": local_mapping.dispatch_fuse(self.map, kf, self.cfg, self.device),
            "frame_id": int(self.map.kf_frame_id[kf]),
        }

    def _commit_pending_backend(self):
        p = self._pending_backend
        if p is None:
            return
        self._pending_backend = None
        with span("backend.commit", cause=p["frame_id"]):
            if p["tri"] is not None:
                self._count("triangulated",
                            local_mapping.commit_triangulation(self.map, p["tri"], self.cfg))
            if p["fuse"] is not None:
                self._count("fused", local_mapping.commit_fuse(self.map, p["fuse"], self.cfg))

    def _interrupt_ba(self):
        """Discard the in-flight local BA and backend (InterruptBA /
        mbAbortBA, LocalMapping.cc:984-986): the loop closer calls this right
        before a correction rewrites the poses they were solved against."""
        self._pending_ba = None
        self._pending_backend = None

    def _register_kf_bow(self, kf: int, hf: HostFrame):
        """Compute and store the new KF's BoW (KeyFrame::ComputeBoW +
        KeyFrameDatabase::add)."""
        if self.kf_db is None:
            return
        self.kf_db.add(kf, *self.kf_db.compute_bow(hf.desc, hf.valid))

    # ------------------------------------------------------------------

    def reset(self):
        """System::Reset (System.cc:294) / Tracking::Reset (Tracking.cc:2195):
        clear the map, the BoW database and the loop closer; trajectory
        bookkeeping keeps accumulating."""
        self._interrupt_ba()
        self._inflight = None
        self._invalidate_snapshot(fold=False)
        # Freeze prior rows to absolute poses: their reference KFs are about
        # to be destroyed with the map.
        self.trajectory = [
            (ts, self._abs_pose(T_rel, ref), -1) for ts, T_rel, ref in self.trajectory
        ]
        self.map = MapState(self.cfg)
        if self.kf_db is not None:
            self.kf_db = KeyFrameDatabase(
                self.kf_db.vocab, self.cfg.caps.max_keyframes, self.cfg.orb.capacity
            )
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(self)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = 0
        self._count("resets", 1)

    def activate_localization_mode(self):
        """Freeze the backend and keep tracking against the current map
        (System::ActivateLocalizationMode, System.cc:270-276). The map, the
        BoW database and the loop closer stop changing; relocalization stays
        available."""
        self.flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode,
        System.cc:277-283)."""
        self.localization_only = False
        self._vo_mode = False
        self._vo_prev = None

    def flush(self):
        """Commit in-flight device work (local BA, backend, found/visible
        accumulators) into the host map. Call before reading map state."""
        self._fold_acc()
        self._commit_pending_ba()
        self._commit_pending_backend()
        if self._snap is not None and self._acc is None:
            self._acc = fstep.make_acc(self.cfg, self.device)

    def _abs_pose(self, T_rel: np.ndarray, ref_kf: int) -> np.ndarray:
        """Chain a relative row against the current reference-KF pose
        (System.cc:345-365)."""
        if ref_kf < 0:
            return T_rel
        return (T_rel @ self.map.kf_pose[ref_kf]).astype(np.float32)

    @staticmethod
    def _write_tum_row(f, ts: float, T_cw: np.ndarray):
        R = T_cw[:3, :3]
        t = T_cw[:3, 3]
        C = -R.T @ t
        q = rotation_to_quaternion(torch.as_tensor(np.ascontiguousarray(R.T))).numpy()
        f.write(
            f"{ts:.6f} {C[0]:.7f} {C[1]:.7f} {C[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
        )

    def save_trajectory_tum(self, path: str):
        """TUM-format trajectory (System::SaveTrajectoryTUM, System.cc:323)."""
        self.flush()
        with open(path, "w") as f:
            for ts, T_rel, ref in self.trajectory:
                self._write_tum_row(f, ts, self._abs_pose(T_rel, ref))

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM-format keyframe trajectory (SaveKeyFrameTrajectoryTUM,
        System.cc:384), in timestamp order (slot order is not temporal once
        culled slots are recycled)."""
        self.flush()
        m = self.map
        ks = np.flatnonzero(m.kf_valid[: m.n_kf])
        ks = ks[np.argsort(m.kf_timestamp[ks], kind="stable")]
        with open(path, "w") as f:
            for k in ks:
                self._write_tum_row(f, float(m.kf_timestamp[k]), m.kf_pose[k])

    def save_trajectory_kitti(self, path: str):
        """KITTI-format trajectory: row-major 3x4 of T_wc
        (System::SaveTrajectoryKITTI, System.cc:412-441)."""
        self.flush()
        with open(path, "w") as f:
            for ts, T_rel, ref in self.trajectory:
                T = self._abs_pose(T_rel, ref)
                R = T[:3, :3].T
                C = -R @ T[:3, 3]
                vals = np.c_[R, C].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    @property
    def poses(self):
        self.flush()
        return np.stack([self._abs_pose(T_rel, ref) for _, T_rel, ref in self.trajectory])
