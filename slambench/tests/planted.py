"""Faults planted in the port, each a way in which a cell's timed path can
go wrong; ``correct`` has to come out false under every one of them.

``plant`` patches the port's classes for the rest of the process, so it is
called in a process of its own (``drive.py``), from the first frame after
the warm-up on (``first``, the window's first stream frame):

- ``state_unchanged``: the tracking step returns the last pose and does
  nothing else (no keyframe is made); through ``track_rgbd_pipelined``,
  the call finishes the frame in flight and commits its own frame at once
  with the last pose;
- ``stale_pose``: the tracking step runs in full, keyframes included, but
  the pose it hands on is the last one, so the stream's poses and the
  window's keyframes stay where the warm-up left them; through
  ``track_rgbd_pipelined``, the summary that finishes a frame carries the
  last pose (the device chain runs on);
- ``half_left_out``: every second feature's depth reads 0;
- ``answer_altered``: every depth is read 0.1% long;
- ``loop_skipped``: the loop closer's ``on_new_keyframe`` does nothing and
  returns False, so no loop is accepted;
- ``loop_uncorrected``: ``correct_loop`` records the loop edge and the
  counts, but leaves poses and points as they were.
"""

from __future__ import annotations

import numpy as np

FAULTS = ("state_unchanged", "stale_pose", "half_left_out", "answer_altered", "loop_skipped",
          "loop_uncorrected")


def plant(fault: str, first: int) -> None:
    import torch

    from pslam_tpu_torch.pipeline import frame_ops, frame_step, loop_closing, system

    S = system.SlamSystem
    if fault == "state_unchanged":
        real_track = S._track_fused

        def track(self, gray_d, depth_d, timestamp):
            if self.frame_id < first:
                return real_track(self, gray_d, depth_d, timestamp)
            return system.HostFrame(frame_id=self.frame_id, timestamp=float(timestamp),
                                    T_cw=self.last.T_cw.copy())

        real_pipelined = S.track_rgbd_pipelined

        def pipelined(self, gray, depth, timestamp):
            if self.frame_id < first:
                return real_pipelined(self, gray, depth, timestamp)
            self._drain_pipeline()
            hf = system.HostFrame(frame_id=self.frame_id, timestamp=float(timestamp),
                                  T_cw=self.last.T_cw.copy())
            self.frame_id += 1
            self._commit_frame(hf)
            return hf.T_cw

        S._track_fused = track
        S.track_rgbd_pipelined = pipelined
    elif fault == "stale_pose":
        real_step = S._frame_step

        def step(self, *a):
            out = real_step(self, *a)
            if self.frame_id < first:
                return out
            summary = out.summary.clone()
            summary[frame_step.S_T] = torch.as_tensor(self.last.T_cw.reshape(16),
                                                      dtype=summary.dtype, device=summary.device)
            return out._replace(summary=summary)

        real_finish = S._finish_pipelined

        def finish(self, item):
            if item["fid"] < first:
                return real_finish(self, item)
            summary = torch.as_tensor(S._end_read(item["summary"])).clone()
            summary[frame_step.S_T] = torch.as_tensor(self.last.T_cw.reshape(16),
                                                      dtype=summary.dtype)
            return real_finish(self, {**item, "summary": (summary, None)})

        S._frame_step = step
        S._finish_pipelined = finish
    elif fault in ("half_left_out", "answer_altered"):
        real_gather = frame_ops.gather_pixels

        def gather(img, y, x):
            z = real_gather(img, y, x)
            if fault == "answer_altered":
                return z * (1 + 1e-3)
            keep = torch.as_tensor(np.arange(z.shape[0]) % 2 == 0, dtype=z.dtype, device=z.device)
            return z * keep

        frame_ops.gather_pixels = gather
    elif fault == "loop_skipped":
        real_on_kf = loop_closing.LoopCloser.on_new_keyframe

        def on_new_keyframe(self, kf):
            if self.sys.frame_id < first:
                return real_on_kf(self, kf)
            return False

        loop_closing.LoopCloser.on_new_keyframe = on_new_keyframe
    elif fault == "loop_uncorrected":
        real_correct = loop_closing.LoopCloser.correct_loop

        def correct_loop(self, kf, loop_kf, *a):
            if self.sys.frame_id < first:
                return real_correct(self, kf, loop_kf, *a)
            self.loop_edges.append((int(kf), int(loop_kf)))
            self.last_loop_seq = int(self.sys.map.kf_seq[kf])
            self.stats["closed"] += 1
            if self.sys.cfg.loop_gba:
                self.stats["gba_runs"] += 1

        loop_closing.LoopCloser.correct_loop = correct_loop
    else:
        raise ValueError(f"unknown fault {fault!r}")
