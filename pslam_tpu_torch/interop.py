"""Carry state across from the JAX package.

The system has no weights; what the two packages share is state: frames,
map-point snapshots, the host map and BA problems. These functions take the
JAX package's NamedTuples and ``MapState`` fields as numpy arrays (anything
with the same attribute names: ``np.asarray`` is applied to each field) and
build the port's counterparts on a given device, so both packages can
compute on the same map. Like ``SlamSystem``, every converter puts its
tensors on the card unless ``device`` asks for another. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.ops.bow import Vocabulary, vocabulary_from_arrays
from pslam_tpu_torch.ops.fans import LILFeatures
from pslam_tpu_torch.pipeline.frame_ops import FrameData, FrameLineData
from pslam_tpu_torch.pipeline.frame_step import LILSnap, LineSnap
from pslam_tpu_torch.pipeline.keyframe_db import KeyFrameDatabase
from pslam_tpu_torch.pipeline.track_ops import PointSet
from pslam_tpu_torch.solver.ba_lil import LILBAEdges
from pslam_tpu_torch.solver.lil import LILPoseObs
from pslam_tpu_torch.solver.local_ba import BAProblem

_INT_FIELDS = {"level": torch.int32, "free_slot": torch.int64,
               "cam_idx": torch.int64, "pt_idx": torch.int64,
               "lil_idx": torch.int64, "line_idx": torch.int32}


def _tensor(name, value, device):
    a = np.asarray(value)
    if a.dtype == np.bool_ or a.dtype == np.uint8:
        return torch.from_numpy(a.copy()).to(device)
    if name in _INT_FIELDS:
        return torch.from_numpy(a.astype(np.int64)).to(_INT_FIELDS[name]).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _convert(cls, obj, device):
    return cls(**{f: _tensor(f, getattr(obj, f), device) for f in cls._fields})


def frame_lines_from_numpy(fl, device="cuda") -> FrameLineData:
    """A ``FrameLineData`` (its ``lil`` a ``LILFeatures``) -> the port's
    FrameLineData on ``device``."""
    fields = {f: _tensor(f, getattr(fl, f), device)
              for f in FrameLineData._fields if f != "lil"}
    return FrameLineData(lil=_convert(LILFeatures, fl.lil, device), **fields)


def line_snap_from_numpy(ls, device="cuda") -> LineSnap:
    return _convert(LineSnap, ls, device)


def lil_snap_from_numpy(qs, device="cuda") -> LILSnap:
    return _convert(LILSnap, qs, device)


def lil_ba_edges_from_numpy(edges, device="cuda") -> LILBAEdges:
    return _convert(LILBAEdges, edges, device)


def lil_pose_obs_from_numpy(obs, device="cuda") -> LILPoseObs:
    return _convert(LILPoseObs, obs, device)


def point_set_from_numpy(pts, device="cuda") -> PointSet:
    """A ``PointSet`` (pos, desc, level, angle, min_dist, max_dist, normal,
    valid) -> the port's PointSet on ``device``."""
    return _convert(PointSet, pts, device)


def frame_from_numpy(fd, device="cuda") -> FrameData:
    """A ``FrameData`` (uv, ur, depth, xyz_c, level, angle, desc, valid) ->
    the port's FrameData on ``device``."""
    return _convert(FrameData, fd, device)


def ba_problem_from_numpy(prob, device="cuda") -> BAProblem:
    """A ``BAProblem`` -> the port's BAProblem on ``device``."""
    return _convert(BAProblem, prob, device)


def map_state_from_arrays(cfg, src) -> MapState:
    """A new host ``MapState`` for ``cfg`` whose fields are copied from
    ``src`` (an object or a dict holding the JAX ``MapState``'s fields as
    arrays or numbers, a checkpoint's ``map.*`` entries among them). Fields
    the port does not keep are ignored; an array whose shape is not the one
    ``cfg``'s capacities give raises ``ValueError``."""
    get = src.get if isinstance(src, dict) else lambda k: getattr(src, k, None)
    m = MapState(cfg)
    for name, cur in vars(m).items():
        if name == "cfg":
            continue
        val = get(name)
        if val is None:
            continue
        if isinstance(cur, np.ndarray):
            if np.shape(val) != cur.shape:
                raise ValueError(f"map field {name}: shape {np.shape(val)} != the "
                                 f"config's capacity {cur.shape}")
            setattr(m, name, np.array(val, dtype=cur.dtype, copy=True))
        else:
            setattr(m, name, type(cur)(val))
    return m


def vocabulary_from_numpy(vocab, device="cuda") -> Vocabulary:
    """A BoW ``Vocabulary`` (its ``node_desc`` levels and ``idf``) -> the
    port's Vocabulary on ``device``."""
    return vocabulary_from_arrays([np.asarray(d) for d in vocab.node_desc],
                                  np.asarray(vocab.idf), device)


def keyframe_db_from_numpy(db, vocab: Vocabulary) -> KeyFrameDatabase:
    """A new ``KeyFrameDatabase`` over the port's ``vocab`` holding copies of
    ``db``'s rows (``bow``, ``word``, ``node``, ``present``)."""
    out = KeyFrameDatabase(vocab, db.bow.shape[0], db.word.shape[1])
    for name in ("bow", "word", "node", "present"):
        setattr(out, name, np.array(getattr(db, name), dtype=getattr(out, name).dtype, copy=True))
    return out
