"""System checkpoint + resume (port of ``pslam_tpu/io/checkpoint.py``).

The reference never implemented this (System.h:117-119: ``SaveMap/LoadMap``
are TODO comments). The whole struct-of-arrays map, the BoW database and
vocabulary, the tracker bookkeeping and the loop closer's state go to one
compressed ``.npz`` under the JAX package's keys (``map.*``, ``mapscalar.*``,
``sys.*``, ``db.*``, ``vocab.*``, ``lc.*``), so a checkpoint written by either
package loads into the other. Loading one written by the JAX package is how
its whole state is carried into the port.
"""

from __future__ import annotations

import json

import numpy as np

from pslam_tpu_torch.interop import map_state_from_arrays
from pslam_tpu_torch.ops.bow import vocabulary_from_arrays
from pslam_tpu_torch.pipeline.system import SlamSystem, TrackState
from pslam_tpu_torch.utils.config import SlamConfig


def _map_arrays(m) -> dict:
    out = {}
    for name, val in vars(m).items():
        if name == "cfg":
            continue
        if isinstance(val, np.ndarray):
            out[f"map.{name}"] = val
        elif isinstance(val, (int, np.integer)):
            out[f"mapscalar.{name}"] = np.int64(val)
    return out


def save_checkpoint(system: SlamSystem, path: str):
    """Write a SlamSystem (map + BoW database + vocabulary + tracker state +
    loop edges) to ``path`` (.npz)."""
    system.flush()  # commit in-flight BA + device accumulators first
    arrs = _map_arrays(system.map)
    arrs["sys.velocity"] = system.velocity
    meta = {
        "frame_id": int(system.frame_id),
        "ref_kf": int(system.ref_kf),
        "state": system.state.name,
        "stats": {k: int(v) for k, v in system.stats.items()},
    }
    arrs["sys.meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if system.trajectory:
        arrs["sys.traj_ts"] = np.asarray([t for t, _, _ in system.trajectory], np.float64)
        arrs["sys.traj_T"] = np.stack([T for _, T, _ in system.trajectory])
        arrs["sys.traj_ref"] = np.asarray([r for _, _, r in system.trajectory], np.int32)
    if system.kf_db is not None:
        db = system.kf_db
        for name in ("bow", "word", "node", "present"):
            arrs[f"db.{name}"] = getattr(db, name)
        for l, nd in enumerate(db.vocab.node_desc):
            arrs[f"vocab.level{l}"] = nd.cpu().numpy()
        arrs["vocab.idf"] = db.vocab.idf.cpu().numpy()
    if system.loop_closer is not None:
        lc = system.loop_closer
        arrs["lc.loop_edges"] = np.asarray(lc.loop_edges, np.int32).reshape(-1, 2)
        arrs["lc.last_loop_seq"] = np.int64(lc.last_loop_seq)
    np.savez_compressed(path, **arrs)


def load_checkpoint(path: str, cfg: SlamConfig | None = None, device="cuda") -> SlamSystem:
    """Rebuild a SlamSystem on ``device`` (the card unless asked for another)
    from a checkpoint. ``cfg`` must have the capacities the checkpoint was
    written with: a map array of another shape raises ``ValueError``.

    The last frame is not checkpointed, so a system saved while tracking
    resumes LOST and re-enters through relocalization against the restored
    map."""
    cfg = cfg or SlamConfig()
    with np.load(path, allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    levels = sorted(int(k.removeprefix("vocab.level")) for k in data if k.startswith("vocab.level"))
    vocab = None
    if levels:
        vocab = vocabulary_from_arrays([data[f"vocab.level{l}"] for l in levels],
                                       data["vocab.idf"], device)
    system = SlamSystem(cfg, device=device, vocab=vocab)
    fields = {k.removeprefix("map."): v for k, v in data.items() if k.startswith("map.")}
    fields.update({k.removeprefix("mapscalar."): int(v) for k, v in data.items()
                   if k.startswith("mapscalar.")})
    system.map = map_state_from_arrays(cfg, fields)

    meta = json.loads(bytes(data["sys.meta"]).decode())
    system.frame_id = meta["frame_id"]
    system.ref_kf = meta["ref_kf"]
    state = TrackState[meta["state"]]
    system.state = TrackState.LOST if state == TrackState.OK else state
    system.stats.update(meta["stats"])
    system.velocity = data["sys.velocity"].copy()
    if "sys.traj_ts" in data:
        system.trajectory = [
            (float(t), T.copy(), int(r))
            for t, T, r in zip(data["sys.traj_ts"], data["sys.traj_T"], data["sys.traj_ref"])
        ]
    if system.kf_db is not None and "db.bow" in data:
        for name in ("bow", "word", "node", "present"):
            setattr(system.kf_db, name, data[f"db.{name}"].copy())
    if system.loop_closer is not None and "lc.loop_edges" in data:
        system.loop_closer.loop_edges = [(int(a), int(b)) for a, b in data["lc.loop_edges"]]
        system.loop_closer.last_loop_seq = int(data["lc.last_loop_seq"])
    return system
