"""Distributed local/global BA over ``torch.distributed`` (port of
``pslam_tpu/parallel/sharded_ba.py``): edge-sharded assembly, point-sharded
Schur complement.

The JAX package shards over a ``jax.sharding.Mesh`` (``make_ba_mesh``). The
port is SPMD over a process group instead: every rank holds the same
replicated problem (every rank ran the same pipeline) and calls the same
function; ``group`` (default: the world group) takes the mesh's place, so
there is no ``make_ba_mesh``. With D ranks, rank r:

- takes its contiguous edge shard ``[r E/D, (r + 1) E/D)`` (the JAX
  version's ``P(axis)`` in_specs) and evaluates ``_edge_terms`` and
  ``_assemble`` on it alone;
- all-reduces the camera blocks Hcc, bc and the cost (one packed
  ``all_reduce``) and reduce-scatters the landmark blocks Hpp, bp and G over
  the point axis (one packed ``reduce_scatter``), so it owns P/D landmarks;
- builds its part of the reduced camera system from its landmarks, sums
  the parts (``all_reduce``), solves the reduced system replicated, and
  back-substitutes its landmarks; ``all_gather`` restores dx_p everywhere.

The solvers are the single-device ones (solver/local_ba.py, solver/ba_lil.py,
solver/sim3_graph.py): they take a ``ranks`` object, and ``Ranks`` of a
process group routes their shards and collectives through
``torch.distributed``; ``solver_ranks(cfg)`` picks the ranks for the
pipeline's call sites. The per-edge outputs (chi2, depth) are all-gathered,
so each function returns the single-device solver's values and shapes on
every rank. Edge and landmark lengths must divide by the world size
(``ValueError``). At world size 1 every collective is the identity and the
results are bit-identical to the single-device solvers'. Every sum is
fixed-order within a rank (the segment tables of solver/local_ba.py);
across ranks the collectives add the rank partials.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
from pslam_tpu_torch.solver.local_ba import ONE_DEVICE, BAProblem, local_bundle_adjustment


def world_size(group=None) -> int:
    """Ranks in ``group`` once ``torch.distributed`` is initialized, else 1."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


class Ranks:
    """The process group of one sharded solve: its size, this rank's index
    in it and the collectives, packed into as few calls as the algorithm
    allows. solver/local_ba.py's ``OneDevice`` is its one-device form."""

    def __init__(self, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("the sharded solvers need an initialized torch.distributed "
                               "process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def shard(self, n: int, what: str) -> slice:
        """This rank's contiguous share of an axis of length ``n``."""
        if n % self.size:
            raise ValueError(f"{what} length {n} does not divide by the world size "
                             f"{self.size}")
        c = n // self.size
        return slice(self.rank * c, (self.rank + 1) * c)

    def all_reduce(self, *ts):
        """Elementwise sums over the ranks of tensors of any shapes."""
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=self.group)
        return tuple(p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in ts]), ts))

    def reduce_scatter(self, *ts):
        """Sums over the ranks of (n, ...) tensors, each rank keeping its
        contiguous n/D rows."""
        flat = _rows(ts)
        out = flat.new_empty((flat.shape[0] // self.size, flat.shape[1]))
        dist.reduce_scatter(out, list(flat.chunk(self.size)), group=self.group)
        return _unrows(out, ts)

    def all_gather(self, *ts):
        """(n/D, ...) row shards of every rank, concatenated in rank order."""
        flat = _rows(ts)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat, group=self.group)
        return _unrows(torch.cat(parts), ts)


def _rows(ts):
    """Tensors of one leading length n -> one contiguous (n, k) block."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1).contiguous()


def _unrows(flat, like):
    widths = [t[0].numel() if t.dim() > 1 else 1 for t in like]
    return tuple(p.reshape((flat.shape[0],) + t.shape[1:])
                 for p, t in zip(flat.split(widths, dim=1), like))


def solver_ranks(cfg):
    """The ranks the pipeline's solvers run over: the world group when
    ``cfg.distributed`` and ``torch.distributed`` runs more than one rank,
    else one device (the JAX package's behaviour on one device)."""
    return Ranks() if cfg.distributed and world_size() > 1 else ONE_DEVICE


def sharded_local_bundle_adjustment(cam: Camera, prob: BAProblem, n_free: int,
                                    schedule=(5, 10), group=None):
    """Distributed drop-in for solver.local_bundle_adjustment: every rank of
    ``group`` calls it with the same problem. Edge AND point lengths must
    divide by the world size.

    Returns (T_opt, X_opt, edge_inlier, chi2), the same on every rank."""
    return local_bundle_adjustment(cam, prob, n_free, schedule, ranks=Ranks(group))


def sharded_local_bundle_adjustment_lil(cam: Camera, prob: BAProblem, lil_state, lil_valid,
                                        ledges, n_free: int, schedule=(5, 10), group=None):
    """Distributed drop-in for solver.ba_lil.local_bundle_adjustment_lil. P,
    Q, E and El must divide by the world size.

    Returns (T_opt, X_opt, lil_state_opt, point_edge_inlier,
    lil_edge_inlier), the same on every rank."""
    return local_bundle_adjustment_lil(cam, prob, lil_state, lil_valid, ledges, n_free,
                                       schedule, ranks=Ranks(group))
