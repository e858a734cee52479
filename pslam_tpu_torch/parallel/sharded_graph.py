"""Edge-sharded Sim3 essential-graph optimization over ``torch.distributed``
(port of ``pslam_tpu/parallel/sharded_graph.py``).

Distributes OptimizeEssentialGraph (reference src/Optimizer.cc:2536-2799):
pose-graph EDGES are the data axis. Each rank computes the Sim3 residuals
and 7x7 Jacobian blocks of its contiguous edge shard and sums them into the
(K, K, 7, 7) block lattice; one ``all_reduce`` of H, b and the cost gives
the full normal equations on every rank, and the dense damped solve runs
replicated (solver/sim3_graph.py ``optimize_essential_graph``, which takes
the ranks). As in parallel/sharded_ba.py, ``group`` replaces the JAX
version's mesh, and at world size 1 the result is bit-identical to
``optimize_essential_graph``.
"""

from __future__ import annotations

from pslam_tpu_torch.geometry.lie import Sim3
from pslam_tpu_torch.parallel.sharded_ba import Ranks
from pslam_tpu_torch.solver.sim3_graph import PoseGraphProblem, optimize_essential_graph


def optimize_essential_graph_sharded(prob: PoseGraphProblem, n_iters: int = 20,
                                     group=None) -> Sim3:
    """Distributed drop-in for optimize_essential_graph: every rank of
    ``group`` calls it with the same problem. The edge-array length must
    divide by the world size (``ValueError``); the loop closer pads it with
    identity measurements."""
    return optimize_essential_graph(prob, n_iters, ranks=Ranks(group))
