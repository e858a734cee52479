"""Distribution: the edge-sharded solvers over ``torch.distributed``.

The reference has no distributed computing at all; the JAX package shards
over a ``jax.sharding.Mesh``. Here every rank of a process group runs the
same program on the same replicated problem: observation edges are split by
rank, the per-rank partial Hessian/gradient blocks are combined with
``all_reduce`` / ``reduce_scatter``, and the reduced camera solve is
replicated. A process group (``group=``, default the world group) takes the
place of the JAX package's ``make_ba_mesh``.
"""

from pslam_tpu_torch.parallel.sharded_ba import (  # noqa: F401
    sharded_local_bundle_adjustment,
    world_size,
)
