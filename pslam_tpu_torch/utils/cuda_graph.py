"""One captured CUDA graph per input shape, replayed on static buffers.

A solve made of thousands of small kernels spends its time on the host,
queueing them one by one. ``GraphCache.run(key, fn, *args)`` runs
``fn(*args)`` (tensors, or tuples and NamedTuples of them, in and out; no
host read inside) in one of three ways, chosen from what the call can
observe:

- the first call of a key (the caller's key, the arguments' structure and
  every tensor's shape, dtype and device) runs ``fn`` eagerly, so a caller
  that comes once pays nothing;
- the second captures ``fn`` into a CUDA graph on static copies of the
  arguments, then replays it;
- later calls copy their arguments into those copies and replay.

A replay returns clones of the graph's outputs: the next replay of the same
graph overwrites its static outputs, and a result the caller holds must not
change under it. Every graph of a cache allocates from one memory pool
(``torch.cuda.graph_pool_handle()``): replays run one after another on the
caller's stream, and each one's outputs are cloned before the next starts.

Anything ``fn`` reads that is not an argument (Python scalars, a camera's
focal lengths, loop counts) is baked into the graph, so it belongs in the
caller's key.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


class GraphCache:
    """Graphs by key, with counters of the calls that ran eagerly
    (``eager``), captured (``captures``) and replayed (``replays``; a
    capturing call also replays)."""

    DEVICE_TYPES = ("cuda",)

    def __init__(self):
        self.seen = set()
        self.graphs = {}
        self.eager = self.captures = self.replays = 0
        self._pool = None

    def takes(self, t: torch.Tensor) -> bool:
        """Whether a call on ``t``'s device goes through the cache at all."""
        return t.device.type in self.DEVICE_TYPES

    def run(self, key, fn, *args):
        flat, spec = tree_flatten(args)
        key = (key, spec, tuple((tuple(x.shape), x.dtype, x.device) for x in flat))
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen:
                self.seen.add(key)
                self.eager += 1
                return fn(*args)
            static_in = [x.clone() for x in flat]
            entry = self.graphs[key] = (
                static_in, *self._capture(lambda: fn(*tree_unflatten(static_in, spec))))
            self.captures += 1
        static_in, replay, static_out = entry
        for s, x in zip(static_in, flat):
            s.copy_(x)
        replay()
        self.replays += 1
        return tree_map(torch.clone, static_out)

    def _capture(self, fn):
        """(replay, static outputs) of ``fn()`` captured."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        return graph.replay, out
