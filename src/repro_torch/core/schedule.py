"""The stage-1 prefetch ring of the train loop's layers, as the JAX
package's ``core/schedule.py`` schedules its stateless layer scan
(stream 1; the async gradient reduce and the cross-step epilogue,
streams 2 and 3, come later).

At depth k the loop keeps k layers' stage-1 ('pod') gathers in flight::

    ring = [issue(0), ..., issue(k-1)]        # prologue
    layer i = 0..n-1:
        issue(i + k)        if i + k < n      # async work, no dependency
        compute(i, ring.pop_oldest())         # on layer i's compute

and drains the ring in the last k layers (the epilogue). Only leaves
with a stage 1 occupy a slot (``_in_ring``); the others (mics, hier,
the frozen fcdp trunk, replicated tensors) are gathered in place by
the layer that uses them. Depth 0 is the sequential loop: each layer
gathers its own weights, both stages. A ring-fed weight is rebuilt in
the backward from its slot's stage-1 tensor (``core/fcdp.py``), so
the ring moves no 'pod' bytes under zeropp and fcdp and retires
zero3's backward regather.

``prefetch_buffer_bytes`` is the analytic per-rank size of the k ring
slots, as the JAX package counts it (``cached_bytes_for`` in the def's
dtype); the loop measures the bytes its ring held (``ring_bytes``).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

from repro_torch.core.strategy import GatherPlan, leaf_group


def _in_ring(plan) -> bool:
    """Whether a leaf occupies a ring slot: it has a stage 1 to issue
    ahead."""
    return isinstance(plan, GatherPlan) and plan.prefetchable


class GatherScheduler:
    """The schedule of one stack's layer loop. ``depth`` is resolved
    once: the strategy's cap for the config and mesh
    (``prefetch_depth``), 0 when no plan has a stage 1. ``run`` clamps
    it to the number of layers (``live_depth``)."""

    def __init__(self, strategy, sys, mesh_shape, plan_leaves):
        prefetchable = any(_in_ring(p) for p in plan_leaves)
        self.depth = (strategy.prefetch_depth(sys, mesh_shape)
                      if prefetchable else 0)
        self.live_depth = 0
        self.ring_bytes = 0

    def run(self, n: int, issue: Callable[[int], Dict],
            compute: Callable[[int, Optional[Dict]], None]) -> None:
        """Run layers 0..n-1: ``issue(j)`` starts layer j's stage-1
        gathers and returns its slot (leaf key -> ``Stage1Slot``);
        ``compute(i, slot)`` runs layer i from its slot (None at depth
        0). Records the live depth and the most bytes the ring held
        between layers: k slots after the prologue and after each
        layer's issue and take."""
        k = min(self.depth, n)
        self.live_depth = k
        ring = collections.deque(issue(j) for j in range(k))
        held = self._bytes(ring)
        for i in range(n):
            if k and i + k < n:
                ring.append(issue(i + k))
            slot = ring.popleft() if k else None
            held = max(held, self._bytes(ring))
            compute(i, slot)
        self.ring_bytes = held

    @staticmethod
    def _bytes(ring) -> int:
        return sum(s.nbytes for slot in ring for s in slot.values())


def prefetch_buffer_bytes_by_group(strategy, def_leaves, plan_leaves,
                                   mesh_shape, depth: int) -> dict:
    """Per strategy group, the per-rank bytes of ``depth`` ring slots:
    each stacked ring leaf's stage-1 bytes divided by its stack length
    (one layer's share), times the depth."""
    out: dict = {}
    if depth <= 0:
        return out
    for d, p in zip(def_leaves, plan_leaves):
        if not _in_ring(p) or "stack" not in d.dims:
            continue
        n = d.shape[d.dims.index("stack")]
        g = leaf_group(strategy, d)
        out[g] = (out.get(g, 0.0) + float(depth)
                  * strategy.cached_bytes_for(d, p, mesh_shape) / max(n, 1))
    return out


def prefetch_buffer_bytes(strategy, def_leaves, plan_leaves, mesh_shape,
                          depth: int) -> float:
    """Per-rank bytes of the ``depth`` in-flight ring slots."""
    return sum(prefetch_buffer_bytes_by_group(
        strategy, def_leaves, plan_leaves, mesh_shape, depth).values())
