"""The gather scheduler of the train loop, as the JAX package's
``core/schedule.py`` schedules its stateless layer scan: the stage-1
prefetch ring (stream 1) and the leaf-level pieces of the async 'pod'
gradient reduce (stream 2) and the cross-step optimizer epilogue
(stream 3), which ``core/engine/train.py`` runs.

Stream 1. At depth k the loop keeps k layers' stage-1 ('pod') gathers
in flight::

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

Stream 2. Each microbatch is differentiated with respect to the
stage-1 view of every leaf, gathered whole (``leaf_stage1``: along the
def's fsdp dim, a stacked leaf at once); the model sees
``stage1_resident_plans``, whose plans have no stage 1, so its
backward stops at the stage-1-level gradient, and
``leaf_stage1_reduce`` issues that gradient's 'pod' reduce-scatter one
microbatch later as async work. The ring has no leaf to hold there.
Stream 3 carries the last microbatch's pending gradient and the
accumulated one across the step boundary. ``async_buffer_bytes`` and
``cross_step_buffer_bytes`` are their analytic per-rank sizes, as the
JAX package counts them.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.collectives import Pending
from repro_torch.core.fcdp import _one_axis
from repro_torch.core.grad_compress import (QuantizedReducePending,
                                            quantized_gather)
from repro_torch.core.partition import tree_map
from repro_torch.core.residency import as_stage1_resident
from repro_torch.core.strategy import GatherPlan, leaf_group


def _in_ring(plan) -> bool:
    """Whether a leaf occupies a ring slot: it has a stage 1 to issue
    ahead."""
    return isinstance(plan, GatherPlan) and plan.prefetchable


class GatherScheduler:
    """The schedule of one stack's layer loop. ``depth`` is resolved
    once: the strategy's cap for the config and mesh
    (``prefetch_depth``), 0 when no plan has a stage 1. ``run`` clamps
    it to the number of layers it runs; each run (a segment of the
    stack, ``LM._segments``) starts its own ring. ``live_depth`` and
    ``ring_bytes`` are the most of the runs since ``reset``."""

    def __init__(self, strategy, sys, mesh_shape, plan_leaves):
        prefetchable = any(_in_ring(p) for p in plan_leaves)
        self.depth = (strategy.prefetch_depth(sys, mesh_shape)
                      if prefetchable else 0)
        self.reset()

    def reset(self) -> None:
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
        self.live_depth = max(self.live_depth, k)
        ring = collections.deque(issue(j) for j in range(k))
        held = self._bytes(ring)
        for i in range(n):
            if k and i + k < n:
                ring.append(issue(i + k))
            slot = ring.popleft() if k else None
            held = max(held, self._bytes(ring))
            compute(i, slot)
        self.ring_bytes = max(self.ring_bytes, held)

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


# -- stream 2: the leaf-level stage 1 and its deferred reduce -------------------

def _stage1_live(plan) -> bool:
    return (isinstance(plan, GatherPlan) and plan.is_gathered
            and bool(plan.inter_axes))


def stage1_resident_plans(plans):
    """The plan tree of a model fed stage-1 views: the inter axes
    stripped (``as_stage1_resident``), so every in-model gather runs
    stage 2 only and its backward reduces over the intra axes only.
    ``sync_axes`` stay as they are: the view's gradient is not summed
    over 'pod' in the model; the deferred reduce-scatter does that."""
    def strip(p):
        if not _stage1_live(p):
            return p
        return dataclasses.replace(
            p, residency=as_stage1_resident(p.residency))
    return tree_map(strip, plans)


def leaf_stage1(w: torch.Tensor, pdef, plan: GatherPlan,
                coll) -> torch.Tensor:
    """The stage-1 ('pod') gather of a whole storage leaf, a stacked one
    at once, along the def's fsdp dim (the per-layer plan's dim + 1 for
    a stacked leaf); int8 on the wire under qwZ (quantized whole, so the
    blocks fall elsewhere than the per-layer gather's). Outside autograd.
    The leaf itself when it has no stage 1."""
    if not _stage1_live(plan):
        return w
    axis = _one_axis(plan.inter_axes)
    with torch.no_grad():
        if plan.residency.quantized_gather:
            return quantized_gather(w, coll, axis, pdef.fsdp_dim)
        return coll.all_gather(w, axis, pdef.fsdp_dim)


def leaf_stage1_reduce(g: torch.Tensor, pdef, plan: GatherPlan, coll):
    """The transpose of ``leaf_stage1``, issued as async work: the 'pod'
    reduce-scatter of a stage-1-level gradient down to the storage
    shard (int8 under qgZ, read from the original plan). Returns a
    handle whose ``wait()`` gives the shard's gradient."""
    if not _stage1_live(plan):
        return Pending(None, (g, g), g.device, None)      # nothing to do
    axis = _one_axis(plan.inter_axes)
    if plan.residency.quantized_reduce:
        return QuantizedReducePending(g, coll, axis, pdef.fsdp_dim)
    return coll.reduce_scatter_async(g, axis, pdef.fsdp_dim)


# -- streams 2 and 3: whether they run, and their analytic bytes ----------------

def async_reduce_enabled(run, strategy, mesh_shape) -> bool:
    """Whether the train step runs the async 'pod' gradient reduce: the
    strategy's gate (the flag, a stage 1, a 'pod' axis) and gradient
    accumulation (microbatch > 1). int8 gradients ride it."""
    return (bool(run.microbatch and run.microbatch > 1)
            and strategy.async_grad_reduce_active(run.system, mesh_shape))


def cross_step_enabled(run, strategy, mesh_shape) -> bool:
    """Whether the train step carries its optimizer epilogue across the
    step boundary: stream 2's conditions, the flag and the strategy's
    gate."""
    return (async_reduce_enabled(run, strategy, mesh_shape)
            and strategy.cross_step_active(run.system, mesh_shape))


def async_buffer_bytes_by_group(strategy, def_leaves, plan_leaves,
                                mesh_shape) -> dict:
    """Per strategy group, ``async_buffer_bytes``."""
    out: dict = {}
    for d, p in zip(def_leaves, plan_leaves):
        if not _stage1_live(p):
            continue
        view = strategy.cached_bytes_for(d, p, mesh_shape)
        total = view                        # the stage-1 view
        if p.residency.receives_gradient:
            total += view                   # its gradient in flight
        g = leaf_group(strategy, d)
        out[g] = out.get(g, 0.0) + total
    return out


def async_buffer_bytes(strategy, def_leaves, plan_leaves,
                       mesh_shape) -> float:
    """Per-rank bytes the async reduce keeps on the device, in the def's
    dtype: the stage-1 view of every leaf with a stage 1 and, for a
    trainable one, its stage-1-level gradient."""
    return sum(async_buffer_bytes_by_group(
        strategy, def_leaves, plan_leaves, mesh_shape).values())


def _leaf_shard_bytes(d, p: GatherPlan, mesh_shape) -> float:
    """Per-rank bytes of one leaf's storage shard, in the def's dtype,
    from its own plan's axes (a pod-replicated leaf shards over the
    intra axes only)."""
    deg = mesh_shape.size("model") if d.tp_dim is not None else 1
    if p.is_gathered:
        deg *= math.prod(mesh_shape.size(a)
                         for a in p.inter_axes + p.intra_axes)
    return d.size() * d.dtype.itemsize / max(deg, 1)


def cross_step_buffer_bytes_by_group(strategy, def_leaves, plan_leaves,
                                     mesh_shape) -> dict:
    """Per strategy group, ``cross_step_buffer_bytes``."""
    out: dict = {}
    for d, p in zip(def_leaves, plan_leaves):
        if not (isinstance(p, GatherPlan) and p.residency.trainable):
            continue
        inter = 1
        if _stage1_live(p):
            inter = math.prod(mesh_shape.size(a) for a in p.inter_axes)
        # the accumulated gradient (storage shard) and the pending one
        # (stage-1 level; the storage shard for a leaf with no stage 1)
        g = leaf_group(strategy, d)
        out[g] = out.get(g, 0.0) + _leaf_shard_bytes(d, p, mesh_shape) \
            * (1.0 + inter)
    return out


def cross_step_buffer_bytes(strategy, def_leaves, plan_leaves,
                            mesh_shape) -> float:
    """Per-rank bytes the cross-step carry holds across the step
    boundary, in the def's dtype: per trainable leaf, its accumulated
    gradient (a storage shard) and its pending one (a stage-1 shard).
    Frozen leaves carry nothing."""
    return sum(cross_step_buffer_bytes_by_group(
        strategy, def_leaves, plan_leaves, mesh_shape).values())
