"""FCDP-Sched: the two-stage parameter gather and where its product waits
for the backward, as the JAX package's ``core/fcdp.py`` schedules it.

  stage 1 (inter):  w_cache = all_gather(w_shard, 'pod')
  stage 2 (intra):  w_full  = all_gather(w_cache, 'data')

The gather's backward is the gradient reduce-scatter: over 'data', then
over 'pod' (int8 on the 'pod' step under qgZ). A leaf stored replicated
over some axes (MiCS's pod axis, the small biases everywhere) has its
gradient summed over them (``SumOver``), where the JAX package's
varying-axes type system puts that sum: after any cast the consumer
applies, so a norm scale read in fp32 is summed in fp32. Its widening
axes (hier's 'pod', an 'inter_only' leaf's intra axes:
``GatherPlan.sync_axes`` leaves them out) are summed by the engine's
reduce-scatter instead.

Inside a layer (``ParamGather.layer()``) no full weight is kept for the
backward. A ``torch.autograd.graph.saved_tensors_hooks`` pair stands in
for the JAX package's remat policy: when an op saves a gathered weight,
the pack hook stores a handle to its cache instead, and the first unpack
in the backward rebuilds the weight from it (once per layer, shared by
every op that saved it, dropped after the last). A saved tensor is
recognised by its storage, offset, shape, stride, dtype and device, and
a saved view of a gathered weight (a row of it) by its storage, and
taken from the rebuilt weight; the
scope holds each gathered weight until it ends, so no activation can
take a weight's address meanwhile and be mistaken for it. Where the
cache lives is the strategy's placement:

  zero3   'regather': the handle holds the storage shard; the backward
          re-runs both stages (two inter gathers per step at prefetch
          depth 0)
  zeropp  'device':   the stage-1 result stays on the device; the
          backward re-runs stage 2 only
  fcdp    'host':     the stage-1 result is copied to pinned host memory
          (a plain CPU tensor on the CPU); the backward copies it back
          and re-runs stage 2 only (the paper)
  mics    no stage 1; the single intra stage is re-run ('regather')

With no 'pod' axis (one pod) the cache boundary moves after stage 2
(``cache_after == 2``): zeropp/fcdp keep the full weight on the device /
host. The embedding, final norm and head are used outside the layers;
as in the JAX package, autograd keeps their gathered weights.

A frozen leaf (PEFT) is gathered like the JAX package's invariant
gather: its shard does not require grad, so no gradient flows into it
and it has no ``SumOver`` sum. The backward still reads its weight (the
input gradient of the projections it feeds) from the same sources.
Under fcdp the frozen trunk is stored pod-replicated, so it has no stage
1 and ``cache_after == 2``: its fully gathered weight waits on the host
tier and the backward copies it back with no 'data' regather (the
"fully cached" of FCDP). Under zero3 a frozen leaf stays dcn_sharded
and is regathered over 'pod' in the backward.

A fused plan (``GatherPlan.is_fused``: an output projection under
``SystemConfig.fused_matmul``) never makes the full weight: stage 2
returns a ``FusedParam`` holding the stage-1 result, and
``models.layers.matmul`` hands it to the gather-fused collective matmul,
which gathers stage 2 chunk by chunk inside its ring. That matmul saves
the stage-1 tensor for its backward, so the layer scope registers the
stage-1 tensor itself and rebuilds it from its tier: the pinned host
copy (fcdp), the device copy (zeropp), or a stage-1 regather (zero3;
the shard itself under mics). The gradient sum over replicated axes
(MiCS's 'pod') then happens inside the matmul's backward, on the full
dw before the reduce-scatter over the ring axis, where the unfused
step's ``SumOver`` puts it.

A leaf in the stage-1 prefetch ring (``core/schedule.py``: depth k > 0,
a leaf with a stage 1) is gathered in two calls. ``issue_stage1``
starts its stage-1 gather as async work k layers ahead and returns a
``Stage1Slot`` (under qwZ the shard is quantized at issue and
dequantized at ``wait()``); the layer then consumes the slot through
``ParamGather.__call__(..., slot=)``, which records the stage-1 gather
in autograd there (``Stage1Gather``, as at depth 0: its backward is
the 'pod' reduce-scatter, exact or int8) and runs stage 2 from the slot's
tensor, or hands it to the fused matmul. The backward rebuilds a
ring-fed weight from that stage-1 tensor by stage 2 only: fcdp keeps it
on its host tier, zeropp on the device, and zero3 on the device too,
as the JAX package's scan carry holds it, so zero3's backward no
longer regathers over 'pod'.

Under the async 'pod' gradient reduce (``core/schedule.py``, stream 2)
the gather holds ``stage1_resident_plans``: ``w`` is a slice of a
stage-1 view gathered outside the model, and a plan has no stage 1
left. Stage 2 runs as usual, and the backward rebuilds the weight from
that slice in place, whatever the strategy's tier: the view is on the
device already (counted by ``async_buffer_bytes``), so fcdp does not
copy it to the host every microbatch, zero3 does not regather it, and
``cached`` counts it under 'device'. (The JAX package's remat policy
marks the slice with the strategy's tier, host under fcdp, but the
slice is its layer scan's input, and the view stays on the device for
the scan's backward either way.)

FCDP-Cache (``core/cache.py``) moves host-placed caches to the device,
as the JAX package's remat policy does with ``promote_to_device`` and
``host_offload``: inside ``promoted()`` (a layer of the stack's device
segment, ``SystemConfig.device_cache_fraction``), and everywhere when
``host_offload`` is False, a cache the strategy places on the host is
kept on the device; regather and device caches are left as they are.
``cached`` and ``cache_places`` report the tier each cache lands on.

The copy to the host is a synchronous ``non_blocking`` copy on the
current stream; overlapping it on a side stream is later work.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Optional

import torch

from repro_torch.core.grad_compress import (QuantizedPending,
                                            int8_psum_scatter,
                                            quantized_gather)
from repro_torch.core.strategy import GatherPlan


class AllGather(torch.autograd.Function):
    """Tiled all-gather over one axis; its backward is the matching
    reduce-scatter."""

    @staticmethod
    def forward(ctx, w, coll, axis, dim):
        ctx.coll, ctx.axis, ctx.dim = coll, axis, dim
        return coll.all_gather(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.reduce_scatter(g, ctx.axis, ctx.dim), None, None, \
            None


class SumOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``axes``
    (the axes a leaf's storage is replicated over)."""

    @staticmethod
    def forward(ctx, w, coll, axes):
        ctx.coll, ctx.axes = coll, axes
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_reduce(g, ctx.axes), None, None


def _one_axis(axes) -> str:
    if len(axes) != 1:
        raise ValueError(f"a gather stage over several axes {axes} is not "
                         "ported")
    return axes[0]


class Stage1Slot:
    """One leaf's stage-1 gather issued ahead of its layer: ``wait()``
    gives the stage-1 tensor (outside autograd, once). ``nbytes`` is
    the size of that tensor."""
    __slots__ = ("pending", "value", "nbytes")

    def __init__(self, w: torch.Tensor, plan: GatherPlan, coll):
        axis = _one_axis(plan.inter_axes)
        w = w.detach()
        if plan.residency.quantized_gather:
            self.pending = QuantizedPending(w, coll, axis, plan.fsdp_dim)
        else:
            self.pending = coll.all_gather_async(w, axis, plan.fsdp_dim)
        self.value = None
        self.nbytes = w.numel() * w.element_size() * coll.size(axis)

    def wait(self) -> torch.Tensor:
        if self.value is None:
            self.value, self.pending = self.pending.wait(), None
        return self.value


class Stage1Gather(torch.autograd.Function):
    """Stage 1 in autograd: the forward hands back a slot's gathered
    tensor (int8 on the wire under qwZ); the backward is the stage-1
    gather's reduce-scatter over ``axis`` (int8 under qgZ)."""

    @staticmethod
    def forward(ctx, w, gathered, coll, axis, dim, int8_reduce):
        ctx.coll, ctx.axis, ctx.dim = coll, axis, dim
        ctx.int8_reduce = int8_reduce
        return gathered.view_as(gathered)

    @staticmethod
    def backward(ctx, g):
        if ctx.int8_reduce:
            gw = int8_psum_scatter(g, ctx.coll, ctx.axis, ctx.dim)
        else:
            gw = ctx.coll.reduce_scatter(g, ctx.axis, ctx.dim)
        return gw, None, None, None, None, None


def gather_stage1(w: torch.Tensor, plan: GatherPlan, coll,
                  slot: Optional[Stage1Slot] = None) -> torch.Tensor:
    """Stage 1 (inter) all-gather: shard -> cached shard, from ``slot``
    (w's stage 1 issued ahead) or issued here; qwZ / qgZ when the
    residency says so. The identity without inter axes."""
    if not plan.is_gathered or not plan.inter_axes:
        return w
    if slot is None:
        slot = Stage1Slot(w, plan, coll)
    return Stage1Gather.apply(w, slot.wait(), coll,
                              _one_axis(plan.inter_axes), plan.fsdp_dim,
                              plan.residency.quantized_reduce)


class FusedParam:
    """A stage-1 result standing in for the full weight of a fused plan:
    ``models.layers.matmul`` runs the stage-2 gather inside the consuming
    matmul's ring (``kernels/collective_matmul.py``) over ``coll``. With
    ``reads`` False (a layer's recompute that never reads the product,
    ``models/stack.py``) the matmul runs no ring and only its backward
    is wanted."""
    __slots__ = ("cache", "plan", "coll", "reads")

    def __init__(self, cache: torch.Tensor, plan: GatherPlan, coll,
                 reads: bool = True):
        self.cache, self.plan, self.coll = cache, plan, coll
        self.reads = reads


def gather_stage2(w: torch.Tensor, plan: GatherPlan, coll):
    """Stage 2 (intra) all-gather: cached shard -> full weight; a fused
    plan returns a ``FusedParam`` instead and gathers nothing here."""
    if not plan.is_gathered or not plan.intra_axes:
        return w
    if plan.is_fused:
        return FusedParam(w, plan, coll)
    return AllGather.apply(w, coll, _one_axis(plan.intra_axes), plan.fsdp_dim)


def _stage1_value(w, plan, coll):
    """Stage 1 outside autograd (the backward's regather)."""
    if not plan.inter_axes:
        return w
    axis = _one_axis(plan.inter_axes)
    if plan.residency.quantized_gather:
        return quantized_gather(w, coll, axis, plan.fsdp_dim)
    return coll.all_gather(w, axis, plan.fsdp_dim)


def _stage2_value(w, plan, coll):
    if not plan.intra_axes:
        return w
    return coll.all_gather(w, _one_axis(plan.intra_axes), plan.fsdp_dim)


class _Saved:
    """What the backward holds in place of one gathered weight."""
    __slots__ = ("rebuild", "uses", "value")

    def __init__(self, rebuild: Callable[[], torch.Tensor]):
        self.rebuild, self.uses, self.value = rebuild, 0, None

    def take(self) -> torch.Tensor:
        if self.value is None:
            with torch.no_grad():
                self.value = self.rebuild()
        v = self.value
        self.uses -= 1
        if self.uses <= 0:
            self.value = None
        return v


class _SavedView:
    """What the backward holds in place of a view of a gathered weight
    (a row of it, say): the weight's handle and the view's geometry
    within it, re-applied to the rebuilt weight."""
    __slots__ = ("saved", "offset", "shape", "stride")

    def __init__(self, saved: _Saved, offset: int, shape, stride):
        self.saved, self.offset = saved, offset
        self.shape, self.stride = shape, stride

    def take(self) -> torch.Tensor:
        full = self.saved.take()
        return full.as_strided(self.shape, self.stride,
                               full.storage_offset() + self.offset)


def _storage_id(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it lives (its address where
    tensors have none: fake tensors all report 0)."""
    return t.untyped_storage()._cdata


def _key(t: torch.Tensor):
    return (_storage_id(t), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype, t.device)


def pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """The host tier of ``t``: a pinned host copy of a device tensor,
    ``t`` itself on the CPU."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class ParamGather:
    """Gathers this rank's shards into full weights through their plans
    (``plans``: the nested dict of GatherPlans, like the parameters): a
    call is the JAX package's ``gather_param`` (both stages, sequential)
    with the cache placement of the leaf's strategy.

    ``cached`` counts, per step, the bytes of the caches kept for the
    backward by tier ('device' | 'host') and where those tensors lie
    (``cache_places``: (device type, pinned) pairs). With
    ``host_offload`` False a host-placed cache stays on the device."""

    def __init__(self, coll, plans, scheduler, host_offload: bool = True):
        self.coll, self.plans = coll, plans
        # the layer loop's schedule (core/schedule.GatherScheduler)
        self.scheduler = scheduler
        self.host_offload = host_offload
        self._promote = False
        self._entries: Optional[dict] = None
        self._views: Optional[dict] = None
        self.cached = defaultdict(int)
        self.cache_places = defaultdict(set)
        # the host tier's copy of a cache (the dry run counts its own)
        self.host_copy = pinned_copy

    def issue_stage1(self, w: torch.Tensor, plan: GatherPlan) -> Stage1Slot:
        """Start the stage-1 gather of a ring leaf's shard ``w``."""
        return Stage1Slot(w, plan, self.coll)

    def __call__(self, w: torch.Tensor, plan: GatherPlan,
                 dtype: Optional[torch.dtype] = None,
                 over_model: bool = False,
                 slot: Optional[Stage1Slot] = None):
        """The full weight of shard ``w`` in ``dtype`` (None keeps w's),
        with its gradient summed over the plan's replicated axes, and
        over 'model' too with ``over_model`` (a leaf replicated over
        'model' that meets 'model'-varying values), in one all-reduce; a
        ``FusedParam`` for a fused plan. With ``slot`` (w's stage 1
        issued ahead) stage 1 comes from the slot."""
        def cast(t):
            return t if dtype is None else t.to(dtype)
        stage1 = gather_stage1(w, plan, self.coll, slot)
        placement = plan.residency.cache
        if plan.residency.stage1_resident or (slot is not None
                                              and placement == "regather"):
            # the backward reads the slot's tensor, or the resident
            # stage-1 view, on the device: never regathers nor parks it
            placement = "device"
        if placement == "host" and (self._promote or not self.host_offload):
            placement = "device"
        if plan.is_fused:
            if self._entries is not None:
                self._entries[_key(stage1)] = (stage1, _Saved(
                    self._stage1_rebuilder(w.detach(), stage1.detach(),
                                           plan, placement)))
            return gather_stage2(stage1, plan, self.coll)
        full = cast(gather_stage2(stage1, plan, self.coll))
        if self._entries is not None and plan.is_gathered:
            # the entry holds the weight until the layer scope ends, so
            # no other tensor can take its address and be mistaken for it
            entry = (full, _Saved(
                self._rebuilder(w.detach(), stage1.detach(), full.detach(),
                                plan, cast, placement)))
            self._entries[_key(full)] = entry
            self._views[(_storage_id(full), full.dtype,
                         full.device)] = entry
        sync = plan.sync_axes + (("model",) if over_model else ())
        if sync and plan.residency.receives_gradient:
            full = SumOver.apply(full, self.coll, sync)
        return full

    def _rebuilder(self, w, stage1, full, plan, cast, placement):
        coll = self.coll
        if placement == "regather":
            def rebuild():
                return cast(_stage2_value(_stage1_value(w, plan, coll),
                                          plan, coll))
            return rebuild
        if plan.cache_after == 1:
            cache = self._park(stage1, placement)

            def rebuild():
                return cast(_stage2_value(cache.to(w.device), plan, coll))
            return rebuild
        cache = self._park(full, placement)
        return lambda: cache.to(w.device)

    def _stage1_rebuilder(self, w, stage1, plan, placement):
        """The backward's source of a fused plan's stage-1 tensor."""
        coll = self.coll
        if placement == "regather":
            return lambda: _stage1_value(w, plan, coll)
        cache = self._park(stage1, placement)
        return lambda: cache.to(w.device)

    def _park(self, t: torch.Tensor, placement: str) -> torch.Tensor:
        """The cache of ``t`` on its tier: ``t`` itself on the device,
        ``host_copy(t)`` on the host."""
        if placement == "host":
            t = self.host_copy(t)
        self.cached[placement] += t.numel() * t.element_size()
        self.cache_places[placement].add((t.device.type, t.is_pinned()))
        return t

    @contextlib.contextmanager
    def promoted(self, on: bool = True):
        """Scope of the stack's device segment: host-placed caches wait
        on the device (FCDP-Cache's promotion)."""
        prev, self._promote = self._promote, on
        try:
            yield
        finally:
            self._promote = prev

    # -- the layer scope ---------------------------------------------------
    def _pack(self, t: torch.Tensor):
        if not self._entries:
            return t
        hit = self._entries.get(_key(t))
        if hit is not None:
            hit[1].uses += 1
            return hit[1]
        # a view of a gathered weight: the JAX remat recomputes it from
        # the regathered weight, so it is rebuilt from the same cache
        hit = self._views.get((_storage_id(t), t.dtype, t.device))
        if hit is None:
            return t
        full, saved = hit
        saved.uses += 1
        return _SavedView(saved, t.storage_offset() - full.storage_offset(),
                          tuple(t.shape), tuple(t.stride()))

    @staticmethod
    def _unpack(obj):
        return (obj.take() if isinstance(obj, (_Saved, _SavedView))
                else obj)

    @contextlib.contextmanager
    def layer(self):
        """Scope of one layer's forward: weights gathered inside it are
        rebuilt for the backward from their caches, never kept."""
        if self._entries is not None:
            raise RuntimeError("layer scopes do not nest")
        self._entries, self._views = {}, {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._entries = self._views = None
