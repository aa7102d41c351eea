"""The FCDP train step of one rank, as the JAX package's
``core/engine/train.py`` builds it from ``_build_parts``
(``accumulate_seq``, ``accumulate_async``, ``fold``, ``apply_grads``):
the fused step, and the cross-step schedule's prime, piped and flush.

One step: the loss over this rank's batch rows (the forward gathers
every weight through its plan, the layers under the stage-1 prefetch
ring at ``SystemConfig.prefetch_depth``, ``core/schedule.py``), its
backward (the gathers' backwards reduce-scatter the gradients onto the
shards), the loss terms summed over the data-parallel axes, then the
optimizer epilogue (``apply_grads``): the widening reduce-scatter of
each widened leaf's gradient (hier, an 'inter_only' leaf: over the axes
its optimizer state shards over beyond its storage, which sums it there
once), global-norm clip, AdamW on the optimizer layout's blocks, and
the updated blocks gathered back over the widening axes. Under PEFT
only the trainable leaves (the adapters) get gradients, a clip norm
term and optimizer state; the frozen trunk is read, never updated. With
``RunConfig.microbatch`` = nm >= 2 the rank's rows are split into nm
microbatches whose gradients add up in the parameter dtype and are
divided by nm, as the JAX scan does.

Three schedules of the microbatch loop and the epilogue:

  sequential  every microbatch's backward runs the gathers' full
              reduce-scatters (``accumulate_seq``).
  async       ``SystemConfig.async_grad_reduce`` (stream 2): each
              microbatch is differentiated with respect to a leaf-level
              stage-1 view (detached leaves that require grad; the model
              sees ``stage1_resident_plans``), so its backward stops at
              the stage-1-level gradient; that gradient's 'pod'
              reduce-scatter is issued as async work at the top of the
              next microbatch, whose forward does not depend on it, and
              waited on after that microbatch's backward
              (``accumulate_async``); the last one is retired by
              ``fold``. The same 'pod' bytes move, later.
  cross-step  ``SystemConfig.cross_step_pipeline`` (stream 3): the last
              microbatch's reduce and the epilogue are carried across
              the step boundary. ``prime`` runs a batch's loop and
              returns the carry (this rank's accumulated gradient, a
              storage shard a leaf, and the pending stage-1-level one);
              ``piped`` first finalizes the carry (``fold`` and
              ``apply_grads``, in place on the shards and optimizer
              state), then runs its batch's loop on the updated
              parameters and returns the next carry; ``flush`` finalizes
              the last. The same ops in the same order as the fused
              async step, so the same bits: nothing runs on stale
              parameters.

The carry is checkpointed in the JAX package's global layout
(``carried_layout``, ``cross_step_carry_signature``): this rank's carry
tensor is one row of a global array with a leading partial dim.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.fcdp import ParamGather
from repro_torch.core.partition import _entry_axes, tree_items
from repro_torch.core.schedule import (GatherScheduler,
                                       async_reduce_enabled,
                                       cross_step_enabled, leaf_stage1,
                                       leaf_stage1_reduce,
                                       stage1_resident_plans)
from repro_torch.core.strategy import spec_axes
from repro_torch.launch.mesh import fsdp_axes
from repro_torch.optim.adamw import adamw_update, clip_by_global_norm

Carry = Dict[str, List[torch.Tensor]]


class TrainStep:
    """``step(params, opt_state, batch) -> metrics`` is the fused step:
    it updates this rank's shards and optimizer state in place. metrics:
    loss, aux_loss, grad_norm, tokens (Python floats; with microbatches
    ``tokens`` is 1, as in the JAX step). When stream 3 is live
    (``use_xstep``), ``prime`` / ``piped`` / ``flush`` run the
    cross-step schedule instead. ``gather`` keeps the cache bytes and
    places of the last call, ``gather.scheduler`` its ring's live depth
    and bytes; on a card, ``memory`` keeps the last call's device
    memory by part (``_mark``). With ``host_metrics`` False the metrics
    stay 0-dim tensors, read on the host by nothing in the step (the
    dry run's fake tensors have no values to read)."""

    def __init__(self, bundle, coll):
        run = bundle.run
        self.bundle, self.coll = bundle, coll
        self.model = bundle.model
        self.sys, self.opt_cfg = run.system, run.optimizer
        self.nm = run.microbatch or 0
        ms = bundle.mesh_shape
        self.use_async = async_reduce_enabled(run, bundle.strategy, ms)
        self.use_xstep = cross_step_enabled(run, bundle.strategy, ms)
        plans = (stage1_resident_plans(bundle.plans) if self.use_async
                 else bundle.plans)
        self.gather = ParamGather(coll, plans, GatherScheduler(
            bundle.strategy, self.sys, ms, [p for _, p in tree_items(plans)]),
            self.sys.host_offload)
        self.primed = False          # a cross-step carry is outstanding
        self.host_metrics = True
        self.memory: Dict[str, Tuple[int, int]] = {}
        self.widen = bundle.widen
        self.train_leaves = [(bundle.def_leaves[i], bundle.plan_leaves[i])
                             for i in bundle.train_idx]
        self.frozen_leaves = [(bundle.def_leaves[i], bundle.plan_leaves[i])
                              for i in bundle.frozen_idx]
        # no weight decay on vectors and on the LoRA adapters
        self.wd_mask = [len(d.shape) >= 2 and "_lora_" not in d.label
                        for d, _ in self.train_leaves]
        self.reps = [bundle.rep_factors[i] for i in bundle.train_idx]
        self.dp_axes = fsdp_axes(ms)

    def _loss_backward(self, params, batch, report_aux: bool = True):
        """Forward and backward of one (micro)batch; returns the global
        (ce, aux, tokens) as 0-dim tensors. The terms are summed over
        the data-parallel axes; the aux sum only where it is reported
        (not per microbatch, where the JAX step drops it)."""
        ls, cnt, aux = self.model.loss_fn(params, batch, self.gather,
                                          self.bundle.defs,
                                          self.bundle.strategy)
        terms = [ls.detach(), cnt.detach()] + ([aux.detach()]
                                               if report_aux else [])
        tot = self.coll.all_reduce(torch.stack(terms), self.dp_axes)
        denom = torch.clamp(tot[1], min=1.0)
        ((ls + aux) / denom).backward()
        return (tot[0] / denom, tot[2] / denom if report_aux else None,
                tot[1])

    def _microbatches(self, batch: Dict):
        rows = batch["ids"].shape[0]
        if rows % self.nm:
            raise ValueError(f"{rows} rows do not split into {self.nm} "
                             "microbatches")
        b = rows // self.nm
        for i in range(self.nm):
            yield {k: v[i * b:(i + 1) * b] for k, v in batch.items()}

    def _begin(self) -> None:
        self.gather.cached.clear()
        self.gather.cache_places.clear()
        self.gather.scheduler.reset()
        self.memory = {}
        self._mark("start")

    def _mark(self, part: str, reset: bool = True) -> None:
        """On a card, record this process's device memory for ``part``
        of the call: (its peak since the previous mark, the bytes still
        allocated at its end); with ``reset`` the next part's peak
        starts here."""
        dev = self.bundle.device
        if dev.type == "cuda":
            self.memory[part] = (torch.cuda.max_memory_allocated(dev),
                                 torch.cuda.memory_allocated(dev))
            if reset:
                torch.cuda.reset_peak_memory_stats(dev)

    # -- the parts ---------------------------------------------------------
    def accumulate_seq(self, params, batch: Dict):
        """The sequential loop: (the summed gradients of the trainable
        shards, the summed ce)."""
        train, _ = self.bundle.split(params)
        ce = 0.0
        for mb in self._microbatches(batch):
            ce = ce + self._loss_backward(params, mb, False)[0]
        grads = _grads(train)
        return grads, ce

    def _reduce(self, pending):
        """Issue the 'pod' reduce-scatter of each stage-1-level gradient
        (the identity for a leaf with no stage 1)."""
        return [leaf_stage1_reduce(g, d, p, self.coll)
                for g, (d, p) in zip(pending, self.train_leaves)]

    def accumulate_async(self, params, batch: Dict):
        """The stream-2 loop: (the accumulated storage-level gradients,
        the last microbatch's pending stage-1-level ones, the summed
        ce). Microbatch 0 is peeled: microbatch i >= 1 issues i - 1's
        reduce before its forward and adds it up after its backward."""
        train, frozen = self.bundle.split(params)
        g_acc: Optional[List[torch.Tensor]] = None
        pending = None
        ce = 0.0
        for i, mb in enumerate(self._microbatches(batch)):
            # the handles keep what their reduces still read
            reducing, pending = (None if pending is None
                                 else self._reduce(pending)), None
            views = [leaf_stage1(w, d, p, self.coll).detach()
                     .requires_grad_() for w, (d, p)
                     in zip(train, self.train_leaves)]
            fixed = [leaf_stage1(w, d, p, self.coll).detach()
                     for w, (d, p) in zip(frozen, self.frozen_leaves)]
            if i == 0:              # the views resident, nothing else yet
                self._mark("view", reset=False)
            ce = ce + self._loss_backward(self.bundle.merge(views, fixed),
                                          mb, False)[0]
            pending = [v.grad if v.grad is not None else torch.zeros_like(v)
                       for v in views]
            del views, fixed
            if reducing is not None:
                done = [r.wait() for r in reducing]
                g_acc = done if g_acc is None else [
                    a + r for a, r in zip(g_acc, done)]
        return g_acc, pending, ce

    def fold(self, g_acc, pending) -> List[torch.Tensor]:
        """Retire the last microbatch's deferred reduce and divide by the
        microbatch count."""
        done = [r.wait() for r in self._reduce(pending)]
        return [(a + r) / self.nm for a, r in zip(g_acc, done)]

    def apply_grads(self, train, grads, opt_state) -> torch.Tensor:
        """The optimizer epilogue on this rank's trainable shards
        ``train`` (updated in place): the widening reduce-scatter, the
        global-norm clip, AdamW and the widened gather back. Returns the
        grad norm. One call site for every schedule, so the fused,
        piped and flush calls run the same ops in the same order."""
        grads = list(grads)
        for j, (dim, axes) in self.widen.items():
            for a in axes:          # first axis major, as the opt spec
                grads[j] = self.coll.reduce_scatter(grads[j], a, dim)
        grads, gnorm = clip_by_global_norm(
            grads, self.reps, self.opt_cfg.grad_clip, self.coll,
            self.dp_axes + ("model",))
        blocks = [torch.empty_like(g, dtype=p.dtype) if j in self.widen
                  else p for j, (p, g) in enumerate(zip(train, grads))]
        adamw_update(blocks, grads, opt_state, self.opt_cfg, self.sys,
                     self.wd_mask)
        with torch.no_grad():
            for j, (dim, axes) in self.widen.items():
                t = blocks[j]
                for a in reversed(axes):    # inverts the reduce-scatter
                    t = self.coll.all_gather(t, a, dim)
                train[j].copy_(t)
        return gnorm

    # -- the fused step ---------------------------------------------------
    def __call__(self, params, opt_state, batch: Dict) -> Dict[str, float]:
        self._begin()
        train, _ = self.bundle.split(params)
        for p in train:
            p.grad = None
        if self.nm > 1:
            if self.use_async:
                g_acc, pending, ce = self.accumulate_async(params, batch)
                self._mark("accumulate")
                grads = self.fold(g_acc, pending)
                del g_acc, pending
            else:
                grads, ce = self.accumulate_seq(params, batch)
                self._mark("accumulate")
                grads = [g / self.nm for g in grads]
            ce, aux, tokens = ce / self.nm, 0.0, 1.0
        else:
            ce, aux, tokens = self._loss_backward(params, batch)
            grads = _grads(train)
            self._mark("accumulate")
        gnorm = self.apply_grads(train, grads, opt_state)
        self._mark("apply")
        return self._metrics({"loss": ce, "aux_loss": aux,
                              "grad_norm": gnorm, "tokens": tokens})

    def _metrics(self, m) -> Dict[str, float]:
        if not self.host_metrics:
            return m
        return {k: float(v) for k, v in m.items()}

    # -- the cross-step schedule (stream 3) --------------------------------
    def _xstep_metrics(self, ce, gnorm) -> Dict[str, float]:
        return self._metrics({"loss": ce / self.nm, "aux_loss": 0.0,
                              "grad_norm": gnorm, "tokens": 1.0})

    def _need(self, primed: bool) -> None:
        if not self.use_xstep:
            raise ValueError("the cross-step pipeline is not live for this "
                             "run (see core/schedule.py:cross_step_enabled)")
        if self.primed != primed:
            raise RuntimeError("prime starts the pipeline and flush ends it: "
                               + ("no carry is outstanding" if primed
                                  else "a carry is outstanding"))

    def prime(self, params, opt_state, batch: Dict
              ) -> Tuple[Carry, Dict[str, float]]:
        """Fill the pipeline: run ``batch``'s loop on the current
        parameters and return its carry; the parameters and the
        optimizer state are untouched. Reports grad_norm 0 (no norm is
        computed before the first finalize)."""
        self._need(False)
        self._begin()
        g_acc, pending, ce = self.accumulate_async(params, batch)
        self._mark("accumulate")
        self.primed = True
        return {"g_acc": g_acc, "pending": pending}, \
            self._xstep_metrics(ce, 0.0)

    def piped(self, params, opt_state, carry: Carry, batch: Dict
              ) -> Tuple[Carry, Dict[str, float]]:
        """Finalize ``carry`` (emptied here) on the shards and the
        optimizer state in place, then run ``batch``'s loop on the
        updated parameters. Returns the next carry and metrics whose
        grad_norm is the finalized (previous) step's."""
        self._need(True)
        self._begin()
        train, _ = self.bundle.split(params)
        grads = self.fold(carry.pop("g_acc"), carry.pop("pending"))
        gnorm = self.apply_grads(train, grads, opt_state)
        del grads
        self._mark("apply")
        g_acc, pending, ce = self.accumulate_async(params, batch)
        self._mark("accumulate")
        return {"g_acc": g_acc, "pending": pending}, \
            self._xstep_metrics(ce, gnorm)

    def flush(self, params, opt_state, carry: Carry) -> Dict[str, float]:
        """Drain the pipeline: finalize ``carry`` (emptied here) with no
        forward. Returns the last step's grad norm."""
        self._need(True)
        self._begin()
        train, _ = self.bundle.split(params)
        gnorm = self.apply_grads(
            train, self.fold(carry.pop("g_acc"), carry.pop("pending")),
            opt_state)
        self._mark("apply")
        self.primed = False
        return self._metrics({"grad_norm": gnorm})


# -- the carry's global layout (the checkpoint's carry section) ---------------

def _stage1_storage_spec(spec, pdef, plan) -> tuple:
    """The storage spec of a leaf's stage-1-level view: the inter (DCN)
    axes stripped from the fsdp entry; the spec itself for a leaf with
    no stage 1."""
    if pdef.fsdp_dim is None or not (plan.is_gathered and plan.inter_axes):
        return tuple(spec)
    entries = list(spec) + [None] * (len(pdef.shape) - len(spec))
    axes = tuple(a for a in _entry_axes(entries[pdef.fsdp_dim])
                 if a not in plan.inter_axes)
    entries[pdef.fsdp_dim] = (axes if len(axes) > 1
                              else (axes[0] if axes else None))
    return tuple(entries)


def carried_layout(bundle):
    """The JAX package's global layout of the carry, per trainable leaf in
    tree order: ``{"g_acc": [(lead axes, payload spec, global shape,
    dtype), ...], "pending": [...]}``. A leaf's global array is its
    logical shape behind a leading 'partial' dim over every mesh axis
    the payload spec does not mention (tiled in mesh order), since the
    partials differ along those axes; this rank's carry tensor is one
    row of it. g_acc's payload is the storage spec, pending's the
    stage-1 storage spec."""
    ms = bundle.mesh_shape
    dtype = bundle.run.system.torch_dtype
    out = {"g_acc": [], "pending": []}
    for i in bundle.train_idx:
        d, plan = bundle.def_leaves[i], bundle.plan_leaves[i]
        spec = bundle.leaf_specs[i]
        for key, base in (("g_acc", tuple(spec)),
                          ("pending", _stage1_storage_spec(spec, d, plan))):
            lead = tuple(a for a in ms.axis_names if a not in spec_axes(base))
            shape = (max(1, math.prod(ms.size(a) for a in lead)),) + d.shape
            out[key].append((lead, base, shape, dtype))
    return out


def cross_step_carry_signature(bundle):
    """``[(global_shape, dtype_str), ...]`` of the carry leaves in
    checkpoint flatten order (g_acc before pending), as the JAX
    package's function gives them: what ``runtime/elastic.reshard_state``
    compares with a saved manifest's carry section. The leading partial
    dim is mesh-shaped, so a mesh change shows here even when the
    payload shapes agree."""
    layout = carried_layout(bundle)
    return [(tuple(shape), str(dtype).removeprefix("torch."))
            for key in sorted(layout)
            for _, _, shape, dtype in layout[key]]


def carry_bytes(carry: Carry) -> int:
    """The bytes of this rank's carry tensors."""
    return sum(t.numel() * t.element_size()
               for ts in carry.values() for t in ts)


def _grads(train) -> List[torch.Tensor]:
    """The trainable shards' gradients, taken off them: zeros for a leaf
    the loss does not read (an adapter beside a projection that consumes
    none, ``models/stack._unread``), as ``jax.grad`` gives."""
    out = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in train]
    for p in train:
        p.grad = None
    return out


def build_train_step(bundle, coll) -> TrainStep:
    return TrainStep(bundle, coll)


def _act_allreduces(bundle) -> int:
    """Tensor-parallel activation all-reduces carried in int8 per
    (micro)batch: under ``act_psum="int8"`` at tp > 1 each attention
    and MLP sublayer of each layer reduces its output in the forward
    (``int8_psum``) and its normed input's gradient in the backward
    (``int8_bwd_psum``), a Mamba sublayer its output only (the JAX mixer
    opens no int8 region: its input's gradient is summed exactly); the
    block_io and offload_acts activation policies run the forward's
    again in the recompute, all but the layer's last sublayer's
    (``models/common.CollectiveTape``; save_collectives keeps their
    outputs). Cross-attention's sum is never int8. Every stack of the
    model counts (an encoder-decoder's two)."""
    model = bundle.model
    sys = bundle.run.system
    if sys.act_psum != "int8" or model.tp == 1:
        return 0
    total = 0
    for _, plan, n_groups in model.stacks:
        kinds = [k for ks in plan for k in ks]
        fwd = [k in ("attn", "mlp", "mamba") for k in kinds]
        bwd = sum(k in ("attn", "mlp") for k in kinds)
        again = sum(fwd[:-1]) if sys.activation_policy in (
            "block_io", "offload_acts") else 0
        total += n_groups * (sum(fwd) + bwd + again)
    return total


def act_int8_launch_plan(bundle) -> Dict[str, int]:
    """How many times one step calls each int8 kernel in the activation
    all-reduces: each quantizes once, dequant-accumulates (and
    requantizes, in the same kernel) once and dequantizes once.
    Microbatches multiply."""
    n = _act_allreduces(bundle) * max(bundle.run.microbatch, 1)
    return {"quantize": n, "dequantize": n, "dequant_accumulate": n}


def int8_launch_plan(bundle) -> Dict[str, int]:
    """How many times one step calls each int8 kernel, from the plans:
    per stage-1 gather (once per layer for a stacked leaf), qwZ
    quantizes and dequantizes, and the backward's regather (zero3 at
    prefetch depth 0) does so again inside the layers; qgZ quantizes
    and dequant-accumulates once per gather's backward. Under the async
    reduce (stream 2) each trainable leaf with a stage 1 is gathered and
    reduced once, whole: once per leaf, not per layer, and nothing
    regathers. The activation all-reduces add theirs
    (``act_int8_launch_plan``). Microbatches multiply."""
    n = _act_allreduces(bundle)
    out = {"quantize": n, "dequantize": n, "dequant_accumulate": n}
    run = bundle.run
    leaf_level = async_reduce_enabled(run, bundle.strategy,
                                      bundle.mesh_shape)
    ring = GatherScheduler(bundle.strategy, run.system, bundle.mesh_shape,
                           bundle.plan_leaves).depth > 0
    for i in bundle.train_idx:
        d, plan = bundle.def_leaves[i], bundle.plan_leaves[i]
        res = plan.residency
        layered = "stack" in d.dims and not leaf_level
        uses = d.shape[d.dims.index("stack")] if layered else 1
        # the backward regathers (zero3) unless the ring fed the layer
        passes = 1 + (layered and res.cache == "regather"
                      and not (ring and res.occupies_ring_slot))
        if res.quantized_gather:
            out["quantize"] += uses * passes
            out["dequantize"] += uses * passes
        if res.quantized_reduce:
            out["quantize"] += uses
            out["dequant_accumulate"] += uses
    nm = max(run.microbatch, 1)
    return {k: v * nm for k, v in out.items()}


def matmul_chunk_launch_plan(bundle) -> int:
    """How many times one step calls the fused ring's chunk matmul, from
    the plans: per fused leaf and use (once per layer for a stacked
    leaf), n chunks in the forward ring over its axis of n ranks, n
    more where the activation policy's recompute reads the ring's
    product (``models/common.CollectiveTape.reads``: block_io and
    offload_acts, and save_collectives at tp 1, for every sublayer's
    output projection but the layer's last; under every recomputing
    policy for the channel-mix's ``w_v``, whose product the gate's
    gradient reads), and under 'both' n more in the dx ring and n in
    the dw ring; the layer's last sublayer is taken in each stack of the
    model. Microbatches multiply."""
    model, pol = bundle.model, bundle.run.system.activation_policy
    again = pol in ("block_io", "offload_acts") or (
        pol == "save_collectives" and model.tp == 1)
    last = tuple(f"{name}.pos{len(plan) - 1}.{plan[-1][-1]}."
                 for name, plan, _ in model.stacks)
    out = 0
    for i in bundle.train_idx:
        d, plan = bundle.def_leaves[i], bundle.plan_leaves[i]
        if not plan.is_fused:
            continue
        uses = d.shape[d.dims.index("stack")] if "stack" in d.dims else 1
        n = bundle.mesh_shape.size(plan.intra_axes[0])
        path = bundle.paths[i]
        if ".rwkv_cm." in path:
            rings = 1 + (pol != "save_all")
        else:
            rings = 1 + (again and not path.startswith(last))
        out += uses * n * (rings + (2 if plan.fused == "both" else 0))
    return out * max(bundle.run.microbatch, 1)


def mamba_scan_launch_plan(bundle) -> int:
    """How many times one step calls the Mamba scan
    (``ops.mamba_scan_train``): per Mamba sublayer of each layer once in
    the forward and once, the adjoint, in the backward, and once more
    where the activation policy recomputes the layer (its forward ran
    without autograd). Microbatches multiply."""
    n = sum(n_groups * sum(k == "mamba" for ks in plan for k in ks)
            for _, plan, n_groups in bundle.model.stacks)
    per = 2 + (bundle.run.system.activation_policy != "save_all")
    return n * per * max(bundle.run.microbatch, 1)
