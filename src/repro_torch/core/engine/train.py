"""The FCDP train step of one rank, as the JAX package's
``core/engine/train.py`` builds it (``_build_parts``' ``accumulate_seq``
and ``apply_grads``, ``_build_fused``) without the async and cross-step
streams.

One step: the loss over this rank's batch rows (the forward gathers
every weight through its plan, the layers under the stage-1 prefetch
ring at ``SystemConfig.prefetch_depth``, ``core/schedule.py``), its
backward (the gathers' backwards reduce-scatter the gradients onto the
shards), the loss terms summed over the data-parallel axes, then the
optimizer epilogue: the widening reduce-scatter of each widened leaf's
gradient (hier, an 'inter_only' leaf: over the axes its optimizer state
shards over beyond its storage, which sums it there once), global-norm
clip, AdamW on the optimizer layout's blocks, and the updated blocks
gathered back over the widening axes. Under PEFT only the trainable
leaves (the adapters) get gradients, a clip norm term and optimizer
state; the frozen trunk is read, never updated. With
``RunConfig.microbatch`` = nm >= 2 the rank's rows are split into nm
microbatches whose gradients add up in the parameter dtype and are
divided by nm, as the JAX scan does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.fcdp import ParamGather
from repro_torch.core.schedule import GatherScheduler
from repro_torch.launch.mesh import fsdp_axes
from repro_torch.optim.adamw import adamw_update, clip_by_global_norm


class TrainStep:
    """``step(params, opt_state, batch) -> metrics``: updates this rank's
    shards and optimizer state in place. metrics: loss, aux_loss,
    grad_norm, tokens (Python floats; with microbatches ``tokens`` is 1,
    as in the JAX step). ``gather`` keeps the cache bytes and places of
    the last step, ``gather.scheduler`` its ring's live depth and
    bytes."""

    def __init__(self, bundle, coll):
        run = bundle.run
        self.bundle, self.coll = bundle, coll
        self.model = bundle.model
        self.sys, self.opt_cfg = run.system, run.optimizer
        self.nm = run.microbatch or 0
        self.gather = ParamGather(coll, bundle.plans, GatherScheduler(
            bundle.strategy, self.sys, bundle.mesh_shape,
            bundle.plan_leaves))
        self.widen = bundle.widen
        defs = [bundle.def_leaves[i] for i in bundle.train_idx]
        # no weight decay on vectors and on the LoRA adapters
        self.wd_mask = [len(d.shape) >= 2 and "_lora_" not in d.label
                        for d in defs]
        self.reps = [bundle.rep_factors[i] for i in bundle.train_idx]
        self.dp_axes = fsdp_axes(bundle.mesh_shape)

    def _loss_backward(self, params, batch, report_aux: bool = True):
        """Forward and backward of one (micro)batch; returns the global
        (ce, aux, tokens) as 0-dim tensors. The terms are summed over
        the data-parallel axes; the aux sum only where it is reported
        (not per microbatch, where the JAX step drops it)."""
        ls, cnt, aux = self.model.loss_fn(params, batch, self.gather,
                                          self.bundle.defs)
        terms = [ls.detach(), cnt.detach()] + ([aux.detach()]
                                               if report_aux else [])
        tot = self.coll.all_reduce(torch.stack(terms), self.dp_axes)
        denom = torch.clamp(tot[1], min=1.0)
        ((ls + aux) / denom).backward()
        return (tot[0] / denom, tot[2] / denom if report_aux else None,
                tot[1])

    def __call__(self, params, opt_state, batch: Dict) -> Dict[str, float]:
        self.gather.cached.clear()
        self.gather.cache_places.clear()
        train, _ = self.bundle.split(params)
        for p in train:
            p.grad = None
        if self.nm > 1:
            rows = batch["ids"].shape[0]
            if rows % self.nm:
                raise ValueError(f"{rows} rows do not split into "
                                 f"{self.nm} microbatches")
            b = rows // self.nm
            ce = 0.0
            for i in range(self.nm):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                ce = ce + self._loss_backward(params, mb, False)[0]
            grads = [p.grad / self.nm for p in train]
            ce, aux, tokens = ce / self.nm, 0.0, 1.0
        else:
            ce, aux, tokens = self._loss_backward(params, batch)
            grads = [p.grad for p in train]
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
        for p in train:
            p.grad = None
        return {"loss": float(ce), "aux_loss": float(aux),
                "grad_norm": float(gnorm), "tokens": float(tokens)}


def build_train_step(bundle, coll) -> TrainStep:
    return TrainStep(bundle, coll)


def _act_allreduces(bundle) -> int:
    """Tensor-parallel activation all-reduces carried in int8 per
    (micro)batch: under ``act_psum="int8"`` at tp > 1 each attention
    and MLP sublayer of each layer reduces its output in the forward
    (``int8_psum``) and its normed input's gradient in the backward
    (``int8_bwd_psum``)."""
    model = bundle.model
    if bundle.run.system.act_psum != "int8" or model.tp == 1:
        return 0
    return 2 * model.n_groups * sum(k in ("attn", "mlp")
                                    for kinds in model.plan for k in kinds)


def act_int8_launch_plan(bundle) -> Dict[str, int]:
    """How many times one step calls each int8 kernel in the activation
    all-reduces: each quantizes twice, dequant-accumulates once and
    dequantizes once. Microbatches multiply."""
    n = _act_allreduces(bundle) * max(bundle.run.microbatch, 1)
    return {"quantize": 2 * n, "dequantize": n, "dequant_accumulate": n}


def int8_launch_plan(bundle) -> Dict[str, int]:
    """How many times one step calls each int8 kernel, from the plans:
    per stage-1 gather (once per layer for a stacked leaf), qwZ
    quantizes and dequantizes, and the backward's regather (zero3 at
    prefetch depth 0) does so again inside the layers; qgZ quantizes
    and dequant-accumulates once per gather's backward; the activation
    all-reduces add theirs
    (``act_int8_launch_plan``). Microbatches multiply."""
    n = _act_allreduces(bundle)
    out = {"quantize": 2 * n, "dequantize": n, "dequant_accumulate": n}
    ring = GatherScheduler(bundle.strategy, bundle.run.system,
                           bundle.mesh_shape, bundle.plan_leaves).depth > 0
    for i in bundle.train_idx:
        d, plan = bundle.def_leaves[i], bundle.plan_leaves[i]
        res = plan.residency
        layered = "stack" in d.dims
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
    nm = max(bundle.run.microbatch, 1)
    return {k: v * nm for k, v in out.items()}


def matmul_chunk_launch_plan(bundle) -> int:
    """How many times one step calls the fused ring's chunk matmul, from
    the plans: per fused leaf and use (once per layer for a stacked
    leaf), n chunks in the forward ring over its axis of n ranks, and
    under 'both' n more in the dx ring and n in the dw ring. Microbatches
    multiply."""
    out = 0
    for i in bundle.train_idx:
        d, plan = bundle.def_leaves[i], bundle.plan_leaves[i]
        if not plan.is_fused:
            continue
        uses = d.shape[d.dims.index("stack")] if "stack" in d.dims else 1
        n = bundle.mesh_shape.size(plan.intra_axes[0])
        out += uses * n * (3 if plan.fused == "both" else 1)
    return out * max(bundle.run.microbatch, 1)
