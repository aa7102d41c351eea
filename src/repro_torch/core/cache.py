"""FCDP-Cache: the memory accounting and the planner (the paper's tau
knob), as the JAX package's ``core/cache.py`` defines them.

The analytic functions read the plan tree alone and equal the JAX
package's to the byte: ``stage1_dcn_gather_bytes`` (the 'pod' wire bytes
of one forward's stage-1 gathers, int8 under qwZ) and
``cache_bytes_per_chip`` (the cache tier, the ring, async and carry
buffers and the paged KV pools, per strategy group). As in the JAX
package, a group's placement comes from its residency alone: the
device-cache fraction is not read, so at fraction 1.0 fcdp's promoted
caches still count as host bytes. ``ParamGather.cached``
(``core/fcdp.py``) reports the tier each cache really lands on.

``MemoryPlanner`` searches for the fastest configuration whose step
fits ``hbm_budget`` bytes of device memory (by default all the card
reports, ``torch.cuda.get_device_properties(device).total_memory``)
and ``host_budget`` bytes of analytic host cache: the cross-step
pipeline is demoted first, then the prefetch depth k -> 0, then the
device fraction high -> low, then the block_io activation fallback;
the serve search demotes the depth, then the fraction, then the paged
KV pool. Where the JAX package
compiles the step and reads ``memory_analysis()``, the port runs one
trial step on the card and reads ``torch.cuda.max_memory_allocated``
(``_peak``, ``_peak_serve``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.core.schedule import (GatherScheduler,
                                       async_buffer_bytes_by_group,
                                       async_reduce_enabled,
                                       cross_step_buffer_bytes_by_group,
                                       cross_step_enabled,
                                       prefetch_buffer_bytes_by_group)
from repro_torch.core.strategy import (QUANT_MIN_SHARD_ELEMS, GatherPlan,
                                       leaf_group)

QUANT_BLOCK = QUANT_MIN_SHARD_ELEMS   # == kernels/quant.py BLOCK
_BF16_BYTES = 2.0
# int8 wire cost per padded quant block: BLOCK int8 payload + one f32 scale
_INT8_BLOCK_BYTES = float(QUANT_BLOCK + 4)


def _stage1_leaf_wire_bytes(pdef, plan: GatherPlan, mesh,
                            quantized: bool) -> float:
    """Per-rank 'pod' wire bytes of one forward stage-1 all-gather of
    this leaf: a ring all-gather moves (n-1)/n of the gathered payload.
    Under qwZ int8 blocks and fp32 scales, blocked per layer slice as
    the sequential schedule quantizes them (``quantized``: the plan's
    qwZ); bf16 otherwise, whatever the def's dtype (the JAX package's
    count)."""
    n = 1
    for a in plan.inter_axes:
        n *= mesh.size(a)
    if n <= 1:
        return 0.0
    degree = n
    for a in plan.intra_axes:
        degree *= mesh.size(a)
    if pdef.tp_dim is not None:     # the leaf is 'model'-sharded too
        degree *= mesh.size("model")
    shard_elems = pdef.size() // degree
    if quantized:
        stack = (pdef.shape[pdef.dims.index("stack")]
                 if "stack" in pdef.dims else 1)
        slice_elems = shard_elems // stack
        blocks = stack * (-(-slice_elems // QUANT_BLOCK))
        shard_bytes = blocks * _INT8_BLOCK_BYTES
    else:
        shard_bytes = shard_elems * _BF16_BYTES
    return (n - 1) / n * n * shard_bytes


def stage1_dcn_gather_bytes(bundle) -> Dict[str, float]:
    """Per-rank stage-1 ('pod') all-gather wire bytes of one forward,
    honouring qwZ (``SystemConfig.param_compress``), from the plan tree
    alone; ``exact`` is the bf16 counterfactual."""
    by_group: Dict[str, float] = {}
    exact = 0.0
    for d, p in zip(bundle.def_leaves, bundle.plan_leaves):
        if not isinstance(p, GatherPlan) or not p.inter_axes:
            continue
        g = leaf_group(bundle.strategy, d)
        by_group[g] = by_group.get(g, 0.0) + _stage1_leaf_wire_bytes(
            d, p, bundle.mesh_shape, p.residency.quantized_gather)
        exact += _stage1_leaf_wire_bytes(d, p, bundle.mesh_shape, False)
    return {"stage1_dcn_gather_bytes_per_chip": sum(by_group.values()),
            "stage1_dcn_gather_bytes_exact": exact,
            "by_group": by_group}


def cache_bytes_per_chip(bundle, kv=None) -> Dict[str, float]:
    """Analytic per-rank size of the cache tier, split by strategy
    group, with the JAX package's keys.

    With a stage 1 the cache is the stage-1 shard; without one (one
    pod, a frozen leaf in fcdp's cached layout) the gathered
    'model'-local weight. ``by_group`` maps each group to its cache
    bytes, placement (its residency's tier), leaf count and its share of
    the ring, async and carry buffers and of the stage-1 wire bytes;
    the flat totals sum the groups. ``host_cache_bytes_per_chip`` counts
    the host-placed groups only. The ring (k slots at the depth the
    scheduler resolves), the async buffers (when stream 2 is live) and
    the cross-step carry (when stream 3 is live) live on the device.
    ``kv`` (a ``core.kv_cache.PagedKVConfig``) adds the paged KV pools;
    ``kv_page_bytes_per_chip`` is 0.0 without one."""
    ms = bundle.mesh_shape
    strategy = bundle.strategy
    defs, plans = bundle.def_leaves, bundle.plan_leaves
    by_group: Dict[str, Dict[str, float]] = {}
    for d, p in zip(defs, plans):
        if not isinstance(p, GatherPlan):
            continue
        g = leaf_group(strategy, d)
        gb = by_group.setdefault(
            g, {"cached_bytes_per_chip": 0.0,
                # a group resolves to one strategy: one tier for its leaves
                "placement": p.residency.cache,
                "n_leaves": 0,
                "prefetch_buffer_bytes_per_chip": 0.0,
                "async_buffer_bytes_per_chip": 0.0,
                "cross_step_buffer_bytes_per_chip": 0.0,
                "stage1_dcn_gather_bytes_per_chip": 0.0})
        gb["cached_bytes_per_chip"] += strategy.cached_bytes_for(d, p, ms)
        gb["n_leaves"] += 1
    depth = GatherScheduler(strategy, bundle.run.system, ms, plans).depth
    for g, b in prefetch_buffer_bytes_by_group(
            strategy, defs, plans, ms, depth).items():
        by_group[g]["prefetch_buffer_bytes_per_chip"] = b
    if async_reduce_enabled(bundle.run, strategy, ms):
        for g, b in async_buffer_bytes_by_group(
                strategy, defs, plans, ms).items():
            by_group[g]["async_buffer_bytes_per_chip"] = b
    xstep = cross_step_enabled(bundle.run, strategy, ms)
    if xstep:
        for g, b in cross_step_buffer_bytes_by_group(
                strategy, defs, plans, ms).items():
            by_group[g]["cross_step_buffer_bytes_per_chip"] = b
    dcn = stage1_dcn_gather_bytes(bundle)
    for g, b in dcn["by_group"].items():
        if g in by_group:
            by_group[g]["stage1_dcn_gather_bytes_per_chip"] = b
    kv_bytes = 0.0
    if kv is not None:
        from repro_torch.core.kv_cache import kv_page_bytes_per_chip
        model = bundle.model
        # an encoder-decoder has no paged stack, as in the JAX package
        kv_bytes = kv_page_bytes_per_chip(
            bundle.run.model, ms, getattr(model, "plan", ()),
            getattr(model, "n_groups", 0), kv)

    def total(key):
        return sum(gb[key] for gb in by_group.values())
    return {"host_cache_bytes_per_chip": sum(
                gb["cached_bytes_per_chip"] for gb in by_group.values()
                if gb["placement"] == "host"),
            "kv_page_bytes_per_chip": kv_bytes,
            "param_compress": bundle.run.system.param_compress,
            "stage1_dcn_gather_bytes_per_chip": dcn[
                "stage1_dcn_gather_bytes_per_chip"],
            "stage1_dcn_gather_bytes_exact": dcn[
                "stage1_dcn_gather_bytes_exact"],
            "cached_bytes_per_chip": total("cached_bytes_per_chip"),
            "prefetch_depth": depth,
            "prefetch_buffer_bytes_per_chip": total(
                "prefetch_buffer_bytes_per_chip"),
            "async_buffer_bytes_per_chip": total(
                "async_buffer_bytes_per_chip"),
            "cross_step": xstep,
            "cross_step_buffer_bytes_per_chip": total(
                "cross_step_buffer_bytes_per_chip"),
            "by_group": by_group}


@dataclass
class CachePlan:
    """The planner's choice: the device fraction (``SystemConfig.
    device_cache_fraction``), whether it fits, its peak and analytic host
    bytes, every attempt (``iterations``), and the activation policy,
    prefetch depth, cross-step flag and paged-KV pool (serve; None for
    train plans) it chose."""
    device_fraction: float
    fits: bool
    peak_bytes: int
    host_bytes: float
    iterations: List[Dict]
    # differs from the run's own policy only when the block_io fallback
    # fired
    activation_policy: str = "save_all"
    prefetch_depth: int = 0
    cross_step: bool = False
    kv_pages: Optional[int] = None


class MemoryPlanner:
    """Tau search over (cross-step, prefetch depth, device fraction,
    activation policy) for a train run, and over (depth, fraction, KV
    pool) for a paged serve run. ``coll`` is the rank's
    ``core.collectives.Collectives`` (a train attempt runs one step on
    every rank), ``device`` the bundles' device, ``seed`` the weights and
    batch an attempt draws. ``trials`` keeps what each train attempt's
    trial step measured on this rank: its memory by part
    (``TrainStep.memory``: peak and live bytes), its metrics, the bytes
    its caches took by tier (``ParamGather.cached``) and its wire bytes
    per (op, axis). ``hbm_budget`` defaults to the card's memory on a
    CUDA ``device`` and is required on any other."""

    def __init__(self, hbm_budget: Optional[int] = None,
                 host_budget: Optional[int] = None, coll=None,
                 device=None, seed: int = 0):
        if hbm_budget is None:
            dev = torch.device(device) if device is not None else None
            if dev is None or dev.type != "cuda":
                raise ValueError("hbm_budget is required off a CUDA device")
            hbm_budget = torch.cuda.get_device_properties(dev).total_memory
        self.hbm = hbm_budget
        self.host = host_budget
        self.coll, self.device, self.seed = coll, device, seed
        self.trials: List[Dict] = []

    def _bundle(self, run, mesh):
        from repro_torch.core.engine import StepBundle
        return StepBundle(run, device=self.device, mesh=mesh)

    @staticmethod
    def _fresh(dev: torch.device) -> int:
        """Empty the allocator's cache, reset the peak; the bytes still
        allocated (the caller's own state), which a peak is read
        above."""
        if dev.type != "cuda":
            raise RuntimeError(
                "MemoryPlanner reads the CUDA allocator's peak, and a CPU "
                "tensor has none; on the CPU give the planner its own "
                "_peak")
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)

    def _peak(self, bundle) -> int:
        """The device bytes one fused train step of ``bundle`` takes at
        its peak, the optimizer epilogue included: a trial step on state
        built from ``seed`` (weights, optimizer state, one batch), read
        from ``torch.cuda.max_memory_allocated`` during the step, less
        what was allocated before the state was built (the state counts,
        as the JAX package's argument bytes do), freed afterwards.
        Device memory only: the pinned host caches are not in it, nor,
        under gloo, the in-flight ring slots, which wait in host memory
        (the host budget is held against the analytic ``host_bytes``). Every rank takes the
        largest peak over the ranks, so all walk the same attempts; the
        byte counters of ``coll`` are left as they were."""
        from repro_torch.data.pipeline import (DataConfig, ShardedLoader,
                                               SyntheticPackedLM,
                                               enc_embed_dim)
        from repro_torch.optim.adamw import init_opt_state
        dev = bundle.device
        base = self._fresh(dev)
        coll = self.coll
        counts = dict(coll.counts)
        params = bundle.init_all_params(self.seed)
        train, _ = bundle.split(params)
        opt = init_opt_state(bundle.opt_shards(train), bundle.run.system)
        step = bundle.make_train_step(coll)
        run = bundle.run
        batch = ShardedLoader(SyntheticPackedLM(
            run.model, run.shape, DataConfig(self.seed)), bundle,
            enc_embed_dim(run.model)).get(0)
        # the state counts, its drawing's transients do not
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        metrics = step(params, opt, batch)
        torch.cuda.synchronize(dev)
        peak = max([torch.cuda.max_memory_allocated(dev)]
                   + [p for p, _ in step.memory.values()]) - base
        self.trials.append({
            "memory": dict(step.memory), "metrics": metrics,
            "cached": dict(step.gather.cached),
            "bytes": {k: v - counts.get(k, 0.0)
                      for k, v in coll.counts.items()
                      if v != counts.get(k, 0.0)}})
        del params, train, opt, step, batch
        self._fresh(dev)
        coll.counts.clear()
        coll.counts.update(counts)
        return int(coll.all_reduce_max(
            torch.tensor([float(peak)], dtype=torch.float64, device=dev),
            tuple(coll.mesh.mesh_shape.axis_names)).item())

    def _attempt(self, run, mesh, sysc, iters) -> Dict:
        bundle = self._bundle(run.replace(system=sysc), mesh)
        peak = self._peak(bundle)
        acct = cache_bytes_per_chip(bundle)
        it = {"device_fraction": sysc.device_cache_fraction,
              "activation_policy": sysc.activation_policy,
              "prefetch_depth": acct["prefetch_depth"],
              "prefetch_buffer_bytes": acct[
                  "prefetch_buffer_bytes_per_chip"],
              "async_buffer_bytes": acct["async_buffer_bytes_per_chip"],
              "cross_step": acct["cross_step"],
              "cross_step_buffer_bytes": acct[
                  "cross_step_buffer_bytes_per_chip"],
              "peak_bytes": peak, "host_bytes": acct[
                  "host_cache_bytes_per_chip"],
              "param_compress": acct["param_compress"],
              "stage1_dcn_gather_bytes": acct[
                  "stage1_dcn_gather_bytes_per_chip"],
              "by_group": acct["by_group"]}
        iters.append(it)
        return it

    def _fits(self, it: Dict) -> bool:
        return (it["peak_bytes"] <= self.hbm
                and (self.host is None or it["host_bytes"] <= self.host))

    def plan(self, run, mesh, fractions=(1.0, 0.5, 0.25, 0.0)) -> CachePlan:
        """Demote until the step fits, in the JAX package's order: the
        cross-step pipeline first (its carry), then the prefetch depth
        k -> 0 at the first fraction (one ring slot a step), then the
        device fractions high -> low, then the block_io activation
        fallback at fraction 0, depth 0; then report the last attempt as
        not fitting. ``mesh``: a ``MeshShape``, or this rank's live
        ``RankMesh`` when the attempts run steps."""
        probe = self._bundle(run, mesh)
        k0 = probe.strategy.prefetch_depth(run.system, probe.mesh_shape)
        x0 = cross_step_enabled(run, probe.strategy, probe.mesh_shape)
        attempts = ([(fractions[0], k0, True)] if x0 else []) \
            + [(fractions[0], d, False) for d in range(k0, 0, -1)] \
            + [(f, 0, False) for f in fractions]
        iters: List[Dict] = []
        for frac, depth, xs in attempts:
            sysc = dataclasses.replace(
                run.system, device_cache_fraction=frac,
                prefetch_depth=depth, cross_step_pipeline=xs)
            it = self._attempt(run, mesh, sysc, iters)
            if self._fits(it):
                return CachePlan(frac, True, it["peak_bytes"],
                                 it["host_bytes"], iters,
                                 activation_policy=sysc.activation_policy,
                                 prefetch_depth=it["prefetch_depth"],
                                 cross_step=it["cross_step"])
        # every cache demoted and still over budget: trade compute for
        # memory (full activation recompute) before giving up
        if run.system.activation_policy != "block_io":
            sysc = dataclasses.replace(
                run.system, device_cache_fraction=0.0, prefetch_depth=0,
                cross_step_pipeline=False, activation_policy="block_io")
            it = self._attempt(run, mesh, sysc, iters)
            if self._fits(it):
                return CachePlan(0.0, True, it["peak_bytes"],
                                 it["host_bytes"], iters,
                                 activation_policy="block_io")
        last = iters[-1]
        return CachePlan(0.0, False, last["peak_bytes"], last["host_bytes"],
                         iters, activation_policy=last["activation_policy"])

    # -- serve planning (the paged KV pool; core/kv_cache.py) ----------------
    def _peak_serve(self, bundle, kv) -> int:
        """The device bytes one paged decode step takes at its peak, its
        state included: whole weights drawn from ``seed`` on one rank
        (serving runs on one card) and the pools of ``kv``, a batch of
        the run's cell at position 0, freed afterwards. Device memory
        only."""
        from repro_torch.core.engine import StepBundle
        dev = bundle.device
        base = self._fresh(dev)
        one = StepBundle(bundle.run, device=dev)
        params = one.init_all_params(self.seed)
        pools = one.init_paged_state(kv)
        rows = bundle.run.shape.global_batch
        table = (1 + torch.arange(rows * kv.max_pages_per_seq, device=dev)
                 ).reshape(rows, -1) % kv.pages_per_replica
        tok = torch.ones((rows, 1), dtype=torch.long, device=dev)
        lengths = torch.zeros(rows, dtype=torch.long, device=dev)
        # the state counts, its drawing's transients do not
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        one.make_paged_decode_step(kv)(params, tok, table.int(), lengths,
                                       pools)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del params, pools, table, tok, lengths
        self._fresh(dev)
        return int(peak)

    def _attempt_serve(self, run, mesh, sysc, kv, iters) -> Dict:
        bundle = self._bundle(run.replace(system=sysc), mesh)
        peak = self._peak_serve(bundle, kv)
        acct = cache_bytes_per_chip(bundle, kv=kv)
        it = {"device_fraction": sysc.device_cache_fraction,
              "activation_policy": sysc.activation_policy,
              "prefetch_depth": acct["prefetch_depth"],
              "prefetch_buffer_bytes": acct[
                  "prefetch_buffer_bytes_per_chip"],
              "kv_pages": kv.pages_per_replica,
              "kv_page_bytes": acct["kv_page_bytes_per_chip"],
              "peak_bytes": peak,
              "host_bytes": acct["host_cache_bytes_per_chip"],
              "param_compress": acct["param_compress"],
              "by_group": acct["by_group"]}
        iters.append(it)
        return it

    def plan_serve(self, run, mesh, kv,
                   fractions=(1.0, 0.5, 0.25, 0.0)) -> CachePlan:
        """Tau search for the paged serve path, in the JAX package's
        order: the prefetch depth k -> 0, the device fraction high ->
        low, then the paged-KV pool halved down to one max-length
        sequence and the scratch page (a throughput knob, never the
        numerics), last. ``mesh`` is the layout the accounting reads
        (a ``MeshShape``); the decode step runs on one card."""
        probe = self._bundle(run, mesh)
        k0 = probe.strategy.prefetch_depth(run.system, probe.mesh_shape)
        attempts = [(fractions[0], d) for d in range(k0, 0, -1)] \
            + [(f, 0) for f in fractions]
        iters: List[Dict] = []
        for frac, depth in attempts:
            sysc = dataclasses.replace(run.system,
                                       device_cache_fraction=frac,
                                       prefetch_depth=depth)
            it = self._attempt_serve(run, mesh, sysc, kv, iters)
            if self._fits(it):
                return CachePlan(frac, True, it["peak_bytes"],
                                 it["host_bytes"], iters,
                                 prefetch_depth=it["prefetch_depth"],
                                 kv_pages=kv.pages_per_replica)
        floor = 1 + kv.max_pages_per_seq
        cur = kv
        sysc = dataclasses.replace(run.system,
                                   device_cache_fraction=fractions[-1],
                                   prefetch_depth=0)
        while cur.pages_per_replica > floor:
            cur = dataclasses.replace(
                cur, pages_per_replica=max(
                    floor, (cur.pages_per_replica + 1) // 2))
            it = self._attempt_serve(run, mesh, sysc, cur, iters)
            if self._fits(it):
                return CachePlan(fractions[-1], True, it["peak_bytes"],
                                 it["host_bytes"], iters,
                                 kv_pages=cur.pages_per_replica)
        last = iters[-1]
        return CachePlan(0.0, False, last["peak_bytes"],
                         last["host_bytes"], iters,
                         kv_pages=cur.pages_per_replica)
