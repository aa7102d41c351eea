"""Sharding strategies: each system mode as one object, as the JAX
package's ``core/strategy.py`` defines them.

A ``ShardingStrategy`` owns every decision a mode makes about a leaf:

  storage layout   which mesh axes the fsdp dim shards over
  gather plan      the two-stage reconstruction (stage 1 over the inter
                   'pod' axis, stage 2 over the intra axes) and the
                   cache boundary
  cache placement  where the stage-1 result waits for the backward:
                   'regather' | 'device' | 'host'
  fused matmul     whether an output projection's stage-2 gather is
                   consumed by the gather-fused collective matmul
                   (``SystemConfig.fused_matmul``), leaf by leaf
  opt layout       the optimizer state's sharding

The built-ins are the paper's comparison set and one related-work
extension:

  zero3   full ('data', 'pod') sharding, regather fwd + bwd   (baseline)
  zeropp  full sharding, stage-1 result cached on the device  (ZeRO++)
  fcdp    full sharding, stage-1 result cached in pinned host
          memory                                              (the paper)
  mics    pod-replicated ('data',) sharding; no stage 1       (MiCS)
  hier    mics's parameters, the optimizer state and master
          weights sharded over ('data', 'pod'): the gradient is
          reduce-scattered over 'pod' before the update and the
          updated shard gathered back once a step        (Xu et al.)

Plans are derived from the mesh's axis names and sizes
(``launch.mesh.MeshShape``), never from a process group. Frozen leaves
(PEFT) get a non-trainable update class: fcdp stores them in its frozen
cached layout (pod-replicated, over the intra axes only: FCDP-Comm),
the other modes in their own layout; none of them quantizes or fuses a
frozen leaf.

Resolution is per leaf (``resolve_strategies``): a leaf's
``ParamDef.strategy`` tag wins, else the first ``SystemConfig.
mode_overrides`` rule whose glob matches its dotted path, else
``SystemConfig.mode``. A uniform assignment gives back the plain
singleton; a mixed one a ``CompositeStrategy`` that hands every
per-leaf decision to the leaf's own strategy.

A leaf whose ``ParamDef.fsdp_scope`` is 'inter_only' shards over 'pod'
only; its optimizer state is widened to every fsdp axis as hier's is.
A widened leaf's gradient is summed over its widening axes once, by
the engine's reduce-scatter (``GatherPlan.sync_axes`` leaves them out).
The JAX package sums it twice there (its varying-axes typing inserts
the sum, then the reduce-scatter sums again): hier's grad norm is
twice zero3's. The port does not copy that.

Stream capability: ``max_prefetch_depth`` caps the stage-1 prefetch ring
(``core/schedule.py``); it is 0 where stage 1 is structurally empty
(mics, hier). ``supports_async_grad_reduce`` and ``supports_cross_step``
say whether the async 'pod' gradient reduce (stream 2) and the
cross-step optimizer epilogue (stream 3) apply; mics and hier decline
both, and a composite accepts them when any of its groups streams (the
carried epilogue then covers every group's widened collectives). The
gates ``async_grad_reduce_active`` / ``cross_step_active`` also need the
flag and a 'pod' axis of size > 1.

FCDP-Cache: ``supports_device_cache`` says whether the device-cache
fraction applies (fcdp only; a composite when any group does), and
``device_cache_groups`` how many leading layer groups keep their caches
on the device at a fraction.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Type, Union

from repro_torch.core.residency import ParamResidency, update_class
from repro_torch.launch.mesh import fsdp_axes, intra_fsdp_axes

INTER_AXIS = "pod"     # the slow mesh axis name

# Minimum per-slice shard elements for the int8 stage-1 transports
# (qwZ/qgZ): below one quant block (kernels/quant.py BLOCK) the padding
# and the fp32 scale cost more wire bytes than bf16, so such leaves keep
# the exact path.
QUANT_MIN_SHARD_ELEMS = 256


@dataclass(frozen=True)
class GatherPlan:
    """The two-stage gather of one leaf: a view of its ParamResidency
    (the one source of its stages, cache tier and qwZ/qgZ gates), plus
    ``sync_axes``, the data-parallel mesh axes of size > 1 the leaf's
    storage is replicated over. Its gradient is summed over them, where
    the JAX package's varying-axes type system inserts that sum. 'model'
    is never among them: whether a leaf replicated over 'model' sums its
    gradient there depends on the values it meets, which the model code
    decides (``models/sublayers.model_summed``)."""
    residency: ParamResidency
    sync_axes: Tuple[str, ...] = ()

    @property
    def prefetchable(self) -> bool:
        """True when a stage 1 exists to issue a layer ahead."""
        return self.residency.occupies_ring_slot

    @property
    def fsdp_dim(self) -> Optional[int]:
        """Dim index in the per-layer view."""
        return self.residency.fsdp_dim

    @property
    def inter_axes(self) -> Tuple[str, ...]:
        """Stage-1 axes."""
        return self.residency.stage1_axes

    @property
    def intra_axes(self) -> Tuple[str, ...]:
        """Stage-2 axes."""
        return self.residency.stage2_axes

    @property
    def cache_after(self) -> int:
        """1 or 2: where the cache boundary sits."""
        return self.residency.cache_after

    @property
    def is_gathered(self) -> bool:
        return self.residency.is_gathered

    @property
    def fused(self) -> str:
        """'none' | 'ag_matmul' | 'both'."""
        return self.residency.fused

    @property
    def is_fused(self) -> bool:
        """True when the stage-2 gather is consumed by the fused ring."""
        return self.fused != "none"


def spec_axes(spec: Tuple) -> set:
    """Set of mesh axis names a spec shards over."""
    used: set = set()
    for e in spec:
        if e is not None:
            used.update((e,) if isinstance(e, str) else e)
    return used


class ShardingStrategy:
    """Base class owning everything a system mode decides. Subclasses
    override the class attributes (and, rarely, the layout methods)."""

    name: str = "base"
    # where the stage-1 result waits for the backward:
    # 'regather' (recompute both stages), 'device', 'host' (pinned)
    cache_placement: str = "regather"
    # frozen (FCDP-Comm) leaves are stored in the pod-replicated cached
    # layout
    frozen_cached_layout: bool = False
    # whether the stage-1 gather may carry int8 (qwZ); strategies with no
    # stage 1 decline structurally
    supports_quantized_gather: bool = True
    # whether eligible leaves may consume stage 2 through the gather-fused
    # collective matmul under SystemConfig.fused_matmul != 'none'; every
    # built-in opts in, a subclass may decline
    supports_fused_matmul: bool = True
    # how deep the stage-1 prefetch ring may run (0: stage 1 is
    # structurally empty, as for mics and hier)
    max_prefetch_depth: int = 8
    # whether the async 'pod' gradient reduce (stream 2) applies: it
    # needs a per-microbatch stage-1 reduce to move
    supports_async_grad_reduce: bool = True
    # whether the cross-step optimizer epilogue (stream 3) applies: it
    # carries the last microbatch's stage-1 reduce across the step
    supports_cross_step: bool = True
    # whether FCDP-Cache's device-cache fraction applies
    supports_device_cache: bool = False

    @property
    def supports_prefetch(self) -> bool:
        """Boolean view of ``max_prefetch_depth``."""
        return self.max_prefetch_depth > 0

    # -- storage layout -----------------------------------------------------
    def storage_fsdp_axes(self, mesh, frozen: bool) -> Tuple[str, ...]:
        """Mesh axes the fsdp dim shards over in storage: the
        pod-replicated cached layout for a frozen leaf under a strategy
        with ``frozen_cached_layout`` (FCDP-Comm), full ZeRO-3 sharding
        otherwise (the baselines rebuild a frozen trunk over 'pod' every
        step, as DeepSpeed does: that asymmetry is the paper's PEFT
        result)."""
        if frozen and self.frozen_cached_layout:
            return intra_fsdp_axes(mesh)
        return fsdp_axes(mesh)

    def effective_fsdp_axes(self, pdef, mesh) -> Tuple[str, ...]:
        axes = self.storage_fsdp_axes(mesh, pdef.frozen)
        if pdef.fsdp_scope == "inter_only":
            axes = tuple(a for a in axes if a == INTER_AXIS)
        return axes

    def _spec_with_axes(self, pdef, mesh, axes: Tuple[str, ...],
                        min_shard_size: int = 0) -> Tuple:
        entries: list = [None] * len(pdef.shape)
        small = pdef.size() < min_shard_size
        if pdef.tp_dim is not None:
            entries[pdef.tp_dim] = "model"
        if pdef.fsdp_dim is not None and not small and axes:
            degree = math.prod(mesh.shape[a] for a in axes)
            if pdef.shape[pdef.fsdp_dim] % degree == 0:
                entries[pdef.fsdp_dim] = axes if len(axes) > 1 else axes[0]
        return tuple(entries)

    def storage_spec(self, pdef, mesh, min_shard_size: int = 0) -> Tuple:
        return self._spec_with_axes(
            pdef, mesh, self.effective_fsdp_axes(pdef, mesh), min_shard_size)

    def opt_spec(self, pdef, mesh, min_shard_size: int = 0) -> Tuple:
        """Layout of the optimizer state and master weights: the leaf's
        layout with its fsdp scope widened to 'full'. Storage axes come
        first in the tiling order: the engine's widening reduce-scatter
        subdivides each storage block over the widening axes, so the
        storage-major spec assigns exactly that slice to the rank."""
        full = dataclasses.replace(pdef, fsdp_scope="full")
        storage = self.effective_fsdp_axes(pdef, mesh)
        target = self.effective_fsdp_axes(full, mesh)
        widened = storage + tuple(a for a in target if a not in storage)
        return self._spec_with_axes(full, mesh, widened, min_shard_size)

    # -- residency / gather schedule ----------------------------------------
    def residency(self, pdef, mesh, min_shard_size: int = 0,
                  compress_bwd: bool = False,
                  param_compress: bool = False,
                  fused_matmul: str = "none") -> ParamResidency:
        """The full lifecycle matching ``storage_spec``. A def with a
        'stack' dim gets the fsdp dim index of its per-layer view."""
        upd = update_class(pdef, self.frozen_cached_layout)
        d = pdef.fsdp_dim
        axes = self.effective_fsdp_axes(pdef, mesh)
        if d is None or pdef.size() < min_shard_size:
            return ParamResidency("replicated", self.cache_placement, upd)
        degree = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if not axes or pdef.shape[d] % degree != 0:
            return ParamResidency("replicated", self.cache_placement, upd)
        inter = tuple(a for a in axes if a == INTER_AXIS)
        intra = tuple(a for a in axes if a != INTER_AXIS)
        tier = "dcn_sharded" if inter else "pod_replicated"
        # cache boundary: after the inter stage if one exists, else after
        # the full gather (single-pod / pod-replicated storage)
        cache_after = 1 if inter else 2
        body_dim = d - 1 if ("stack" in pdef.dims and
                             pdef.dims.index("stack") < d) else d
        # frozen leaves stay exact; so do leaves whose per-slice shard is
        # smaller than one quant block: the padded block and scale would
        # cost more wire bytes than bf16
        stack = (pdef.shape[pdef.dims.index("stack")]
                 if "stack" in pdef.dims else 1)
        trainable = upd == "trainable"
        quantizable = (bool(inter) and trainable
                       and pdef.size() // (degree * stack)
                       >= QUANT_MIN_SHARD_ELEMS)
        # gather-fused collective matmul: the def opts in (an output
        # projection consumed through models/layers.matmul), its per-layer
        # body is a [K, N] matrix whose OUTPUT dim shards over exactly one
        # intra axis of degree > 1 (the column-concat split; K is never
        # split), and stage 2 runs per use: after a stage-1 cache
        # (cache_after 1) or as a regather. A cache_after-2 device or host
        # placement caches the fully gathered weight, so no per-use stage
        # 2 is left to fuse. A frozen leaf declines (it stays exact).
        body_rank = len(pdef.shape) - (1 if "stack" in pdef.dims else 0)
        intra_deg = math.prod(mesh.shape[a] for a in intra) if intra else 1
        fusable = (fused_matmul != "none"
                   and self.supports_fused_matmul
                   and pdef.fusable and trainable
                   and body_rank == 2 and body_dim == 1
                   and len(intra) == 1 and intra_deg > 1
                   and (cache_after == 1
                        or self.cache_placement == "regather"))
        return ParamResidency(
            tier, self.cache_placement, upd,
            fsdp_dim=body_dim, stage1_axes=inter, stage2_axes=intra,
            cache_after=cache_after,
            quantized_gather=(param_compress and quantizable
                              and self.supports_quantized_gather),
            quantized_reduce=(compress_bwd and quantizable),
            fused=(fused_matmul if fusable else "none"))

    def gather_plan(self, pdef, mesh, min_shard_size: int = 0,
                    compress_bwd: bool = False,
                    param_compress: bool = False,
                    fused_matmul: str = "none") -> GatherPlan:
        """The leaf's residency and its sync axes. A leaf whose stage 2
        would ring-fuse its backward (fused 'both') while its storage is
        replicated over some axis (MiCS over 'pod') raises: its dw would
        have to be summed over that axis after the ring scattered it,
        and the JAX package fails there too (its custom VJP's dw does
        not carry the replicated axis: ``ValueError ... varying manual
        axes do not match``)."""
        res = self.residency(pdef, mesh, min_shard_size, compress_bwd,
                             param_compress, fused_matmul)
        used = spec_axes(self.storage_spec(pdef, mesh, min_shard_size))
        replicated = tuple(a for a in mesh.axis_names
                           if a not in used and a != "model"
                           and mesh.shape[a] > 1)
        if res.fused == "both" and replicated:
            raise ValueError(
                f"{self.name}: fused_matmul='both' on a leaf replicated over "
                f"{replicated} is not supported (the JAX package's "
                "fused_matmul custom VJP fails on it: varying manual axes "
                "do not match); use 'ag_matmul'")
        # the widening axes' sum is the engine's reduce-scatter
        widened = spec_axes(self.opt_spec(pdef, mesh, min_shard_size))
        return GatherPlan(res, tuple(a for a in replicated
                                     if a not in widened))

    def plan_tree(self, defs, mesh, min_shard_size: int = 0,
                  compress_bwd: bool = False, param_compress: bool = False,
                  fused_matmul: str = "none"):
        from repro_torch.core.partition import tree_map
        return tree_map(
            lambda d: self.gather_plan(d, mesh, min_shard_size, compress_bwd,
                                       param_compress, fused_matmul), defs)

    # -- the stage-1 prefetch ring --------------------------------------------
    def prefetch_depth(self, sys, mesh_like) -> int:
        """The ring depth the scheduler may run (``mesh_like``: anything
        with ``axis_names``): 0 without a 'pod' axis, else the
        configured depth capped at ``max_prefetch_depth``."""
        if INTER_AXIS not in tuple(mesh_like.axis_names):
            return 0
        return min(sys.prefetch_depth, self.max_prefetch_depth)

    def prefetch_active(self, sys, mesh_like) -> bool:
        return self.prefetch_depth(sys, mesh_like) > 0

    # -- FCDP-Cache -------------------------------------------------------------
    def device_cache_groups(self, n_groups: int, fraction: float) -> int:
        """How many leading layer groups keep their cache on the
        device."""
        if not self.supports_device_cache:
            return 0
        return int(round(fraction * n_groups))

    # -- streams 2 and 3 --------------------------------------------------------
    def async_grad_reduce_active(self, sys, mesh_like) -> bool:
        """Whether the async 'pod' gradient reduce applies: the flag, a
        strategy with a stage 1, and a 'pod' axis of size > 1 (a
        ``mesh_like`` with only ``axis_names`` counts its presence)."""
        return (bool(getattr(sys, "async_grad_reduce", False))
                and self.supports_async_grad_reduce
                and _has_pod(mesh_like))

    def cross_step_active(self, sys, mesh_like) -> bool:
        """Whether the cross-step optimizer epilogue applies: it rides
        the async reduce (the carried pending gradient is stream 2's
        deferred reduce), so that must apply too."""
        return (bool(getattr(sys, "cross_step_pipeline", False))
                and self.supports_cross_step
                and self.async_grad_reduce_active(sys, mesh_like))

    # -- byte accounting --------------------------------------------------------
    def cached_bytes_for(self, pdef, plan: GatherPlan, mesh) -> float:
        """Per-rank bytes of this leaf's cached tier, in the def's dtype
        (0 when it is not gathered): the stage-1 shard (the storage
        shard times the stage-1 degree) with cache_after 1, the gathered
        'model'-local weight with cache_after 2."""
        if not plan.is_gathered:
            return 0.0
        nbytes = pdef.size() * pdef.dtype.itemsize
        if plan.cache_after == 1:
            shard = nbytes / self._storage_degree(pdef, mesh)
            inter = math.prod(mesh.size(a) for a in plan.inter_axes) or 1
            return shard * inter
        tp = mesh.size("model") if pdef.tp_dim is not None else 1
        return nbytes / tp

    @staticmethod
    def _storage_degree(pdef, mesh) -> int:
        """Every fsdp axis's size (whatever the leaf's scope) times the
        'model' size for a leaf with a tp dim, as the JAX package
        counts it."""
        deg = 1
        if pdef.fsdp_dim is not None:
            for a in fsdp_axes(mesh):
                deg *= mesh.size(a)
        if pdef.tp_dim is not None:
            deg *= mesh.size("model")
        return deg

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class Zero3(ShardingStrategy):
    """Full sharding, re-gather forward AND backward (paper baseline)."""
    name = "zero3"
    cache_placement = "regather"


class ZeroPP(ShardingStrategy):
    """Full sharding; stage-1 result cached on the device, backward
    re-runs stage 2 only (ZeRO++ analog)."""
    name = "zeropp"
    cache_placement = "device"


class FCDP(ShardingStrategy):
    """Full sharding; stage-1 result cached in pinned host memory,
    backward re-runs stage 2 only (the paper). Frozen leaves are stored
    in the cached layout (FCDP-Comm): pod-replicated, so stage 1 is
    empty and the fully gathered weight waits on the host."""
    name = "fcdp"
    cache_placement = "host"
    frozen_cached_layout = True
    supports_device_cache = True


class MiCS(ShardingStrategy):
    """Pod-local sharding: storage is pod-replicated, stage 1 is
    structurally empty and the single intra stage recomputes (forward
    and backward intra gathers, no inter gather). Gradients are summed
    across pods."""
    name = "mics"
    cache_placement = "regather"
    supports_quantized_gather = False
    max_prefetch_depth = 0
    supports_async_grad_reduce = False
    supports_cross_step = False

    def storage_fsdp_axes(self, mesh, frozen: bool) -> Tuple[str, ...]:
        return intra_fsdp_axes(mesh)


class Hierarchical(MiCS):
    """Hierarchical partitioning: MiCS's pod-replicated parameters and
    gathers, the optimizer state and master weights sharded over every
    fsdp axis. A step pays one 'pod' reduce-scatter of the gradient and
    one 'pod' all-gather of the updated shard, in place of MiCS's 'pod'
    all-reduce."""
    name = "hier"

    def opt_spec(self, pdef, mesh, min_shard_size: int = 0) -> Tuple:
        full = dataclasses.replace(pdef, fsdp_scope="full")
        storage = self.effective_fsdp_axes(full, mesh)
        widened = storage + tuple(a for a in fsdp_axes(mesh)
                                  if a not in storage)
        spec = self._spec_with_axes(full, mesh, widened, min_shard_size)
        if pdef.fsdp_dim is not None and spec[pdef.fsdp_dim] is None:
            # the full-width degree does not divide: the parameter's
            # layout (the state never shards narrower than storage)
            return super().opt_spec(pdef, mesh, min_shard_size)
        return spec


class CompositeStrategy(ShardingStrategy):
    """Per-leaf strategy dispatch behind the whole-model surface, built
    by ``resolve_strategies`` when a model mixes strategy groups (PEFT's
    mixed arm: the frozen trunk on fcdp, the adapters on zero3). Every
    per-leaf decision (storage and optimizer specs, residency, gather
    plan) goes to the strategy named by the leaf's ``ParamDef.strategy``
    tag, the default for an untagged leaf; so each group gates qwZ and
    the fused matmul by its own attributes."""

    name = "composite"

    def __init__(self, default: ShardingStrategy,
                 groups: Dict[str, ShardingStrategy]):
        self.default = default
        self.groups = dict(groups)

    def _for(self, pdef) -> ShardingStrategy:
        tag = getattr(pdef, "strategy", None)
        if not tag:
            return self.default
        return self.groups.get(tag) or get_strategy(tag)

    def group_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.groups))

    def storage_fsdp_axes(self, mesh, frozen: bool) -> Tuple[str, ...]:
        # no leaf in sight: the default group's answer
        return self.default.storage_fsdp_axes(mesh, frozen)

    def effective_fsdp_axes(self, pdef, mesh) -> Tuple[str, ...]:
        return self._for(pdef).effective_fsdp_axes(pdef, mesh)

    def storage_spec(self, pdef, mesh, min_shard_size: int = 0) -> Tuple:
        return self._for(pdef).storage_spec(pdef, mesh, min_shard_size)

    def opt_spec(self, pdef, mesh, min_shard_size: int = 0) -> Tuple:
        return self._for(pdef).opt_spec(pdef, mesh, min_shard_size)

    def residency(self, pdef, mesh, min_shard_size: int = 0,
                  compress_bwd: bool = False,
                  param_compress: bool = False,
                  fused_matmul: str = "none") -> ParamResidency:
        return self._for(pdef).residency(pdef, mesh, min_shard_size,
                                         compress_bwd, param_compress,
                                         fused_matmul)

    def gather_plan(self, pdef, mesh, min_shard_size: int = 0,
                    compress_bwd: bool = False,
                    param_compress: bool = False,
                    fused_matmul: str = "none") -> GatherPlan:
        return self._for(pdef).gather_plan(pdef, mesh, min_shard_size,
                                           compress_bwd, param_compress,
                                           fused_matmul)

    def cached_bytes_for(self, pdef, plan: GatherPlan, mesh) -> float:
        return self._for(pdef).cached_bytes_for(pdef, plan, mesh)

    @property
    def max_prefetch_depth(self) -> int:
        """The least cap of the groups that stream at all: a group with
        no stage 1 neither uses nor vetoes the ring."""
        caps = [s.max_prefetch_depth for s in self.groups.values()
                if s.max_prefetch_depth > 0]
        return min(caps) if caps else 0

    @property
    def supports_async_grad_reduce(self) -> bool:
        return any(s.supports_async_grad_reduce for s in self.groups.values())

    @property
    def supports_cross_step(self) -> bool:
        # any streaming group enables the carry; the carried epilogue then
        # covers every group's once-a-step collectives (a hier group's
        # widening reduce-scatter and gather back included)
        return any(s.supports_cross_step for s in self.groups.values())

    @property
    def supports_device_cache(self) -> bool:
        return any(s.supports_device_cache for s in self.groups.values())

    @property
    def cache_placement(self) -> str:
        # whole-model view only; the placement travels per plan
        return self.default.cache_placement

    @property
    def supports_quantized_gather(self) -> bool:
        return any(s.supports_quantized_gather for s in self.groups.values())

    @property
    def supports_fused_matmul(self) -> bool:
        return any(s.supports_fused_matmul for s in self.groups.values())

    def __repr__(self) -> str:
        return (f"<CompositeStrategy default={self.default.name!r} "
                f"groups={self.group_names()}>")


def _has_pod(mesh_like) -> bool:
    if INTER_AXIS not in tuple(mesh_like.axis_names):
        return False
    size = getattr(mesh_like, "size", None)
    return size is None or size(INTER_AXIS) > 1


def leaf_group(strategy, pdef) -> str:
    """A leaf's group: its strategy tag, else the composite's default,
    else the (uniform) strategy's own name."""
    tag = getattr(pdef, "strategy", None)
    if tag:
        return tag
    if isinstance(strategy, CompositeStrategy):
        return strategy.default.name
    return strategy.name


_REGISTRY: Dict[str, ShardingStrategy] = {}


def register_strategy(cls: Type[ShardingStrategy]) -> Type[ShardingStrategy]:
    """Register a strategy class under its ``name`` (singleton instance)."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"strategy {cls.__name__} needs a unique name")
    _REGISTRY[cls.name] = cls()
    return cls


for _cls in (Zero3, ZeroPP, FCDP, MiCS, Hierarchical):
    register_strategy(_cls)

DEFAULT_STRATEGY = FCDP.name


def strategy_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_strategy(name: str) -> ShardingStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown system mode {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def resolve_strategy(mode: Union[str, ShardingStrategy]) -> ShardingStrategy:
    """Accept a mode name or an already-resolved strategy object."""
    if isinstance(mode, ShardingStrategy):
        return mode
    return get_strategy(mode)


# -- per-leaf resolution (SystemConfig.mode_overrides, ParamDef.strategy) -------

def parse_mode_override(spec: str) -> Tuple[str, str]:
    """``'<path glob>=<mode>'`` (the command line's form) as a
    ``(pattern, mode)`` rule."""
    pattern, sep, mode = str(spec).partition("=")
    pattern, mode = pattern.strip(), mode.strip()
    if not sep or not pattern or not mode:
        raise ValueError(
            f"malformed mode override {spec!r}; expected "
            "'<path-glob>=<mode>' (e.g. '*lora*=zero3')")
    return pattern, mode


def normalize_mode_overrides(
        overrides: Sequence[Any]) -> Tuple[Tuple[str, str], ...]:
    """``SystemConfig.mode_overrides`` as ``(pattern, mode)`` pairs, in
    order, from pairs or ``'pattern=mode'`` strings; raises naming the
    rule for a malformed rule or an unregistered mode."""
    rules = []
    for rule in tuple(overrides or ()):
        if isinstance(rule, str):
            pattern, mode = parse_mode_override(rule)
        else:
            try:
                pattern, mode = rule
            except (TypeError, ValueError):
                raise ValueError(
                    f"malformed mode_overrides rule {rule!r}; expected "
                    "(pattern, mode) or 'pattern=mode'") from None
            if not (isinstance(pattern, str) and isinstance(mode, str)
                    and pattern.strip() and mode.strip()):
                raise ValueError(
                    f"malformed mode_overrides rule {rule!r}; pattern and "
                    "mode must be non-empty strings")
            pattern, mode = pattern.strip(), mode.strip()
        if mode not in _REGISTRY:
            raise ValueError(
                f"mode_overrides rule {pattern!r}={mode!r} names an "
                f"unknown strategy; registered: {sorted(_REGISTRY)}")
        rules.append((pattern, mode))
    return tuple(rules)


def resolve_strategies(sys, defs, *, strict: bool = True):
    """The per-leaf strategy assignment of a labelled ParamDef tree:
    ``(defs, strategy)``. Per leaf, its ``ParamDef.strategy`` tag wins,
    else the first ``sys.mode_overrides`` rule whose glob matches its
    dotted label (``fnmatch``; ``*`` crosses dots), else ``sys.mode``.
    With no rule and no tag the tree and the mode's singleton come back
    unchanged; otherwise every leaf is tagged, and a uniform assignment
    still gives the singleton, a mixed one a ``CompositeStrategy``.

    ``strict`` raises for a rule that is the first match of no leaf (a
    mistyped glob). The bundle resolves the base tree non-strict under
    ``peft`` (a rule for the adapters, ``'*lora*'``, matches nothing
    before they are injected) and strict after injection. Hits count by
    label only, so a tag shadowing a rule does not kill the rule."""
    from repro_torch.core.partition import tree_items, tree_map_with_path
    rules = normalize_mode_overrides(getattr(sys, "mode_overrides", ()))
    leaves = [d for _, d in tree_items(defs)]
    if not rules and not any(d.strategy for d in leaves):
        return defs, get_strategy(sys.mode)
    default = get_strategy(sys.mode)
    hits = [0] * len(rules)

    def tag(_, d):
        rule_name = None
        for ri, (pattern, mode) in enumerate(rules):
            if fnmatch.fnmatchcase(d.label, pattern):
                rule_name = mode
                hits[ri] += 1
                break
        if d.strategy:
            get_strategy(d.strategy)            # an unknown tag raises
            return d
        return dataclasses.replace(d, strategy=rule_name or default.name)

    tagged = tree_map_with_path(tag, defs)
    for (pattern, mode), n in zip(rules, hits):
        if n == 0 and strict:
            raise ValueError(
                f"mode_overrides rule {pattern!r}={mode!r} matched zero "
                "parameters (patterns are fnmatch globs against dotted "
                "label paths, e.g. 'blocks.*.attn.*_lora_*')")
    groups = {d.strategy: get_strategy(d.strategy)
              for _, d in tree_items(tagged)}
    if len(groups) == 1 and default.name in groups:
        return tagged, default
    return tagged, CompositeStrategy(default, groups)
