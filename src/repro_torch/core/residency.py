"""Parameter residency: one explicit lifecycle object per parameter, as
the JAX package's ``core/residency.py`` defines it.

  storage tier     where the authoritative bytes live between steps:
                     'dcn_sharded'     fsdp over ('data', 'pod') -- the
                                       leaf crosses the slow links to
                                       be rebuilt
                     'pod_replicated'  fsdp over the intra axes only
                                       (MiCS storage) -- stage 1 is
                                       structurally empty
                     'replicated'      not fsdp-sharded at all (too
                                       small, indivisible, or no fsdp
                                       dim)
  reconstruction   ``stage1_axes`` (inter), ``stage2_axes`` (intra),
                   the ``cache_after`` boundary, and the int8 stage-1
                   transports: qwZ (``quantized_gather``) and qgZ
                   (``quantized_reduce``); ``fused``: whether stage 2
                   is consumed by the gather-fused collective matmul
                   ('none' | 'ag_matmul' | 'both')
  cache+backward   where the cached gather product waits between forward
                   and backward ('regather' | 'device' | 'host') and
                   hence what the backward reads (``backward_source``)
  update class     'trainable' (gradient and optimizer state),
                   'frozen' (no update, the strategy's own layout: a
                   zero3 trunk is still rebuilt over 'pod' every step,
                   as DeepSpeed treats a frozen trunk), or
                   'frozen_cached' (frozen under a strategy with the
                   frozen cached layout: FCDP-Comm's pod-replicated
                   trunk, which never crosses 'pod')

``core/strategy.py`` emits residencies; ``GatherPlan`` is derived from
one and carries it. A non-trainable leaf never quantizes its stage-1
gather, never compresses a gradient reduce and never fuses its stage 2
(enforced at construction): it receives no gradient, and its weights
stay exact.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

STORAGE_TIERS = ("dcn_sharded", "pod_replicated", "replicated")
FUSED_MODES = ("none", "ag_matmul", "both")
CACHE_TIERS = ("regather", "device", "host")
UPDATE_CLASSES = ("trainable", "frozen", "frozen_cached")


@dataclass(frozen=True)
class ParamResidency:
    """The lifecycle of one parameter leaf, as resolved by its strategy."""
    tier: str                          # STORAGE_TIERS
    cache: str                         # CACHE_TIERS
    update: str                        # UPDATE_CLASSES
    fsdp_dim: Optional[int] = None     # dim index in the per-layer view
    stage1_axes: Tuple[str, ...] = ()  # inter-pod gather axes
    stage2_axes: Tuple[str, ...] = ()  # intra-pod gather axes
    cache_after: int = 2               # 1 | 2: which stage's product caches
    quantized_gather: bool = False     # qwZ int8 stage-1 transport
    quantized_reduce: bool = False     # qgZ int8 stage-1 grad reduce
    fused: str = "none"                # FUSED_MODES

    def __post_init__(self):
        if self.tier not in STORAGE_TIERS:
            raise ValueError(
                f"unknown storage tier {self.tier!r}; one of {STORAGE_TIERS}")
        if self.cache not in CACHE_TIERS:
            raise ValueError(
                f"unknown cache tier {self.cache!r}; one of {CACHE_TIERS}")
        if self.update not in UPDATE_CLASSES:
            raise ValueError(
                f"unknown update class {self.update!r}; one of "
                f"{UPDATE_CLASSES}")
        if self.cache_after not in (1, 2):
            raise ValueError(
                f"cache_after must be 1 or 2, got {self.cache_after!r}")
        if self.stage1_axes and self.tier != "dcn_sharded":
            raise ValueError(
                f"tier {self.tier!r} cannot carry stage-1 axes "
                f"{self.stage1_axes!r}")
        if self.tier == "dcn_sharded" and not self.stage1_axes:
            raise ValueError(
                "tier 'dcn_sharded' requires non-empty stage1_axes")
        if self.tier == "pod_replicated" and not self.stage2_axes:
            raise ValueError(
                "tier 'pod_replicated' requires non-empty stage2_axes")
        if (self.quantized_gather or self.quantized_reduce) \
                and not self.stage1_axes:
            raise ValueError("an int8 stage-1 transport needs a stage 1")
        if self.fused not in FUSED_MODES:
            raise ValueError(f"unknown fused mode {self.fused!r}; one of "
                             f"{FUSED_MODES}")
        if self.fused != "none" and len(self.stage2_axes) != 1:
            raise ValueError("a fused stage 2 rings over exactly one intra "
                             f"axis, not {self.stage2_axes!r}")
        if self.update != "trainable":
            if self.quantized_gather:
                raise ValueError(
                    f"{self.update!r} leaf cannot quantize its stage-1 "
                    "gather: its weights stay exact")
            if self.quantized_reduce:
                raise ValueError(
                    f"{self.update!r} leaf cannot compress a gradient "
                    "reduce: it receives no gradient")
            if self.fused != "none":
                raise ValueError(
                    f"{self.update!r} leaf cannot fuse its stage-2 gather "
                    "into a collective matmul: its weights stay exact")

    @property
    def trainable(self) -> bool:
        return self.update == "trainable"

    @property
    def frozen(self) -> bool:
        """Any non-trainable class."""
        return self.update != "trainable"

    @property
    def invariant_gather(self) -> bool:
        """Frozen leaves gather with no gradient flowing back (the JAX
        package's invariant all-gather)."""
        return self.frozen

    @property
    def occupies_ring_slot(self) -> bool:
        """Whether a stage-1 prefetch ring would spend a slot on this
        leaf: only a leaf with a stage-1 gather to overlap."""
        return self.is_gathered and bool(self.stage1_axes)

    @property
    def stage1_resident(self) -> bool:
        """Whether this is the residency of a leaf whose stage 1 already
        ran outside the step body (``as_stage1_resident``): the cache
        boundary sits after a stage 1 that is no longer there, so the
        backward reads the resident view itself."""
        return self.is_gathered and self.cache_after == 1 \
            and not self.stage1_axes

    @property
    def receives_gradient(self) -> bool:
        return self.trainable

    @property
    def has_optimizer_state(self) -> bool:
        return self.trainable

    @property
    def is_gathered(self) -> bool:
        return self.fsdp_dim is not None and (bool(self.stage1_axes)
                                              or bool(self.stage2_axes))

    @property
    def backward_source(self) -> str:
        """What the backward reads to rebuild the weight: 'resident'
        (never gathered), 'regather' (re-run both stages),
        'device_cache' / 'host_cache' (re-run stage 2 from the cached
        stage-1 shard, or read the cached full weight when
        cache_after == 2)."""
        if not self.is_gathered:
            return "resident"
        if self.cache == "regather":
            return "regather"
        return f"{self.cache}_cache"


def update_class(pdef, frozen_cached_layout: bool = False) -> str:
    """A ParamDef's update class under a strategy whose
    ``frozen_cached_layout`` is given: the one place ``ParamDef.frozen``
    is read."""
    if not getattr(pdef, "frozen", False):
        return "trainable"
    return "frozen_cached" if frozen_cached_layout else "frozen"


def split_frozen_indices(defs) -> Tuple[List[int], List[int]]:
    """Flat indices of (trainable, frozen) ParamDefs of a leaf
    sequence."""
    train, frozen = [], []
    for i, d in enumerate(defs):
        (train if update_class(d) == "trainable" else frozen).append(i)
    return train, frozen


def split_train_indices(residencies) -> Tuple[List[int], List[int]]:
    """Flat indices of (trainable, frozen) leaves from a residency (or
    residency-carrying plan) sequence."""
    train, frozen = [], []
    for i, r in enumerate(residencies):
        (train if residency_of(r).trainable else frozen).append(i)
    return train, frozen


def as_stage1_resident(res: ParamResidency) -> ParamResidency:
    """The lifecycle of a leaf whose stage-1 ('pod') gather already ran
    outside the model (the async gradient reduce differentiates with
    respect to the stage-1 view): no stage-1 axes remain, the tier is
    what the stage-1 product is (pod-replicated, or replicated when there
    was no stage 2), and no stage-1 transport is left to quantize. The
    JAX package keeps ``quantized_reduce`` here; the port clears it too,
    since its residency refuses an int8 transport without a stage 1: the
    deferred reduce reads the original plan's flag."""
    if not res.stage1_axes:
        return res
    return dataclasses.replace(
        res, stage1_axes=(),
        tier="pod_replicated" if res.stage2_axes else "replicated",
        quantized_gather=False, quantized_reduce=False)


def residency_of(obj) -> ParamResidency:
    """Accept a ParamResidency or anything carrying one (a GatherPlan)."""
    if isinstance(obj, ParamResidency):
        return obj
    res = getattr(obj, "residency", None)
    if res is None:
        raise TypeError(f"{type(obj).__name__} carries no ParamResidency")
    return res
