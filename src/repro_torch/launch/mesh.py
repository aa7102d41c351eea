"""Mesh construction: the named ("pod", "data", "model") layout of the
ranks, as the JAX package's ``launch/mesh.py`` defines it.

Mesh semantics:
  pod   - crosses the slow inter-node links. FCDP's "inter-node" axis.
  data  - intra-node; batch / ZeRO sharding. FCDP's "intra-node" axis.
  model - intra-node; tensor parallelism (Megatron column/row pairs).

``MeshShape`` is the axis names and sizes alone: plan derivation
(``core/strategy.py``) reads nothing else, so plans can be derived and
tested without starting ranks. ``RankMesh`` is the live mesh of one rank:
its coordinates and a process group for every set of axes (one axis,
the fsdp pair ('pod', 'data') once 'model' is live, ...). Ranks are laid
out row-major over the axes, as the JAX mesh lays out its devices.
"""
from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def fsdp_axes_of(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """ZeRO-3 sharding axes (all non-model axes), tiled INTRA-major (pod
    last): stage 1 gathers over pod, then stage 2 over data, so storage
    must be data-major for the staged reconstruction to land blocks in
    global order."""
    return (tuple(a for a in axis_names if a not in ("model", "pod"))
            + tuple(a for a in axis_names if a == "pod"))


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh; ``shape[a]`` reads like the JAX
    mesh's."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    @property
    def world(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> Dict[str, int]:
        """Row-major coordinates of ``rank``."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a mesh of {self.world}")
        out = {}
        for name, size in reversed(tuple(zip(self.axis_names,
                                              self.axis_sizes))):
            out[name] = rank % size
            rank //= size
        return {a: out[a] for a in self.axis_names}


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """Axes over which ZeRO-3 shards parameters (see fsdp_axes_of)."""
    return fsdp_axes_of(mesh.axis_names)


def intra_fsdp_axes(mesh) -> Tuple[str, ...]:
    """Fast (intra-node) fsdp axes: what FCDP re-gathers over in the
    backward."""
    return tuple(a for a in mesh.axis_names if a not in ("model", "pod"))


def tp_degree(mesh) -> int:
    return mesh.shape.get("model", 1)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh of the JAX package's dry run: (pod 2, data 16,
    model 16), 512 ranks, or one pod's (data 16, model 16)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def train_mesh_shape(world: int, multi_pod: bool) -> MeshShape:
    """The launcher's mesh over ``world`` ranks, by the JAX package's
    ``make_smoke_mesh`` rule: with ``multi_pod``, (pod 2, data world/2/m,
    model m) with m = gcd(world/2, 2); else (data world/m, model m) with
    m = gcd(world, 2). 8 ranks give (2, 2, 2), 4 give (2, 1, 2)."""
    if multi_pod:
        if world < 2 or world % 2:
            raise ValueError(f"a multi-pod mesh needs an even world size "
                             f">= 2, have {world}")
        model = math.gcd(world // 2, 2)
        return MeshShape(("pod", "data", "model"),
                         (2, world // 2 // model, model))
    model = math.gcd(world, 2)
    return MeshShape(("data", "model"), (world // model, model))


class RankMesh:
    """The live mesh of this rank (``torch.distributed`` must be
    initialized, with one process per rank).

    backend: ``nccl`` when every rank has a card of its own, ``gloo``
    otherwise (``collectives.pick_backend``); under gloo the wire is
    host memory, whatever device the compute runs on.

    Every rank creates the process groups of every set of live axes
    (axes of size > 1) at construction, in one order: ``new_group`` is
    collective over the whole world, so no group may be made lazily on
    the ranks that happen to use it first. A group's ranks are in
    global (row-major) order, so along one axis the group rank is the
    rank's coordinate on that axis."""

    def __init__(self, shape: MeshShape, backend: str):
        if dist.get_world_size() != shape.world:
            raise ValueError(f"mesh {shape.shape} needs {shape.world} ranks, "
                             f"the process group has "
                             f"{dist.get_world_size()}")
        self.mesh_shape = shape
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = shape.coords(self.rank)
        live = tuple(a for a in shape.axis_names if shape.size(a) > 1)
        self._groups = {}
        for k in range(1, len(live)):
            for axes in itertools.combinations(live, k):
                self._groups[frozenset(axes)] = self._new_groups(axes)
        if live:
            self._groups[frozenset(live)] = dist.group.WORLD

    def _new_groups(self, axes: Tuple[str, ...]):
        """One group per slice of the ranks that differ only along
        ``axes``; returns this rank's."""
        ms = self.mesh_shape
        rest = [a for a in ms.axis_names if a not in axes]
        slices = {}
        for r in range(ms.world):
            c = ms.coords(r)
            slices.setdefault(tuple(c[a] for a in rest), []).append(r)
        mine = None
        for key in sorted(slices):
            g = dist.new_group(ranks=slices[key])
            if self.rank in slices[key]:
                mine = g
        return mine

    def group(self, axes: Tuple[str, ...]):
        """Process group of the ranks that differ only along ``axes``
        (axes of size 1 count for nothing)."""
        ms = self.mesh_shape
        live = frozenset(a for a in axes if ms.size(a) > 1)
        try:
            return self._groups[live]
        except KeyError:
            raise ValueError(f"no process group for axes {axes} on mesh "
                             f"{ms.shape}") from None


def device_for_rank(device: Optional[str], rank: int) -> torch.device:
    """The compute device of ``rank``: ``cuda`` unless the caller names
    another; the card is ``LOCAL_RANK`` (else the rank) modulo the
    visible cards, so ranks share cards when there are fewer cards than
    ranks."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev
