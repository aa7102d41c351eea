"""Parameter definitions: ParamDef trees and their initialization.

Every parameter is a ParamDef whose ``dims`` tag each dimension with a
logical role, as in the JAX package:

  'stack' - layer-group dimension (never sharded)
  'fsdp'  - ZeRO-3 sharding dimension
  'tp'    - tensor-parallel dimension
  None    - unsharded

On one rank (serving) every tag is inert: the parameter dict holds full
tensors. In training, WHICH mesh axes the fsdp dim shards over is the
strategy's decision (``core/strategy.py``); a storage spec is a tuple
with one entry per dimension -- None, one axis name, or a tuple of axis
names tiled first-major -- the entries of the JAX package's
``PartitionSpec``. ``shard_of`` cuts one rank's block out of a full
tensor.
Trees are nested dicts, walked in sorted-key order -- the leaf order of
the JAX package's treedef, so the two packages enumerate the same
leaves in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed
    init_scale: float = 1.0
    frozen: bool = False          # FCDP-Comm classification
    # the leaf is the right operand of one [..., K] @ [K, N] output
    # projection routed through models/layers.matmul: the use the
    # gather-fused collective matmul needs (opt-in at the def site; the
    # plan rule in core/strategy.residency gates further)
    fusable: bool = False
    label: str = ""               # dotted path, filled by label_tree
    # 'inter_only': sharded over the slow 'pod' axis only, resident
    # within the pod (the JAX package's weight-stationary scope for MoE
    # experts); its optimizer state still shards over every fsdp axis
    fsdp_scope: str = "full"      # full | inter_only
    # the leaf's strategy group (a registered mode name), set by
    # core/strategy.resolve_strategies; None: SystemConfig.mode
    strategy: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} "
                             "differ in rank")
        if self.fsdp_scope not in ("full", "inter_only"):
            raise ValueError(f"unknown fsdp_scope {self.fsdp_scope!r}; "
                             "known: full, inter_only")

    @property
    def fsdp_dim(self) -> Optional[int]:
        return self.dims.index("fsdp") if "fsdp" in self.dims else None

    @property
    def tp_dim(self) -> Optional[int]:
        return self.dims.index("tp") if "tp" in self.dims else None

    def size(self) -> int:
        return math.prod(self.shape)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a nested dict in sorted-key order."""
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """Map ``fn(dotted_path, leaf)`` over a nested dict, visiting the
    leaves in sorted-key order (the order ``tree_items`` yields)."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        out[k] = (tree_map_with_path(fn, v, path) if isinstance(v, dict)
                  else fn(path, v))
    return out


def label_tree(tree):
    """Attach dotted-path labels to every ParamDef in the tree."""
    return tree_map_with_path(lambda path, d: replace(d, label=path), tree)


def init_leaf(gen: torch.Generator, pdef: ParamDef, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if pdef.init == "zeros":
        return torch.zeros(pdef.shape, dtype=dtype, device=device)
    if pdef.init == "ones":
        return torch.ones(pdef.shape, dtype=dtype, device=device)
    fan_in = pdef.shape[-2] if len(pdef.shape) >= 2 else pdef.shape[-1]
    scale = pdef.init_scale / math.sqrt(max(fan_in, 1))
    if pdef.init == "embed":
        scale = pdef.init_scale * 0.02
    x = torch.randn(pdef.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def init_params(defs, seed: int, device: torch.device,
                dtype: Optional[torch.dtype] = None):
    """Materialize parameters from one ``torch.Generator`` on ``device``,
    drawing leaves in tree order. ``dtype`` overrides each def's type.
    The JAX package draws from ``jax.random``: the same seed gives other
    numbers, so parity tests convert one package's weights
    (``repro_torch.convert``) instead."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map_with_path(
        lambda _, d: init_leaf(gen, d, dtype or d.dtype, device), defs)


# ---------------------------------------------------------------------------
# Shards (the layout decisions live on the strategy; see core/strategy.py)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(axes: Tuple[str, ...], mesh, coords: Dict[str, int]):
    """(block index, block count) of a rank along one spec entry: the
    entry's axes tile first-major."""
    idx, count = 0, 1
    for a in axes:
        n = mesh.shape[a]
        idx, count = idx * n + coords[a], count * n
    return idx, count


def shard_of(full: torch.Tensor, spec: Tuple, mesh,
             coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``full`` that the rank at mesh ``coords`` stores
    under ``spec`` (a view)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        idx, count = block_index(axes, mesh, coords)
        if out.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split into {count} blocks")
        step = out.shape[dim] // count
        out = out.narrow(dim, idx * step, step)
    return out
