"""Convert the JAX package's parameters into the port's: the whole
parameter dict (serving, one rank) or this rank's shards of it
(training); and a decode state of the JAX package into the port's.

The JAX side hands them over as a nested dict of numpy arrays (its
``StepBundle`` leaves unflattened with ``StepBundle.treedef``: stacked
``blocks`` leaves, or an encoder-decoder's ``enc_blocks`` and
``dec_blocks``, the same key names; the serve and train bundles' trees
have the same leaves). bf16 arrays cross through a ``uint16``
view, so values arrive bit for bit. Only numpy is needed here; the
caller does the JAX side.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, SystemConfig
from repro_torch.core.partition import (tree_items, tree_map,
                                        tree_map_with_path)
from repro_torch.core.peft import apply_lora
from repro_torch.models.registry import build_model


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree, cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None, device=None,
                    sys: Optional[SystemConfig] = None):
    """The port's parameter dict for ``cfg`` from the JAX package's
    nested dict of numpy arrays, on ``device`` (None means ``cuda``, and
    raises without one). Every leaf of the port's defs must be present
    with its shape, and no other leaf: under ``sys.peft`` the defs hold
    the LoRA adapters too. ``dtype`` casts (None keeps the source
    type)."""
    device = resolve_device(device)
    sys = sys or SystemConfig()
    defs = build_model(cfg, sys).defs
    if sys.peft:
        defs = apply_lora(defs, sys)
    full = _checked(tree, defs)

    def one(path, d):
        t = full(path, d)
        return (t if dtype is None else t.to(dtype)).to(device)
    return tree_map_with_path(one, defs)


def state_from_jax(tree, device=None):
    """The port's decode state from the JAX package's (a nested dict of
    numpy arrays with the same leaves, e.g. ``{pos0: {rwkv_tm: {s,
    xprev}, rwkv_cm: {xprev}}}`` or jamba's ``{pos0: {attn: {idx, k,
    v}}, pos1: {mamba: {conv, h}}}``), every leaf in its own type (bf16
    bit for bit, the caches' int32 ``idx`` included), on ``device``
    (None means ``cuda``, and raises without one)."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)


def shards_from_jax(tree, bundle):
    """This rank's shards of the JAX package's full parameters, for a
    train ``bundle`` on a live mesh (adapters included under PEFT): each
    leaf cut by its storage spec (a frozen leaf's pod-replicated one
    under fcdp; the 'model' coordinate's block of a tensor-parallel
    leaf), in the system's dtype, on the bundle's device, requiring
    grad where the leaf is trainable. The JAX tree must come from a
    bundle on a mesh of the same 'model' size: both pad the q heads and
    the vocabulary to a multiple of it."""
    full = _checked(tree, bundle.defs)
    dtype = bundle.run.system.torch_dtype
    return tree_map_with_path(
        lambda path, d: bundle.shard(path, full(path, d).to(dtype)),
        bundle.defs)


def _checked(tree, defs):
    """A reader of the tree's leaves as tensors, after checking that the
    tree has exactly the defs' leaves."""
    want = dict(tree_items(defs))
    have = dict(tree_items(tree))
    if set(want) != set(have):
        raise ValueError(
            f"parameter trees differ: missing {sorted(set(want) - set(have))}"
            f", extra {sorted(set(have) - set(want))}")

    def read(path, d):
        a = have[path]
        if tuple(a.shape) != d.shape:
            raise ValueError(f"{path}: shape {tuple(a.shape)} != {d.shape}")
        return _tensor(a)
    return read
