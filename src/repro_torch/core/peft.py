"""FCDP-Comm + LoRA: the classification of the parameters into frozen
base weights and trainable adapters, as the JAX package's
``core/peft.py`` makes it.

Frozen ParamDefs carry ``frozen=True``. Their update class is read in
one place (``core/residency.update_class``): under a strategy with the
frozen cached layout (fcdp) they are stored pod-replicated, so their
reconstruction never crosses 'pod', and they receive no gradient and no
optimizer state. The adapters keep the full ZeRO-3 treatment.

LoRA adds rank-r adapters next to the attention projections (the
paper's section V-D: r = 8 on q, k, v and o). Only attention consumes
them (``models/attention.py``), as in the JAX package: an adapter
injected next to an MLP projection is trained on a zero gradient.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import SystemConfig
from repro_torch.core.partition import ParamDef, tree_items

LORA_TARGETS_IN_ATTN = ("wq", "wk", "wv", "wo")


def _map_defs(fn, tree):
    return {k: _map_defs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def freeze_all(defs):
    """Every ParamDef frozen (the serving layout, FCDP-Comm's base)."""
    return _map_defs(lambda d: dataclasses.replace(d, frozen=True), defs)


def unfreeze_all(defs):
    """Every ParamDef trainable: the all-trainable reference arm of the
    PEFT comparison (the same def tree as ``apply_lora``'s, adapters
    included, but every leaf gets a gradient and optimizer state)."""
    return _map_defs(lambda d: dataclasses.replace(d, frozen=False), defs)


def apply_lora(defs, sys: SystemConfig):
    """Freeze every base def and inject trainable adapters
    ``<t>_lora_a`` / ``<t>_lora_b`` into each dict that holds a
    ``sys.lora_targets`` projection of rank >= 2. A's dims follow the
    base's input dim, B's its output dim; a 'stack' dim is kept. Raises
    when no dict holds a target."""
    r = sys.lora_rank
    injected = 0

    def visit(node):
        nonlocal injected
        out = {k: visit(v) if isinstance(v, dict)
               else dataclasses.replace(v, frozen=True)
               for k, v in node.items()}
        for t in sys.lora_targets:
            base = node.get(t)
            if not (isinstance(base, ParamDef) and len(base.shape) >= 2):
                continue
            d_in, d_out = base.shape[-2], base.shape[-1]
            stack, sdims = base.shape[:-2], base.dims[:-2]
            out[f"{t}_lora_a"] = ParamDef(
                stack + (d_in, r), sdims + (base.dims[-2], None),
                init="normal", init_scale=1.0)
            out[f"{t}_lora_b"] = ParamDef(
                stack + (r, d_out), sdims + (None, base.dims[-1]),
                init="zeros")
            injected += 1
        return out

    out = visit(defs)
    if injected == 0:
        raise ValueError(
            f"peft=True but no LoRA injection sites found: none of the "
            f"configured lora_targets {sys.lora_targets!r} name a "
            f"matrix-shaped ParamDef in any sublayer dict of this model "
            f"family -- set SystemConfig.lora_targets to this model's "
            f"projection names")
    return out


def split_frozen_indices(defs) -> Tuple[List[int], List[int]]:
    """Flat indices (tree order) of the (trainable, frozen) ParamDefs."""
    from repro_torch.core.residency import split_frozen_indices as split
    return split([d for _, d in tree_items(defs)])


def lora_scale(sys: SystemConfig) -> float:
    """The adapter term's multiplier, alpha / rank (alpha = 2 rank when
    ``sys.lora_alpha`` is None: 2.0)."""
    alpha = (sys.lora_alpha if sys.lora_alpha is not None
             else 2.0 * sys.lora_rank)
    return alpha / sys.lora_rank
