"""Layer-stack machinery: stacked ParamDefs for a repeating group of
sublayers, the paged state stacked the same way, and the stack applied
as a Python loop over the leading ``[L, ...]`` dim (the JAX package's
layer scan). Serving runs on one rank with whole weights, so its loop
indexes the stacked leaves directly. Training (``apply_stack_train``)
holds each rank's shards: every layer gathers its weights through the
plans inside a ``ParamGather.layer()`` scope, the sequential schedule of
the JAX package's ``GatherScheduler`` at depth 0."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import ParamDef, tree_map
from repro_torch.models import sublayers as sl

KIND_DEFS = {
    "attn": sl.attn_defs,
    "mlp": sl.mlp_defs,
}


def group_defs(cfg: ModelConfig, plan: List[Tuple[str, ...]]
               ) -> Dict[str, Dict[str, Dict[str, ParamDef]]]:
    """Unstacked defs for one group: {pos{i}: {kind: {param: def}}}."""
    out: Dict[str, Any] = {}
    for i, kinds in enumerate(plan):
        pos = {}
        for kind in kinds:
            if kind not in KIND_DEFS:
                raise ValueError(f"sublayer kind {kind!r} is not ported yet")
            pos[kind] = KIND_DEFS[kind](cfg)
        out[f"pos{i}"] = pos
    return out


def stack_defs(defs, n_groups: int):
    """Prepend the stack dimension to every def."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n_groups,) + d.shape, dims=("stack",) + d.dims), defs)


def init_paged_group_state(cfg, plan, n_pages: int, page_size: int,
                           n_groups: int, device):
    """Paged KV pools for the stack, [n_groups, ...] per leaf. The page
    table is shared by all layers, so the only per-layer state is the
    attention pool itself."""
    out: Dict[str, Any] = {}
    for i, kinds in enumerate(plan):
        pos = {}
        for kind in kinds:
            if kind == "attn":
                pos[kind] = sl.attn_init_paged_state(
                    cfg, n_pages, page_size, n_groups, device)
            elif kind != "mlp":
                raise ValueError(
                    "paged serving supports attention-only stacks; "
                    f"plan position {i} has stateful kind {kind!r}")
        if pos:
            out[f"pos{i}"] = pos
    return out


def apply_sublayer(kind: str, cfg, p, x, ctx: Dict[str, Any], state=None):
    """Dispatch one sublayer. Returns (x, new_state)."""
    if kind == "attn":
        if not ctx.get("paged"):
            raise ValueError("the port serves attention over the paged "
                             "cache only")
        return sl.attn_paged(cfg, p, x, state, ctx["positions"],
                             ctx["page_table"])
    if kind == "mlp":
        return sl.mlp_apply(cfg, p, x), state
    raise ValueError(f"unknown sublayer kind {kind!r}")


def apply_stack(cfg: ModelConfig, plan: List[Tuple[str, ...]],
                n_groups: int, stacked_params, x, ctx: Dict[str, Any],
                stacked_state=None):
    """Run the group once per entry of the stack dim. stacked_params and
    stacked_state carry the stack dim first on every leaf; layer l reads
    the views ``leaf[l]``, and the paged pools are updated in place
    through them. Returns (x, stacked_state)."""
    for layer in range(n_groups):
        for i, kinds in enumerate(plan):
            key = f"pos{i}"
            for kind in kinds:
                p = {n: t[layer] for n, t in stacked_params[key][kind].items()}
                st = None
                if stacked_state is not None and kind in stacked_state.get(
                        key, {}):
                    st = {n: t[layer]
                          for n, t in stacked_state[key][kind].items()}
                x, _ = apply_sublayer(kind, cfg, p, x, ctx, st)
    return x, stacked_state


def apply_stack_train(cfg: ModelConfig, plan: List[Tuple[str, ...]],
                      n_groups: int, stacked_params, stacked_plans, x,
                      positions, gather):
    """The train forward of the stack: layer l gathers the shards
    ``leaf[l]`` through their plans (norm scales straight to fp32,
    where ``rms_norm`` reads them) and applies the group. Returns x."""
    import torch
    for layer in range(n_groups):
        with gather.layer():
            for i, kinds in enumerate(plan):
                key = f"pos{i}"
                for kind in kinds:
                    shards = stacked_params[key][kind]
                    plans = stacked_plans[key][kind]
                    p = {n: gather(t[layer], plans[n],
                                   torch.float32 if n == "norm" else None)
                         for n, t in shards.items()}
                    if kind == "attn":
                        x = sl.attn_train(cfg, p, x, positions)
                    elif kind == "mlp":
                        x = sl.mlp_apply(cfg, p, x)
                    else:
                        raise ValueError(f"sublayer kind {kind!r} is not "
                                         "ported to training yet")
    return x
