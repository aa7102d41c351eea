"""Layer-stack machinery: stacked ParamDefs for a repeating group of
sublayers, the paged and the recurrent decode state stacked the same
way, and the stack applied as a Python loop over the leading ``[L,
...]`` dim (the JAX package's layer scan). Serving runs on one rank
with whole weights, so its loop indexes the stacked leaves directly.
Training (``apply_stack_train``) holds each rank's shards: every layer
gathers its weights through the plans inside a ``ParamGather.layer()``
scope, under the gather's schedule (``core/schedule.GatherScheduler``:
the sequential loop at depth 0, the stage-1 prefetch ring at depth k),
one segment of the stack at a time (FCDP-Cache's device segment first),
under the activation policy's recompute (``_Recompute``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, SystemConfig
from repro_torch.core.fcdp import FusedParam
from repro_torch.core.partition import ParamDef, tree_map
from repro_torch.core.schedule import _in_ring
from repro_torch.models import sublayers as sl
from repro_torch.models.common import SERIAL, CollectiveTape, TPContext

KIND_DEFS = {
    "attn": sl.attn_defs,
    "xattn": sl.xattn_defs,
    "mlp": sl.mlp_defs,
    "moe": sl.moe_defs,
    "mamba": sl.mamba_defs,
    "rwkv_tm": sl.rwkv_tm_defs,
    "rwkv_cm": sl.rwkv_cm_defs,
}

# sublayers whose decode state is recurrent: each step returns a new one
# (attention's caches are written in place instead)
RECURRENT_KINDS = ("mamba", "rwkv_tm", "rwkv_cm")


def group_defs(cfg: ModelConfig, plan: List[Tuple[str, ...]], tp: int = 1,
               sys: Optional[SystemConfig] = None
               ) -> Dict[str, Dict[str, Dict[str, ParamDef]]]:
    """Unstacked defs for one group: {pos{i}: {kind: {param: def}}}, at
    tensor-parallel degree ``tp`` (which pads the q heads of attention
    and cross-attention and the time-mix's heads); the MoE's experts are
    'inter_only' under ``sys.moe_weight_resident``."""
    out: Dict[str, Any] = {}
    for i, kinds in enumerate(plan):
        pos = {}
        for kind in kinds:
            if kind not in KIND_DEFS:
                raise ValueError(f"sublayer kind {kind!r} is not ported yet")
            if kind in ("attn", "xattn", "rwkv_tm"):
                pos[kind] = KIND_DEFS[kind](cfg, tp)
            elif kind == "moe":
                pos[kind] = sl.moe_defs(
                    cfg, bool(sys and sys.moe_weight_resident))
            else:
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


def init_group_state(cfg, plan, batch: int, max_len: int, n_groups: int,
                     device, enc_len: int = 0):
    """The contiguous decode state of the stack, [n_groups, ...] per
    leaf, with the JAX package's leaves, names and dtypes: attention's
    KV cache of ``max_len`` positions, cross-attention's encoder K/V of
    ``enc_len`` positions and the recurrent sublayers' state."""
    out: Dict[str, Any] = {}
    for i, kinds in enumerate(plan):
        pos = {}
        for kind in kinds:
            if kind == "attn":
                st = sl.attn_init_state(cfg, batch, max_len, device)
            elif kind == "xattn":
                st = sl.xattn_init_state(cfg, batch, enc_len, device)
            elif kind == "mamba":
                st = sl.mamba_init_state(cfg, batch, device)
            elif kind == "rwkv_tm":
                st = sl.rwkv_tm_init_state(cfg, batch, device)
            elif kind == "rwkv_cm":
                st = sl.rwkv_cm_init_state(cfg, batch, device)
            else:
                continue
            pos[kind] = {n: t.expand((n_groups,) + t.shape).contiguous()
                         for n, t in st.items()}
        if pos:
            out[f"pos{i}"] = pos
    return out


def apply_sublayer(kind: str, cfg, p, x, ctx: Dict[str, Any], state=None):
    """Dispatch one sublayer. Returns (x, new_state). ctx "paged" serves
    attention over the paged cache; "prefill" and "decode" run attention
    over its contiguous cache (from the cache's ``idx`` on, in place)
    and the recurrent sublayers over their state (prefill starts from
    zero state and does not read the one passed, as in the JAX
    package); with neither, rwkv runs over the whole sequence and keeps
    no state, and attention with ctx "causal" False (the encoder's)
    runs without a cache. Cross-attention projects ctx "enc_out" into
    its K/V at prefill (stored into its state in place, in the state's
    type) and without a state, and reads the state at decode, as the
    JAX package's ``stack.py`` dispatches it. The MoE's aux loss is not
    computed (serving). ctx "lora_scale" scales the attention adapters
    (PEFT), where there are any."""
    if kind == "attn":
        scale = ctx.get("lora_scale", 2.0)
        if ctx.get("paged"):
            return sl.attn_paged(cfg, p, x, state, ctx["positions"],
                                 ctx["page_table"], scale)
        if ctx.get("decode"):
            return sl.attn_decode(cfg, p, x, state, scale)
        if ctx.get("prefill") and state is not None:
            return sl.attn_apply(cfg, p, x, ctx["positions"], state, scale)
        if not ctx.get("causal", True):
            return sl.attn_encode(cfg, p, x, ctx["positions"], scale), state
        raise ValueError("causal attention without a cache is the train "
                         "branch (apply_stack_train)")
    if kind == "xattn":
        if ctx.get("decode"):
            return sl.xattn_apply(cfg, p, x, (state["k"], state["v"])), state
        k, v = sl.xattn_make_kv(cfg, p, ctx["enc_out"])
        if state is not None:
            state["k"].copy_(k)
            state["v"].copy_(v)
        return sl.xattn_apply(cfg, p, x, (k, v)), state
    if kind == "mlp":
        return sl.mlp_apply(cfg, p, x), state
    if kind == "moe":
        return sl.moe_apply(cfg, p, x)[0], state
    if kind == "mamba":
        if ctx.get("decode"):
            return sl.mamba_decode(cfg, p, x, state)
        if ctx.get("prefill"):
            return sl.mamba_prefill(cfg, p, x)
        raise ValueError("mamba without a state is the train branch "
                         "(apply_stack_train)")
    if kind == "rwkv_tm":
        if ctx.get("decode"):
            return sl.rwkv_tm_decode(cfg, p, x, state)
        if ctx.get("prefill"):
            return sl.rwkv_tm_prefill(cfg, p, x)
        return sl.rwkv_tm_apply(cfg, p, x), state
    if kind == "rwkv_cm":
        if ctx.get("decode"):
            return sl.rwkv_cm_decode(cfg, p, x, state)
        if ctx.get("prefill"):
            return sl.rwkv_cm_prefill(cfg, p, x)
        return sl.rwkv_cm_apply(cfg, p, x), state
    raise ValueError(f"unknown sublayer kind {kind!r}")


def apply_stack(cfg: ModelConfig, plan: List[Tuple[str, ...]],
                n_groups: int, stacked_params, x, ctx: Dict[str, Any],
                stacked_state=None):
    """Run the group once per entry of the stack dim. stacked_params and
    stacked_state carry the stack dim first on every leaf; layer l reads
    the views ``leaf[l]``. The paged pools and the contiguous KV caches
    (with their ``idx``) are updated in place through them; the
    recurrent sublayers' new states are stacked into new tensors.
    Returns (x, the stacked state the next step consumes)."""
    fresh: Dict[Tuple[str, str], List[Dict[str, torch.Tensor]]] = {}
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
                x, st_new = apply_sublayer(kind, cfg, p, x, ctx, st)
                if kind in RECURRENT_KINDS and st_new is not None:
                    fresh.setdefault((key, kind), []).append(st_new)
    if not fresh:
        return x, stacked_state
    out = {key: dict(pos) for key, pos in (stacked_state or {}).items()}
    for (key, kind), layers in fresh.items():
        out.setdefault(key, {})[kind] = {
            n: torch.stack([st[n] for st in layers]) for n in layers[0]}
    return x, out


def apply_sublayer_train(kind: str, cfg, p, x, positions,
                         lora_scale: float, tpc: TPContext,
                         moe_token_chunk: int = sl.MOE_TOKEN_CHUNK,
                         causal: bool = True, enc_out=None):
    """One sublayer of the train forward, tensor-parallel over 'model'
    (self-attention ``causal`` or not, cross-attention over
    ``enc_out``). Returns (x, aux loss or None: only the MoE has
    one)."""
    if kind == "attn":
        return sl.attn_train(cfg, p, x, positions, lora_scale, tpc,
                             causal), None
    if kind == "xattn":
        return sl.xattn_train(cfg, p, x, enc_out, tpc), None
    if kind == "mlp":
        return sl.mlp_apply(cfg, p, x, tpc), None
    if kind == "moe":
        return sl.moe_train(cfg, p, x, tpc, moe_token_chunk)
    if kind == "mamba":
        return sl.mamba_train(cfg, p, x, tpc), None
    if kind == "rwkv_tm":
        return sl.rwkv_tm_train(cfg, p, x, tpc), None
    if kind == "rwkv_cm":
        return sl.rwkv_cm_train(cfg, p, x, tpc), None
    raise ValueError(f"unknown sublayer kind {kind!r}")


def _unread(kind: str, name: str) -> bool:
    """Whether a ``kind`` sublayer leaves its leaf ``name`` unread: an
    adapter of any sublayer but attention (``sublayers._lora_kwargs``).
    The JAX step's dead-code elimination drops such a leaf's gather and
    its gradient's reduce; the train forward gathers it not at all, and
    its gradient is zero."""
    return kind != "attn" and "_lora_" in name


class _Recompute(torch.autograd.Function):
    """One layer group under the block_io / offload_acts /
    save_collectives activation policies (the JAX package's
    ``checkpoint_layer``): the forward runs ``body(x, weights)`` without
    autograd and keeps only the layer's input and its weights, the
    weights through ``ParamGather.layer()``'s hooks, so the backward
    reads each from its tier exactly as save_all's backward does (stage
    2 from the host cache under fcdp, both stages under zero3, the
    slot's tensor when the ring fed it, the resident view under stream
    2), and the recompute calls no gather. The backward runs the body
    again with autograd and differentiates it; its 'model' all-reduces
    go through ``tape`` (``models/common.CollectiveTape``: run again, or
    under save_collectives taken from the forward, the layer's last one
    skipped, and with it the fused ring of the output projection that
    feeds a skipped or kept one)."""

    @staticmethod
    def forward(ctx, body, tape, x, *weights):
        ctx.body, ctx.tape = body, tape
        y, aux = body(x, weights, tape)
        tape.recorded()
        ctx.save_for_backward(x, *weights)
        return y, aux

    @staticmethod
    def backward(ctx, gy, gaux):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad():
            y, aux = ctx.body(ins[0], ins[1:], ctx.tape.replay())
        outs, gouts = [y], [gy]
        if aux.requires_grad and gaux is not None:    # the MoE's aux loss
            outs.append(aux)
            gouts.append(gaux)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(outs, wanted, gouts,
                                         allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None for n in need)


def apply_stack_train(cfg: ModelConfig, plan: List[Tuple[str, ...]],
                      n_groups: int, stacked_params, stacked_plans,
                      stacked_defs, x, positions, gather,
                      lora_scale: float = 2.0, tpc: TPContext = SERIAL,
                      start: int = 0, placement: Optional[str] = None,
                      policy: str = "save_all",
                      moe_token_chunk: int = sl.MOE_TOKEN_CHUNK,
                      causal: bool = True, enc_out=None):
    """The train forward of layers ``start .. n_groups - 1`` of the
    stack (one segment of ``LM._segments``, or an encoder-decoder's
    whole encoder or decoder, whose self-attention is ``causal`` or not
    and whose cross-attention reads ``enc_out``, a differentiable input
    of every layer: under the recomputing policies an input of
    ``_Recompute``, which returns its gradient): layer l gathers the
    shards ``leaf[l]`` through their plans (norm scales straight to fp32,
    where ``rms_norm`` reads them; the gradient summed over 'model' too
    where ``sublayers.model_summed`` says so from the defs) and applies
    the group, tensor-parallel over 'model' (``tpc``), under the
    activation ``policy`` (``SystemConfig.activation_policy``: save_all
    keeps what autograd saves; the others recompute the group in its
    backward, ``_Recompute``; the MoE dispatches ``moe_token_chunk``
    tokens at a time). The segment runs its own schedule, so the
    prefetch ring starts again at ``start``; with ``placement`` "device"
    host-placed caches wait on the device (``ParamGather.promoted``).
    Returns (x, the segment's aux-loss sum, fp32: the MoE sublayers',
    zero without one), as the JAX group body carries it. The JAX
    package differentiates its layer scan's carry at
    every layer, even when no gradient flows into the stack's input (a
    frozen embedding under PEFT); so does this loop, which makes the
    first layer's frozen weights needed, and rebuilt, in the backward
    there too."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    leaves = [(f"pos{i}", kind) for i, kinds in enumerate(plan)
              for kind in kinds]
    names = [(key, kind, n) for key, kind in leaves
             for n in stacked_params[key][kind] if not _unread(kind, n)]
    def issue(i):
        layer = start + i
        slot = {}
        for key, kind, n in names:
            p = stacked_plans[key][kind][n]
            if _in_ring(p):
                slot[key, kind, n] = gather.issue_stage1(
                    stacked_params[key][kind][n][layer], p)
        return slot

    def body(h, weights, tape=None):
        """The group on input h with the gathered weights, in ``names``
        order (a fused plan's as its stage-1 tensor), after ``enc_out``
        where there is one, its sublayers'
        closing collectives through ``tape``; returns (h, aux). A fused
        weight is a sublayer's output projection, feeding the
        sublayer's closing collective: in the recompute its ring runs
        only where the tape reads that collective's input, or where the
        backward reads the product itself (the channel-mix's ``w_v``,
        whose reduce-scattered product the gate's gradient reads)."""
        t = tpc if tape is None else dataclasses.replace(tpc, tape=tape)
        replay = tape is not None and tape.next is not None
        enc = None
        if enc_out is not None:
            enc, weights = weights[0], weights[1:]
        p = {}
        for (key, kind, n), w in zip(names, weights):
            if fused[key, kind, n]:
                w = FusedParam(w, stacked_plans[key][kind][n], gather.coll,
                               not replay or kind == "rwkv_cm"
                               or tape.reads(leaves.index((key, kind))))
            p.setdefault((key, kind), {})[n] = w
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for key, kind in leaves:
            h, a = apply_sublayer_train(kind, cfg, p[key, kind], h,
                                        positions, lora_scale, t,
                                        moe_token_chunk, causal, enc)
            if a is not None:
                aux = aux + a
        return h, aux

    fused = {}

    def compute(i, slot):
        nonlocal x, aux_sum
        layer = start + i
        with gather.layer():
            weights = [] if enc_out is None else [enc_out]
            for key, kind, n in names:
                w = gather(stacked_params[key][kind][n][layer],
                           stacked_plans[key][kind][n],
                           torch.float32 if n in sl.FP32_READ else None,
                           sl.model_summed(stacked_defs[key][kind], n, tpc,
                                           kind),
                           slot.get((key, kind, n)) if slot else None)
                fused[key, kind, n] = isinstance(w, FusedParam)
                weights.append(w.cache if fused[key, kind, n] else w)
            if policy == "save_all":
                x, a = body(x, weights)
            else:
                tape = CollectiveTape(keep=policy == "save_collectives")
                x, a = _Recompute.apply(body, tape, x, *weights)
            aux_sum = a if aux_sum is None else aux_sum + a

    aux_sum = None
    with gather.promoted(placement == "device"):
        gather.scheduler.run(n_groups - start, issue, compute)
    return x, aux_sum
