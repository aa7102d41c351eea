"""Sublayer library: ParamDefs and apply functions of the attention
sublayer (serving over the paged or the contiguous KV cache, and
training; non-causal without a cache for the encoder) with both
caches' state, the encoder-decoder's cross-attention over the encoder's
K/V, the GLU-MLP, the GShard MoE, the
Mamba mixer (full-sequence, prefill and decode over the recurrent
state) and the ssm family's RWKV-6 time-mix and channel-mix. The defs
carry the JAX package's tensor-parallel tags (q/o head-parallel, k/v
replicated; mlp in/gate column-, out row-parallel; experts over 'tp';
mamba's d_inner and the rwkv heads over 'tp').

The train sublayers (``attn_train``, ``xattn_train``, ``mlp_apply``,
``moe_train``, ``mamba_train``, ``rwkv_tm_train``, ``rwkv_cm_train``) run
tensor-parallel over 'model' (``models/common.py``), as the JAX
package's apply functions do: the q and rwkv heads padded to a multiple
of tp (``pad_heads``), the MoE's tokens split over 'model' and its
experts sharded there (expert parallelism, two ``all_to_all``s), the
casts of invariant values that meet 'model'-sharded weights where the
JAX typing puts them (``pvary_tp``), and each sublayer ending in its
collective over 'model' (a sum, or the MoE's and the channel-mix's
invariant all-gather); at tp 1 all of it is the identity. Serving runs
at tp 1."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import ParamDef
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (SERIAL, TPContext,
                                       all_gather_invariant_tp,
                                       all_to_all_tp, kept, local_head_mask,
                                       pad_heads, psum_scatter_tp, psum_tp,
                                       psum_tp_act, psum_tp_out, pvary_tp,
                                       region_vary, tp_region_in)
from repro_torch.models.layers import act_fn, matmul, rms_norm


def attn_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, ParamDef]:
    """The q heads padded to a multiple of ``tp``."""
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    qd, kvd = pad_heads(cfg.num_heads, tp) * hd, cfg.num_kv_heads * hd
    out: Dict[str, ParamDef] = {
        "wq": ParamDef((d, qd), ("fsdp", "tp")),
        "wk": ParamDef((d, kvd), ("fsdp", None)),
        "wv": ParamDef((d, kvd), ("fsdp", None)),
        "wo": ParamDef((qd, d), ("tp", "fsdp"), fusable=True),
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((qd,), ("tp",), init="zeros")
        out["bk"] = ParamDef((kvd,), (None,), init="zeros")
        out["bv"] = ParamDef((kvd,), (None,), init="zeros")
    if cfg.frontend == "vq_image":      # chameleon's qk-norm
        out["q_norm"] = ParamDef((hd,), (None,), init="ones")
        out["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return out


def attn_init_paged_state(cfg, n_pages: int, page_size: int,
                          n_groups: int, device) -> Dict[str, torch.Tensor]:
    """Paged KV pools [n_groups, n_pages, page_size, KVH, hd] in bf16,
    stacked over the layer groups. Zeros,
    never uninitialized memory: pages are read (masked) before they are
    written, and 0*NaN from a never-written page would poison a row."""
    shape = (n_groups, n_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _lora_kwargs(p, lora_scale: float) -> Dict:
    """The adapter leaves of a sublayer dict (PEFT) and their scale
    (``core.peft.lora_scale``), as ``attention_block``'s keywords; none
    without adapters. Only attention consumes adapters, as in the JAX
    package: one injected next to an MLP projection goes unused."""
    lora = {k: v for k, v in p.items() if "_lora_" in k}
    return {"lora": lora, "lora_scale": lora_scale} if lora else {}


def attn_paged(cfg, p, x, state, positions, table, lora_scale=2.0):
    """Attention over the paged KV cache: one decode token (x: [B,1,D])
    or one prefill chunk (x: [B,C,D]) per call. positions: [B,S] per-row
    absolute positions; table: [B, max_pages] page ids. The pools in
    ``state`` are updated in place. ``lora_scale``: the adapters'
    scale, where ``p`` holds adapters (as in every attn_*)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (pk, pv) = attn_mod.attention_block(
        h, p["wq"], p["wk"], p["wv"], p["wo"],
        p.get("bq"), p.get("bk"), p.get("bv"), cfg, positions,
        paged_kv=(state["k"], state["v"], table), q_norm=p.get("q_norm"),
        k_norm=p.get("k_norm"), **_lora_kwargs(p, lora_scale))
    return x + y, {"k": pk, "v": pv}


def attn_init_state(cfg, batch: int, max_len: int,
                    device) -> Dict[str, torch.Tensor]:
    """The contiguous KV cache of one layer: k, v [B, max_len, KVH, hd]
    in bf16 whatever the compute dtype (as the JAX package stores it),
    and ``idx`` int32, the written length shared by the batch's rows."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def attn_apply(cfg, p, x, positions, state, lora_scale=2.0):
    """Attention over the contiguous cache from its ``idx`` on: the
    prompt in prefill (positions [1, S] from 0, as the JAX package's
    prefill passes them) or one token in decode (positions [1, 1] =
    idx). K/V are written into ``state`` in place and ``idx`` advances
    by S in place."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, _ = attn_mod.attention_block(
        h, p["wq"], p["wk"], p["wv"], p["wo"],
        p.get("bq"), p.get("bk"), p.get("bv"), cfg, positions,
        kv_cache=(state["k"], state["v"], state["idx"]),
        q_norm=p.get("q_norm"), k_norm=p.get("k_norm"),
        **_lora_kwargs(p, lora_scale))
    return x + y, state


def attn_decode(cfg, p, x, state, lora_scale=2.0):
    """One-token decode over the contiguous cache. x: [B,1,D]."""
    return attn_apply(cfg, p, x, state["idx"].view(1, 1), state,
                      lora_scale)


def attn_encode(cfg, p, x, positions, lora_scale=2.0):
    """Non-causal self-attention without a cache (the encoder's, at
    serving): every position sees every other, nothing is written."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, _ = attn_mod.attention_block(
        h, p["wq"], p["wk"], p["wv"], p["wo"],
        p.get("bq"), p.get("bk"), p.get("bv"), cfg, positions,
        causal=False, q_norm=p.get("q_norm"), k_norm=p.get("k_norm"),
        **_lora_kwargs(p, lora_scale))
    return x + y


def attn_train(cfg, p, x, positions, lora_scale=2.0,
               tpc: TPContext = SERIAL, causal: bool = True):
    """Self-attention sublayer of the train step (under autograd),
    tensor-parallel over 'model': causal, or not (the encoder's)."""
    h = tp_region_in(rms_norm(x, p["norm"], cfg.norm_eps), tpc)
    y = attn_mod.attention_train(
        h, p["wq"], p["wk"], p["wv"], p["wo"], p.get("bq"), p.get("bk"),
        p.get("bv"), cfg, positions, tpc=tpc, q_norm=p.get("q_norm"),
        k_norm=p.get("k_norm"), causal=causal,
        **_lora_kwargs(p, lora_scale))
    return x + psum_tp_act(y, tpc)


# ===========================================================================
# Cross-attention (encoder-decoder)
# ===========================================================================

def xattn_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, ParamDef]:
    """``attn_defs`` without the biases and the qk-norm: wq / wo
    head-parallel over 'model', wk / wv replicated there, wo
    ``fusable``."""
    d = attn_defs(cfg, tp)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        d.pop(name, None)
    return d


def xattn_init_state(cfg, batch: int, enc_len: int,
                     device) -> Dict[str, torch.Tensor]:
    """The encoder's K/V of one cross-attention layer: k, v [B, enc_len,
    KVH, hd] in bf16 whatever the compute dtype, as the JAX package
    stores them; the prefill fills them, the decode steps read them."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def xattn_make_kv(cfg, p, enc_out: torch.Tensor):
    """The encoder output [B, Senc, D] projected once into this layer's
    k, v [B, Senc, KVH, hd] (no RoPE, no bias)."""
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    return k, v


def xattn_apply(cfg, p, x, enc_kv):
    """Cross-attention at serving: x [B, S, D] (the prompt, or one
    token) attends over the encoder's ``enc_kv`` = (k, v) [B, Senc, KVH,
    hd] through the flash kernel, non-causal. It consumes no adapter,
    as in the JAX package."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, -1, hd)
    out = attn_mod.cross_attention(q, *enc_kv)
    return x + matmul(out.reshape(B, S, -1), p["wo"])


def xattn_train(cfg, p, x, enc_out, tpc: TPContext = SERIAL):
    """Cross-attention sublayer of the train step (under autograd),
    tensor-parallel over 'model' as the JAX package's ``xattn_apply``
    runs it: the normed input and the encoder's k / v are the same on
    every rank, so each is cast where it meets this rank's heads
    (``pvary_tp``: wq's input, and the k / v slice, whose gradients, and
    with them ``enc_out``'s, are summed over 'model'); no int8 region;
    the sublayer closes with an exact sum over 'model'
    (``psum_tp_out``), never the int8 all-reduce. No adapter is
    consumed."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = pvary_tp(h, tpc) @ p["wq"]
    h_local = q.shape[-1] // hd
    q = q.reshape(B, S, h_local, hd)
    k, v = xattn_make_kv(cfg, p, enc_out)
    padded = h_local * tpc.tp
    k, v = attn_mod.slice_expand_kv(pvary_tp(k, tpc), pvary_tp(v, tpc),
                                    h_local, padded // cfg.num_kv_heads,
                                    tpc.rank)
    out = attn_mod.chunked_causal_attention(q, k, v, causal=False)
    if padded != cfg.num_heads:
        mask = local_head_mask(tpc, padded, cfg.num_heads, out.device)
        out = out * mask[None, None, :, None].to(out.dtype)
    y = matmul(out.reshape(B, S, h_local * hd), p["wo"])
    return x + psum_tp_out(y, tpc)


# the sublayers' leaves read in fp32 (the norm scales, rwkv's u and
# ln_x, Mamba's A_log and D_skip): gathered in fp32, so a replicated
# one's gradient is summed after the cast, in fp32, where the JAX step's
# typing sums it
FP32_READ = frozenset({"norm", "q_norm", "k_norm", "ln_x", "u", "A_log",
                       "D_skip"})


def model_summed(defs: Dict[str, ParamDef], name: str,
                 tpc: TPContext, kind: str = "attn") -> bool:
    """Whether the gradient of leaf ``name`` of a ``kind`` sublayer
    (``defs``: the sublayer's defs) is summed over 'model': where the
    JAX step's typing casts the weight to 'model'-varying. That is a
    leaf replicated over 'model' (no 'tp' dim) that meets varying
    values: the MoE's router (it routes this rank's share of the
    tokens); in attention and the MLP, inside an int8 region every leaf
    but the norm scale, which is read before the region begins, and
    otherwise the qk-norm's ``q_norm`` (it scales this rank's q heads;
    ``k_norm`` scales k, the same on every rank) and an adapter's
    ``lora_b`` whose ``lora_a`` is 'model'-sharded (the row-parallel
    projection's adapter, whose product varies). The recurrent mixers'
    replicated leaves meet only invariant values (their casts are on
    activations)."""
    if tpc.tp == 1 or defs[name].tp_dim is not None or name == "norm":
        return False
    if kind == "moe":
        return True
    if kind not in ("attn", "mlp"):
        return False
    if tpc.int8_act or name == "q_norm":
        return True
    if name.endswith("_lora_b"):
        a = defs.get(name[:-1] + "a")
        return a is not None and a.tp_dim is not None
    return False


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    out = {
        "w_in": ParamDef((d, f), ("fsdp", "tp")),
        "w_out": ParamDef((f, d), ("tp", "fsdp"), fusable=True),
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
    }
    if cfg.act in ("swiglu", "geglu"):
        out["w_gate"] = ParamDef((d, f), ("fsdp", "tp"))
    return out


def mlp_apply(cfg, p, x, tpc: TPContext = SERIAL):
    """The GLU (or plain) MLP: in/gate column-parallel, out row-parallel
    over 'model'. Outside an int8 region the normed input is the same on
    every rank, and each column-parallel matmul sums its share of the
    input's gradient over 'model' on its own (two sums, as the JAX step
    casts the input once per matmul)."""
    h = tp_region_in(rms_norm(x, p["norm"], cfg.norm_eps), tpc)
    up = region_vary(h, tpc) @ p["w_in"]
    if "w_gate" in p:
        z = act_fn(cfg.act)(region_vary(h, tpc) @ p["w_gate"]) * up
    else:
        z = act_fn(cfg.act)(up)
    return x + psum_tp_act(matmul(z, p["w_out"]), tpc)


# ===========================================================================
# MoE (GShard-style capacity dispatch, expert parallelism over 'model')
# ===========================================================================

# tokens of one dispatch (its [E, C, D] buffer), the JAX package's
# SystemConfig.moe_token_chunk default
MOE_TOKEN_CHUNK = 8192


def moe_defs(cfg: ModelConfig,
             weight_resident: bool = False) -> Dict[str, ParamDef]:
    """The router and the experts, sharded over 'model' on their first
    dim (expert parallelism). ``weight_resident``
    (``SystemConfig.moe_weight_resident``, as in the JAX package) gives
    the experts ``fsdp_scope`` 'inter_only': sharded over 'pod' only,
    each pod's shard resident."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_ff_expert, m.num_experts
    scope = "inter_only" if weight_resident else "full"
    return {
        "router": ParamDef((d, e), ("fsdp", None), init_scale=0.1),
        "we_in": ParamDef((e, d, fe), ("tp", "fsdp", None),
                          fsdp_scope=scope),
        "we_gate": ParamDef((e, d, fe), ("tp", "fsdp", None),
                            fsdp_scope=scope),
        "we_out": ParamDef((e, fe, d), ("tp", None, "fsdp"),
                           fsdp_scope=scope),
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
    }


def moe_capacity(cfg, chunk: int) -> int:
    """Slots per expert for a dispatch of ``chunk`` tokens: chunk x top_k
    / E x capacity_factor, rounded up to a multiple of 4 (at least 4)."""
    m = cfg.moe
    capacity = int(math.ceil(chunk * m.top_k / m.num_experts
                             * m.capacity_factor))
    return max(4, ((capacity + 3) // 4) * 4)


def _dispatch_indices(eid_flat: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each (token, slot) within its expert's capacity
    buffer, in slot order (a stable sort by expert), and whether it
    fits."""
    n = eid_flat.shape[0]
    order = torch.argsort(eid_flat, stable=True)
    sorted_e = eid_flat[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=eid_flat.device) - first
    return pos, pos < capacity


def _route(cfg, p, x_flat: torch.Tensor):
    """Router: (probs [T,E] fp32, gate values [T,k] renormalised, expert
    ids [T,k]). The logits are ``x @ router`` in the compute dtype, then
    fp32. The top k by a stable descending sort: equal probabilities go
    to the lower expert id, as ``jax.lax.top_k`` orders them."""
    k = cfg.moe.top_k
    logits = (x_flat @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eid = gate_vals[:, :k], eid[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, eid


def _moe_chunk(cfg, p, x_flat: torch.Tensor, capacity: int,
               with_aux: bool, tpc: TPContext = SERIAL):
    """x_flat: [T, D] tokens; returns ([T, D], aux_loss_sum or None).
    The experts' buffer crosses 'model' and back: [E, C, D] goes out as
    tp blocks of E/tp experts, and this rank's E/tp experts take the
    [E/tp, tp*C, D] slots of every rank (the JAX package's tiled
    ``all_to_all`` with split axis 0 and concat axis 1, then the
    inverse)."""
    m = cfg.moe
    E, k, tp = m.num_experts, m.top_k, tpc.tp
    T, D = x_flat.shape
    probs, gate_vals, eid = _route(cfg, p, x_flat)
    eid_flat = eid.reshape(-1)                                # [T*k]
    pos, keep = _dispatch_indices(eid_flat, capacity)
    # scatter tokens into [E+1, C, D]; dropped slots go to the dummy row E
    zero = torch.zeros_like(pos)
    e_idx = torch.where(keep, eid_flat, torch.full_like(eid_flat, E))
    p_idx = torch.where(keep, pos, zero)
    x_slots = x_flat.repeat_interleave(k, dim=0)              # [T*k, D]
    buf = torch.zeros((E + 1, capacity, D), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf[e_idx, p_idx] = torch.where(keep[:, None], x_slots,
                                    torch.zeros_like(x_slots))
    buf = all_to_all_tp(buf[:E], tpc)                         # [E, C, D]
    e_loc = E // tp
    buf = (buf.reshape(tp, e_loc, capacity, D).transpose(0, 1)
           .reshape(e_loc, tp * capacity, D))
    h = torch.bmm(buf, p["we_in"])
    g = torch.bmm(buf, p["we_gate"])
    z = act_fn(cfg.act)(g) * h
    y = torch.bmm(z, p["we_out"])                   # [E/tp, tp*C, D]
    y = (y.reshape(e_loc, tp, capacity, D).transpose(0, 1)
         .reshape(E, capacity, D))
    y = all_to_all_tp(y, tpc)                                 # [E, C, D]
    # combine
    gathered = y[torch.where(keep, eid_flat, zero), p_idx]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    out = (gathered.reshape(T, k, D)
           * gate_vals[..., None].to(y.dtype)).sum(dim=1)
    if not with_aux:
        return out, None
    # load-balance aux loss (GShard): E * sum_e f_e * p_e, sum-scaled
    ones = torch.zeros((T, E), dtype=torch.float32, device=x_flat.device)
    ones.scatter_(1, eid, 1.0)
    f_e = ones.mean(dim=0) / k
    p_e = probs.mean(dim=0)
    return out, E * (f_e * p_e).sum() * T


def _moe_chunks(cfg, p, h_flat: torch.Tensor, token_chunk: int,
                with_aux: bool, tpc: TPContext = SERIAL):
    """The tokens [T, D] dispatched in chunks of ``token_chunk`` when it
    divides them into several, else all at once; each chunk's capacity
    comes from its own size. Returns ([T, D], the chunks' aux sum or
    None)."""
    T = h_flat.shape[0]
    chunk = min(token_chunk, T)
    n = T // chunk if T % chunk == 0 else 1
    if n == 1:
        chunk = T
    capacity = moe_capacity(cfg, chunk)
    outs, aux = [], None
    for c in range(n):
        out_c, aux_c = _moe_chunk(cfg, p, h_flat[c * chunk:(c + 1) * chunk],
                                  capacity, with_aux, tpc)
        outs.append(out_c)
        if with_aux:
            aux = aux_c if aux is None else aux + aux_c
    return (outs[0] if n == 1 else torch.cat(outs)), aux


def moe_apply(cfg, p, x, token_chunk: int = MOE_TOKEN_CHUNK,
              with_aux: bool = False):
    """x: [B, S, D] -> (x + MoE(x), aux loss, or None unless
    ``with_aux``: serving drops it), on one rank."""
    B, S, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    out, aux = _moe_chunks(cfg, p, h.reshape(B * S, D), token_chunk,
                           with_aux)
    aux = aux * cfg.moe.aux_loss_weight if with_aux else None
    return x + out.reshape(B, S, D).to(x.dtype), aux


def moe_train(cfg, p, x, tpc: TPContext = SERIAL,
              token_chunk: int = MOE_TOKEN_CHUNK):
    """The MoE sublayer of the train step, as the JAX package's
    ``moe_apply``: the B*S tokens padded to a multiple of tp and split
    over 'model' (each rank dispatches its own share, cast to
    'model'-varying first), dispatched in chunks through the experts of
    every rank (``_moe_chunk``), and put back together by the invariant
    all-gather; the aux loss summed over 'model' and scaled by
    ``aux_loss_weight``. Returns (x + MoE(x), aux fp32).

    The JAX chunk runs under ``jax.checkpoint(nothing_saveable)``, but
    the layer's save_all policy saves matmul and ``all_to_all`` outputs
    (``src/repro/core/fcdp.py:make_remat_policy``'s SAVE_PRIMS) and
    wins, so the JAX backward runs no ``all_to_all`` again (its trace: 4
    a layer, the 2 of the forward and their 2 transposes). Autograd
    keeps the same values here; a recomputing activation policy reruns
    the whole layer (``models/stack.py``)."""
    B, S, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    t_orig = B * S
    h_flat = h.reshape(t_orig, D)
    t_pad = -(-t_orig // tpc.tp) * tpc.tp
    if t_pad != t_orig:
        h_flat = F.pad(h_flat, (0, 0, 0, t_pad - t_orig))
    t = t_pad // tpc.tp
    h_flat = pvary_tp(h_flat, tpc)[tpc.rank * t:(tpc.rank + 1) * t]
    out, aux = _moe_chunks(cfg, p, h_flat, token_chunk, True, tpc)
    out = all_gather_invariant_tp(out, tpc, 0)[:t_orig]
    # a recomputing policy's backward reads no aux value, only its
    # gradient (the sum's: the identity), so its recompute sums nothing
    replay = tpc.tape is not None and tpc.tape.next is not None
    aux = (aux if replay else psum_tp(aux, tpc)) * cfg.moe.aux_loss_weight
    return x + out.reshape(B, S, D).to(x.dtype), aux


# ===========================================================================
# Mamba (selective scan; for Jamba)
# ===========================================================================
# The conv state is stored in bf16 whatever the compute dtype, as the
# JAX package stores it (sublayers.py:606,624); the scan state h stays
# fp32. The scan runs in ``ops.mamba_scan``: the CUDA kernel on the card
# (prefill from zeros, decode from the carried h), the sequential plain
# version on the CPU. Training runs it through ``ops.mamba_scan_train``,
# whose backward is the adjoint scan on the same kernel.

def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    dt_rank = mc.dt_rank or -(-d // 16)
    ns = mc.d_state
    return {
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
        "in_proj": ParamDef((d, 2 * d_in), ("fsdp", "tp")),
        "conv_w": ParamDef((d_in, mc.d_conv), ("tp", None), init_scale=0.5),
        "conv_b": ParamDef((d_in,), ("tp",), init="zeros"),
        "x_proj": ParamDef((d_in, dt_rank + 2 * ns), ("tp", None)),
        "dt_proj": ParamDef((dt_rank, d_in), (None, "tp")),
        "dt_bias": ParamDef((d_in,), ("tp",), init="zeros"),
        "A_log": ParamDef((d_in, ns), ("tp", None), init="ones"),
        "D_skip": ParamDef((d_in,), ("tp",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("tp", "fsdp"), fusable=True),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``: max(x, 0) + log1p(exp(-|x|))), with no switch to x above a
    threshold as ``torch.nn.functional.softplus`` has."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _mamba_core(cfg, p, xz, conv_state=None, h_state=None,
                tpc: TPContext = SERIAL, train: bool = False):
    """xz: [B, S, 2*d_in] (this rank's d_in channels at tp > 1). Returns
    (y [B,S,d_in], (conv state [B, d_conv - 1, d_in] in xz's dtype, h
    [B, d_in, d_state] fp32)). At tp > 1, as in the JAX package: the
    x_proj partial summed over 'model' (its dt, B and C then the same on
    every rank) and cast back where they meet this rank's channels.
    ``train`` differentiates the scan (``ops.mamba_scan_train``)."""
    mc = cfg.mamba
    ns = mc.d_state
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    B, S, _ = xz.shape
    x, z = xz.chunk(2, dim=-1)
    d_in = x.shape[-1]
    # causal depthwise conv (k = d_conv)
    k = mc.d_conv
    if conv_state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv_state = x_pad[:, -(k - 1):] if k > 1 else None
    idx = (torch.arange(S, device=xz.device)[:, None]
           + torch.arange(k, device=xz.device)[None, :])
    xs = x_pad[:, idx]                                    # [B,S,k,d_in]
    xc = F.silu(torch.einsum("bskd,dk->bsd", xs, p["conv_w"]) + p["conv_b"])
    xdb = kept(xc @ p["x_proj"], tpc,
               lambda t: psum_tp(t, tpc))                 # [B,S,r+2n]
    dt_in, Bc, Cc = torch.split(xdb, [dt_rank, ns, ns], dim=-1)
    dt = softplus(pvary_tp(dt_in, tpc) @ p["dt_proj"]
                  + p["dt_bias"])                         # [B,S,d_in]
    A = -torch.exp(p["A_log"].float())                    # [d_in, ns]
    dtf, xcf = dt.float(), xc.float()
    a = (dtf[..., None] * A).exp_()                       # [B,S,d_in,ns]
    b = (dtf * xcf)[..., None] * pvary_tp(Bc.float()[..., None, :], tpc)
    h0 = None if h_state is None else h_state.reshape(B, d_in * ns)
    scan = ops.mamba_scan_train if train else ops.mamba_scan
    hs = scan(a.view(B, S, d_in * ns), b.view(B, S, d_in * ns),
              h0).view(B, S, d_in, ns)
    del a, b
    h_last = hs[:, -1].contiguous()
    y = torch.einsum("bsdn,bsn->bsd", hs, pvary_tp(Cc.float(), tpc))
    y = y + p["D_skip"].float() * xcf
    y = (y * F.silu(z.float())).to(xz.dtype)
    return y, (new_conv_state, h_last)


def mamba_prefill(cfg, p, x):
    """Full-prompt forward from zero state (the incoming state is not
    read, as in the JAX package); returns the state."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (conv_s, h_s) = _mamba_core(cfg, p, h @ p["in_proj"])
    return (x + matmul(y, p["out_proj"]),
            {"conv": conv_s.to(torch.bfloat16), "h": h_s})


def mamba_train(cfg, p, x, tpc: TPContext = SERIAL):
    """The Mamba sublayer of the train step, tensor-parallel over
    'model' (d_inner sharded), as the JAX package's ``mamba_apply``: the
    normed input cast to 'model'-varying where it meets ``in_proj`` (an
    exact sum of its gradient, even under act_psum "int8": the JAX
    mixer opens no int8 region), the scan differentiated through its
    adjoint kernel, ``out_proj`` through the gather-fused ring where its
    plan says so, and the output summed over 'model' (``psum_tp_act``,
    int8 under act_psum "int8")."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, _ = _mamba_core(cfg, p, pvary_tp(h, tpc) @ p["in_proj"], tpc=tpc,
                       train=True)
    return x + psum_tp_act(matmul(y, p["out_proj"]), tpc)


def mamba_init_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {"conv": torch.zeros(batch, mc.d_conv - 1, d_in,
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros(batch, d_in, mc.d_state, dtype=torch.float32,
                             device=device)}


def mamba_decode(cfg, p, x, state):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (conv_s, h_s) = _mamba_core(cfg, p, h @ p["in_proj"],
                                   conv_state=state["conv"],
                                   h_state=state["h"])
    return (x + matmul(y, p["out_proj"]),
            {"conv": conv_s.to(torch.bfloat16), "h": h_s})


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================
# The token-shift carry ``xprev`` is stored in bf16 whatever the compute
# dtype, as the JAX package stores it (sublayers.py:783-851 round it
# with ``.astype(BF16)``); decode reads it back in the compute dtype. It
# carries the normed input h of the sublayer, not the residual x: the
# *_prefill / *_decode functions norm first and shift inside the core.

DDLERP_RANK = 32    # the JAX package fixes the ddlerp rank whatever the width


def rwkv_tm_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, ParamDef]:
    """The heads padded to a multiple of ``tp``."""
    rc = cfg.rwkv
    d = cfg.d_model
    da = pad_heads(d // rc.head_dim, tp) * rc.head_dim  # attention width
    lr = rc.decay_lora
    return {
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
        # rows x, w, k, v, r, g
        "maa_base": ParamDef((6, d), (None, "fsdp"), init="zeros"),
        "maa_w1": ParamDef((d, 5 * DDLERP_RANK), ("fsdp", None),
                           init="zeros"),
        "maa_w2": ParamDef((5, DDLERP_RANK, d), (None, None, "fsdp"),
                           init_scale=0.1),
        "w_r": ParamDef((d, da), ("fsdp", "tp")),
        "w_k": ParamDef((d, da), ("fsdp", "tp")),
        "w_v": ParamDef((d, da), ("fsdp", "tp")),
        "w_g": ParamDef((d, da), ("fsdp", "tp")),
        "decay_base": ParamDef((da,), ("tp",), init="zeros"),
        "decay_w1": ParamDef((d, lr), ("fsdp", None), init="zeros"),
        "decay_w2": ParamDef((lr, da), (None, "tp"), init_scale=0.1),
        "u": ParamDef((da,), ("tp",), init="zeros"),
        "ln_x": ParamDef((da,), ("tp",), init="ones"),
        "w_o": ParamDef((da, d), ("tp", "fsdp"), fusable=True),
    }


def _token_shift(x: torch.Tensor,
                 xprev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B,S,D] -> the previous token's row at every position; the
    first position takes ``xprev_last`` [B,D] (None = zeros)."""
    first = (torch.zeros_like(x[:, :1]) if xprev_last is None
             else xprev_last[:, None])
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_mix(p, x: torch.Tensor, prev: torch.Tensor):
    """Data-dependent lerp (ddlerp) producing the 5 mixed inputs xw, xk,
    xv, xr, xg (``maa_base`` rows 1..5 in that order; row 0 mixes the
    input of the ddlerp LoRA)."""
    dx = prev - x
    mx = x + dx * p["maa_base"][0]
    k5 = torch.tanh(mx @ p["maa_w1"])                   # [B,S,5*32]
    B, S, _ = k5.shape
    k5 = k5.reshape(B, S, 5, DDLERP_RANK)
    deltas = torch.einsum("bsfr,frd->bsfd", k5, p["maa_w2"])  # [B,S,5,D]
    return [x + dx * (p["maa_base"][i + 1] + deltas[:, :, i])
            for i in range(5)]


def _group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """x: [B,S,H,hd] normalized per head in fp32 (rwkv's ln_x), times
    scale [H*hd]; [B,S,H*hd] in x's dtype. ``eps`` is the model's
    ``norm_eps``, as in the JAX package."""
    B, S, H, hd = x.shape
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(B, S, H * hd) * scale.float()).to(x.dtype)


def _rwkv_tm_core(cfg, p, x, xprev_last=None, s0=None):
    """Time-mix of the normed input x [B,S,D]: returns (y [B,S,D],
    (x[:, -1], final WKV state)). The WKV runs in ``ops.wkv6``: the CUDA
    kernel on the card, the chunked plain version on the CPU."""
    hd = cfg.rwkv.head_dim
    B, S, D = x.shape
    h = p["w_r"].shape[1] // hd
    prev = _token_shift(x, xprev_last)
    xw, xk, xv, xr, xg = _rwkv_mix(p, x, prev)
    r = (xr @ p["w_r"]).reshape(B, S, h, hd)
    k = (xk @ p["w_k"]).reshape(B, S, h, hd)
    v = (xv @ p["w_v"]).reshape(B, S, h, hd)
    g = F.silu(xg @ p["w_g"])
    # the decay's sum is taken in the compute dtype and cast after; logw
    # and u reach the WKV in fp32, r/k/v in the compute dtype
    logw = -torch.exp((p["decay_base"] + torch.tanh(xw @ p["decay_w1"])
                       @ p["decay_w2"]).float()).reshape(B, S, h, hd)
    u = p["u"].float().reshape(h, hd)
    # s0 is the carried state of a decode step (S = 1, chunk 1). The
    # Pallas kernel always starts from zeros; the CUDA kernel takes s0,
    # so decode runs it as well as prefill.
    out, s_new = ops.wkv6(r, k, v, logw, u, s0=s0)
    out = _group_norm_heads(out, p["ln_x"], cfg.norm_eps)
    out = out * g.to(out.dtype)
    return matmul(out, p["w_o"]), (x[:, -1], s_new)


class _Recomputed(torch.autograd.Function):
    """``fn(*inputs)`` keeping only its inputs for the backward, which
    runs ``fn`` again under autograd and differentiates it (the JAX
    package's ``jax.checkpoint(..., nothing_saveable)`` of one
    function)."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.fn(*ins)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None,) + tuple(next(grads) if n else None for n in need)


def wkv_chunked(r, k, v, logw, u, chunk: int = 64):
    """RWKV-6 WKV from zero state, chunked, under autograd: the JAX
    package's ``models/sublayers._wkv_chunked``, which its train step
    differentiates (under ``jax.checkpoint(nothing_saveable)``; here
    ``_Recomputed``), in its torch port ``kernels.ref.wkv6_plain``. No
    kernel runs here, because the JAX train path runs none either: the
    Pallas WKV kernel has no VJP, and neither package has a backward WKV
    kernel. Serving calls ``ops.wkv6``.

    r, k, v: [B,S,H,hd]; logw: [B,S,H,hd] (log decay, <= 0); u: [H,hd].
    Returns [B,S,H,hd] in r's dtype."""
    return _Recomputed.apply(
        lambda *t: ref.wkv6_plain(*t, chunk=chunk)[0], r, k, v, logw, u)


def rwkv_tm_train(cfg, p, x, tpc: TPContext = SERIAL):
    """The time-mix sublayer of the train step, as the JAX package's
    ``rwkv_tm_apply``: the heads padded to tp and split over 'model'
    (the padding heads' output masked, ``local_head_mask``), the mixed
    inputs cast to 'model'-varying where they meet this rank's heads,
    the WKV differentiated under recompute (``wkv_chunked``), ``w_o``
    through the gather-fused ring where its plan says so, and the output
    summed over 'model', exactly under either act_psum (the JAX mixer
    calls ``psum_tp``)."""
    hd = cfg.rwkv.head_dim
    n_heads = cfg.d_model // hd
    hp = pad_heads(n_heads, tpc.tp)
    h_local = hp // tpc.tp
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    B, S, D = h.shape
    xw, xk, xv, xr, xg = _rwkv_mix(p, h, _token_shift(h))
    r = (pvary_tp(xr, tpc) @ p["w_r"]).reshape(B, S, h_local, hd)
    k = (pvary_tp(xk, tpc) @ p["w_k"]).reshape(B, S, h_local, hd)
    v = (pvary_tp(xv, tpc) @ p["w_v"]).reshape(B, S, h_local, hd)
    g = F.silu(pvary_tp(xg, tpc) @ p["w_g"])
    logw = -torch.exp((p["decay_base"] + pvary_tp(
        torch.tanh(xw @ p["decay_w1"]), tpc) @ p["decay_w2"]).float()
    ).reshape(B, S, h_local, hd)
    u = p["u"].float().reshape(h_local, hd)
    out = wkv_chunked(r, k, v, logw, u)
    if hp != n_heads:
        mask = local_head_mask(tpc, hp, n_heads, out.device)
        out = out * mask[None, None, :, None].to(out.dtype)
    out = _group_norm_heads(out, p["ln_x"], cfg.norm_eps)
    out = out * g.to(out.dtype)
    return x + psum_tp_out(matmul(out, p["w_o"]), tpc)


def rwkv_tm_apply(cfg, p, x):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, _ = _rwkv_tm_core(cfg, p, h)
    return x + y


def rwkv_tm_prefill(cfg, p, x):
    """Full-prompt forward from zero state and zero shift (the incoming
    state is not read, as in the JAX package); returns the state."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (xlast, s_new) = _rwkv_tm_core(cfg, p, h)
    return x + y, {"xprev": xlast.to(torch.bfloat16), "s": s_new}


def rwkv_tm_init_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    hd = cfg.rwkv.head_dim
    return {"xprev": torch.zeros(batch, cfg.d_model, dtype=torch.bfloat16,
                                 device=device),
            "s": torch.zeros(batch, cfg.d_model // hd, hd, hd,
                             dtype=torch.float32, device=device)}


def rwkv_tm_decode(cfg, p, x, state):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (xlast, s_new) = _rwkv_tm_core(
        cfg, p, h, xprev_last=state["xprev"].to(h.dtype), s0=state["s"])
    return x + y, {"xprev": xlast.to(torch.bfloat16), "s": s_new}


def rwkv_cm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamDef((d,), ("fsdp",), init="ones"),
        "mu_k": ParamDef((d,), ("fsdp",), init="zeros"),
        "mu_r": ParamDef((d,), ("fsdp",), init="zeros"),
        "w_k": ParamDef((d, f), ("fsdp", "tp")),
        "w_v": ParamDef((f, d), ("tp", "fsdp"), fusable=True),
        "w_r": ParamDef((d, d), ("fsdp", "tp")),
    }


def _rwkv_cm_core(cfg, p, x, xprev_last=None):
    prev = _token_shift(x, xprev_last)
    dx = prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["w_k"]))
    kv = matmul(kk, p["w_v"])
    gate = torch.sigmoid(xr @ p["w_r"])
    return gate * kv, x[:, -1]


def rwkv_cm_apply(cfg, p, x):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, _ = _rwkv_cm_core(cfg, p, h)
    return x + y


def rwkv_cm_train(cfg, p, x, tpc: TPContext = SERIAL):
    """The channel-mix sublayer of the train step, as the JAX package's
    ``rwkv_cm_apply``: the key column-parallel over 'model', ``w_v``'s
    row-parallel partial reduce-scattered over 'model' on the model dim
    (``w_v`` through the gather-fused ring where its plan says so),
    gated by this rank's receptance columns, and gathered back whole
    (the invariant all-gather).

    The JAX save_all policy lists the reduce-scatter as "psum_scatter",
    but jax 0.9 names the primitive "reduce_scatter", so the JAX
    backward runs it again to read its output (the gate's gradient);
    autograd keeps the output here, so the port moves half the
    reference's 'model' reduce-scatter bytes (a pinned divergence)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    dx = _token_shift(h) - h
    xk = h + dx * p["mu_k"]
    xr = h + dx * p["mu_r"]
    kk = torch.square(F.relu(pvary_tp(xk, tpc) @ p["w_k"]))
    kv = psum_scatter_tp(matmul(kk, p["w_v"]), tpc, 2)      # [B,S,D/tp]
    gate = torch.sigmoid(pvary_tp(xr, tpc) @ p["w_r"])      # [B,S,D/tp]
    return x + all_gather_invariant_tp(gate * kv, tpc, 2)


def rwkv_cm_prefill(cfg, p, x):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, xlast = _rwkv_cm_core(cfg, p, h)
    return x + y, {"xprev": xlast.to(torch.bfloat16)}


def rwkv_cm_init_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    return {"xprev": torch.zeros(batch, cfg.d_model, dtype=torch.bfloat16,
                                 device=device)}


def rwkv_cm_decode(cfg, p, x, state):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, xlast = _rwkv_cm_core(cfg, p, h,
                             xprev_last=state["xprev"].to(h.dtype))
    return x + y, {"xprev": xlast.to(torch.bfloat16)}
