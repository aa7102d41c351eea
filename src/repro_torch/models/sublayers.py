"""Sublayer library: ParamDefs and apply functions of the dense
family's attention and GLU-MLP sublayers (serving over the paged cache,
and training) with the paged attention state, and of the ssm family's
RWKV-6 time-mix and channel-mix (full-sequence, prefill and decode over
the recurrent state). The defs carry the JAX package's tensor-parallel
tags (q/o head-parallel, k/v replicated; mlp in/gate column-, out
row-parallel; rwkv heads over 'tp'); at tp 1 nothing is sharded by
them, and the JAX package's tensor-parallel steps of these sublayers
(``psum_tp``, head padding ``pad_heads`` and its ``local_head_mask``,
the channel-mix's ``psum_scatter`` / ``all_gather_invariant`` pair) are
the identity and are left out."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import ParamDef
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import act_fn, matmul, rms_norm


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
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


def attn_paged(cfg, p, x, state, positions, table):
    """Attention over the paged KV cache: one decode token (x: [B,1,D])
    or one prefill chunk (x: [B,C,D]) per call. positions: [B,S] per-row
    absolute positions; table: [B, max_pages] page ids. The pools in
    ``state`` are updated in place."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    y, (pk, pv) = attn_mod.attention_block(
        h, p["wq"], p["wk"], p["wv"], p["wo"],
        p.get("bq"), p.get("bk"), p.get("bv"), cfg, positions,
        paged_kv=(state["k"], state["v"], table))
    return x + y, {"k": pk, "v": pv}


def attn_train(cfg, p, x, positions):
    """Causal self-attention sublayer of the train step (under
    autograd)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + attn_mod.attention_train(
        h, p["wq"], p["wk"], p["wv"], p["wo"], p.get("bq"), p.get("bk"),
        p.get("bv"), cfg, positions)


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


def mlp_apply(cfg, p, x):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if "w_gate" in p:
        z = act_fn(cfg.act)(h @ p["w_gate"]) * (h @ p["w_in"])
    else:
        z = act_fn(cfg.act)(h @ p["w_in"])
    return x + matmul(z, p["w_out"])


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================
# The token-shift carry ``xprev`` is stored in bf16 whatever the compute
# dtype, as the JAX package stores it (sublayers.py:783-851 round it
# with ``.astype(BF16)``); decode reads it back in the compute dtype. It
# carries the normed input h of the sublayer, not the residual x: the
# *_prefill / *_decode functions norm first and shift inside the core.

DDLERP_RANK = 32    # the JAX package fixes the ddlerp rank whatever the width


def rwkv_tm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    rc = cfg.rwkv
    d = cfg.d_model
    da = (d // rc.head_dim) * rc.head_dim       # attention width (tp 1)
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
