"""Sublayer library of the dense family: ParamDefs and apply functions
of the attention and GLU-MLP sublayers (serving over the paged cache,
and training), and the paged attention state. The defs carry the JAX
package's tensor-parallel tags (q/o head-parallel, k/v replicated; mlp
in/gate column-, out row-parallel); at tp 1 nothing is sharded by
them."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import ParamDef
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
