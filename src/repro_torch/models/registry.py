"""Model registry: a config's model class, as the JAX package's
``models/registry.build_model`` picks it, and the analytic parameter
counts the roofline's model FLOPs use (``launch/roofline.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SystemConfig


def build_model(cfg: ModelConfig, sys: SystemConfig, tp: int = 1):
    """``EncDec`` for a config with encoder layers, ``LM`` otherwise, at
    tensor-parallel degree ``tp``."""
    if cfg.num_encoder_layers > 0:
        from repro_torch.models.encdec import EncDec
        return EncDec(cfg, sys, tp)
    from repro_torch.models.lm import LM
    return LM(cfg, sys, tp)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    b = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd) if cfg.qkv_bias else 0
    return q + kv + o + b + d


def _mlp_params(cfg: ModelConfig) -> int:
    glu = cfg.act in ("swiglu", "geglu")
    return cfg.d_model * cfg.d_ff * (3 if glu else 2) + cfg.d_model


def _moe_params(cfg: ModelConfig, active_only: bool) -> int:
    m = cfg.moe
    e = m.top_k if active_only else m.num_experts
    glu = cfg.act in ("swiglu", "geglu")
    return (cfg.d_model * m.d_ff_expert * (3 if glu else 2)) * e \
        + cfg.d_model * m.num_experts + cfg.d_model


def _mamba_params(cfg: ModelConfig) -> int:
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    r = mc.dt_rank or -(-d // 16)
    return (d * 2 * d_in + d_in * mc.d_conv + d_in
            + d_in * (r + 2 * mc.d_state) + r * d_in + d_in
            + d_in * mc.d_state + d_in + d_in * d + d)


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    rc = cfg.rwkv
    tm = (6 * d + d * 5 * 32 + 5 * 32 * d          # ddlerp
          + 4 * d * d                               # r,k,v,g
          + d + d * rc.decay_lora + rc.decay_lora * d  # decay
          + d + d                                   # u, ln_x
          + d * d + d)                              # out + norm
    cm = 2 * d + d * cfg.d_ff + cfg.d_ff * d + d * d + d
    return tm + cm


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic (unpadded) parameter count, the JAX package's formula;
    with ``active_only`` a MoE layer counts its top_k experts only."""
    d, V = cfg.d_model, cfg.vocab_size
    total = V * d + d                                 # embed + final norm
    if not cfg.tie_embeddings:
        total += d * V

    def layer_cost(mixer: str, ffn: str) -> int:
        if mixer == "rwkv_tm":
            return _rwkv_params(cfg)                 # tm+cm combined
        c = _attn_params(cfg) if mixer == "attn" else _mamba_params(cfg)
        c += _mlp_params(cfg) if ffn == "mlp" else _moe_params(cfg,
                                                               active_only)
        return c

    if cfg.num_encoder_layers > 0:
        per = _attn_params(cfg) + _mlp_params(cfg)
        xattn = _attn_params(cfg)
        total += cfg.num_encoder_layers * per + d
        total += cfg.num_layers * (per + xattn)
        return total
    if cfg.family in ("dense", "vlm"):
        total += cfg.num_layers * layer_cost("attn", "mlp")
    elif cfg.family == "moe":
        total += cfg.num_layers * layer_cost("attn", "moe")
    elif cfg.family == "ssm":
        total += cfg.num_layers * _rwkv_params(cfg)
    elif cfg.family == "hybrid":
        from repro_torch.models.lm import layer_plan
        plan, n_groups = layer_plan(cfg)
        total += n_groups * sum(layer_cost(m, f) for m, f in plan)
    return total
