"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 -- trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]
Optimizer-state dtype bf16 is recommended at 512 chips (EXPERIMENTS.md)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    act="swiglu", qkv_bias=False, rope_theta=50000.0,
    norm_eps=1e-5,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25))

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=16,
    act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
