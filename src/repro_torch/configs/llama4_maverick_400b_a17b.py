"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 -- MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]
40 heads pad to 48 for tp=16."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    act="swiglu", qkv_bias=False, rope_theta=500000.0,
    norm_eps=1e-5,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25))

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=6, num_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16,
    act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=96))
