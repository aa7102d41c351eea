"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16e top-2 -- Mamba+attn 1:7 interleave, MoE every other layer.
[arXiv:2403.19887; hf]
Period-8 groups: attention at in-group position 4, mamba elsewhere;
MoE FFN on odd positions. The mamba state is O(1) per sequence; the
attention layers hold a contiguous KV cache."""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", sub_quadratic=True,
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    act="swiglu", qkv_bias=False, rope_theta=10000.0,
    norm_eps=1e-6,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25, moe_period=2, moe_offset=1),
    hybrid_period=8, hybrid_attn_positions=(4,))

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", sub_quadratic=True,
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  moe_period=2, moe_offset=1),
    hybrid_period=2, hybrid_attn_positions=(0,))
