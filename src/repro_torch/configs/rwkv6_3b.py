"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
-- Finch, data-dependent decay. [arXiv:2404.05892; hf]
40 heads of head_dim 64; a constant-size recurrent state per layer."""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", sub_quadratic=True,
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=0,
    d_ff=8960, vocab_size=65536, head_dim=64,
    act="relu", norm_eps=1e-5,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64))

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", sub_quadratic=True,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=0,
    d_ff=128, vocab_size=512, head_dim=16,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8))
