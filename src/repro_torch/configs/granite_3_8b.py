"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 -- GQA. [hf:ibm-granite/granite-3.0-2b-base family; hf]
Vocab 49155 is padded to a multiple of tp=16 at build time."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155, head_dim=128,
    act="swiglu", qkv_bias=False, rope_theta=10000.0,
    norm_eps=1e-5)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=515, head_dim=16,  # odd vocab exercises padding
    act="swiglu")
