"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 -- GeGLU, head_dim=256, MQA, tied embeddings, embed scaling.
[arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    act="geglu", qkv_bias=False, rope_theta=10000.0,
    norm_eps=1e-6, tie_embeddings=True)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=192, vocab_size=512, head_dim=16,
    act="geglu", tie_embeddings=True)
