"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 -- early-fusion, VQ image tokens, qk-norm.
[arXiv:2405.09818; unverified]
Early fusion: VQ image tokens share the text vocab; the VQ tokenizer
frontend is a stub -- inputs are token ids over the unified vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    act="swiglu", qkv_bias=False, rope_theta=10000.0,
    norm_eps=1e-5, frontend="vq_image")

SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    act="swiglu", frontend="vq_image")
