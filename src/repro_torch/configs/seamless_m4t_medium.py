"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 -- enc-dec, multimodal. [arXiv:2308.11596; hf]
Backbone only: the audio frontend is a STUB -- the encoder takes
precomputed frame embeddings [B, S/4, D]. 12 encoder + 12 decoder layers.
long_500k skipped (full attention enc-dec). Vocab padded to tp multiple."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    act="gelu", qkv_bias=False, norm_eps=1e-5,
    num_encoder_layers=12, frontend="audio_frames", sub_quadratic=False)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=515, head_dim=16,
    act="gelu", num_encoder_layers=2, frontend="audio_frames",
    sub_quadratic=False)
