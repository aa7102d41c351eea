"""Model registry: a config's model class, as the JAX package's
``models/registry.build_model`` picks it."""
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
