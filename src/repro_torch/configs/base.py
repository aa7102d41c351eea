"""Configuration dataclasses: the fields of the JAX package's
``configs/base.py`` that the one-card serve slice reads."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    act: str = "swiglu"         # swiglu | geglu | gelu | relu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell."""
    name: str
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class SystemConfig:
    """dtype: one type for weights and activations (the JAX package's
    param_dtype and compute_dtype; the port's matmuls take both operands
    in one type). serve_frozen: serving classifies every weight frozen,
    as the JAX bundle does."""
    dtype: str = "bfloat16"
    serve_frozen: bool = True

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; "
                             f"known: {sorted(DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeCell
    system: SystemConfig = field(default_factory=SystemConfig)
