"""Architecture registry: --arch <id> resolution. The port has
qwen2.5-3b (dense), rwkv6-3b (ssm) and jamba-v0.1-52b (hybrid); the
other archs of the JAX package follow with their families."""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def _load(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE
