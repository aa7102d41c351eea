"""Architecture registry: --arch <id> resolution. The port has the ten
archs of the JAX package, in its order: qwen2.5-3b, gemma-2b,
granite-3-8b and yi-34b (dense), kimi-k2-1t-a32b and
llama4-maverick-400b-a17b (moe), chameleon-34b (vlm), rwkv6-3b (ssm),
seamless-m4t-medium (encdec) and jamba-v0.1-52b (hybrid), with each
arch's full config, smoke config and shape-cell applicability
(long_500k only for sub-quadratic archs)."""
from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.configs.base import SHAPE_CELLS, ModelConfig, ShapeCell

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma-2b": "gemma_2b",
    "granite-3-8b": "granite_3_8b",
    "yi-34b": "yi_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
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


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(supported, reason-if-skipped) for one (arch x shape) cell."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip (pure full-attention arch; 500k decode needs "
                       "sub-quadratic state)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """[(arch, cell_name, supported, reason)] for all 40 cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for cell in SHAPE_CELLS:
            ok, why = cell_supported(cfg, cell)
            out.append((arch, cell.name, ok, why))
    return out
