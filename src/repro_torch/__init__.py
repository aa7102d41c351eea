"""PyTorch/CUDA port of the FCDP system (one-card serve slice).

The JAX package ``repro`` is the reference this package is held
against; nothing here imports it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another. Without a GPU and without an explicit device this
    raises instead of carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    return torch.device("cuda")
