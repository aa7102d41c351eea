"""Dispatch for the port's kernels.

A CPU tensor goes to the kernel's plain version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel or raises -- there is no
fallback from the kernel to the plain version. Each dispatcher carries
a plain integer ``launches`` counter, raised by one per kernel launch
and nowhere else, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Skv,Hk,hd] (GQA by index); q_offset: int
    [B] absolute position of q[:, 0] (None = zeros)."""
    if q.device.type == "cpu":
        return ref.attention_plain(q, k, v, q_offset, causal, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    out = flash_attention_fwd(q, k, v, q_offset, causal, softmax_scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
