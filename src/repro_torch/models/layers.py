"""Core layers: norms, rotary embeddings, activations, the embedding
lookup and the output-projection matmul seam. Same arithmetic as the
JAX package's ``models/layers.py`` (fp32 upcasts at the same places)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S]. Split-half rotation in
    fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # [hd/2]
    ang = positions[..., :, None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for every output projection. The JAX package routes a
    gather-fused weight through its collective matmul here; that branch
    comes with the multi-rank slice."""
    return x @ w


def act_fn(name: str):
    return {"swiglu": F.silu,
            "geglu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: [V, D]; ids: [B, S]. Out-of-range ids give zero rows, as in
    the JAX package's vocab-sharded lookup."""
    vocab = table.shape[0]
    valid = (ids >= 0) & (ids < vocab)
    x = table[ids.clamp(0, vocab - 1)]
    return torch.where(valid[..., None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))
