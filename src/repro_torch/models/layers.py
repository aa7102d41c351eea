"""Core layers: norms, rotary embeddings, activations, the embedding
lookup, the output-projection matmul seam and the cross entropy. Same
arithmetic as the JAX package's ``models/layers.py`` (fp32 upcasts at
the same places), at tensor-parallel degree 1."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for every output projection, where ``w`` may be a
    ``core.fcdp.FusedParam``: the stage-1 result of an output-dim-sharded
    weight, whose stage-2 gather then runs inside the ring of the
    gather-fused collective matmul (``kernels/collective_matmul.py``),
    chunk by chunk. The plan decides per leaf whether its weight arrives
    whole or as a ring."""
    from repro_torch.core.fcdp import FusedParam
    if isinstance(w, FusedParam):
        from repro_torch.kernels import ops
        plan = w.plan
        return ops.collective_ag_matmul(x, w.cache, w.coll,
                                        plan.intra_axes[0], plan.fused,
                                        plan.sync_axes)
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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over logits [..., V] in fp32 (the JAX package's
    ``tp_softmax_xent`` at tp 1). Returns (sum of losses, count) over the
    unmasked positions; labels outside [0, vocab_size) count as
    masked."""
    v = logits.shape[-1]
    lf = logits.float()
    gmax = lf.amax(dim=-1).detach()          # stability only: exact
    lse = gmax + torch.log(torch.exp(lf - gmax[..., None]).sum(dim=-1))
    valid = (labels >= 0) & (labels < v)
    picked = torch.gather(lf, -1, labels.clamp(0, v - 1)[..., None].long()
                          )[..., 0]
    nll = lse - torch.where(valid, picked, torch.zeros_like(picked))
    keep = labels < vocab_size
    if mask is not None:
        keep = keep & mask
    nll = torch.where(keep, nll, torch.zeros_like(nll))
    return nll.sum(), keep.float().sum()


def chunked_softmax_xent(x: torch.Tensor, head_w: torch.Tensor,
                         labels: torch.Tensor, vocab_size: int, chunk: int,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits ``x @ head_w`` and their cross entropy in sequence chunks,
    each recomputed in the backward, so the [B, S, V] logits never
    exist at once (the JAX package's ``chunked_tp_softmax_xent`` at tp
    1). Unchunked when ``chunk`` does not split S into several chunks."""
    B, S, _ = x.shape
    if chunk <= 0 or S % chunk or S == chunk:
        return softmax_xent(x @ head_w, labels, vocab_size, mask)

    def f(xc, lc, mc):
        return softmax_xent(xc @ head_w, lc, vocab_size, mc)
    tot = cnt = x.new_zeros((), dtype=torch.float32)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(f, x[:, sl], labels[:, sl],
                          None if mask is None else mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot, cnt
