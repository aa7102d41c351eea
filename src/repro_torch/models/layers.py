"""Core layers: norms, rotary embeddings, activations, the embedding
lookup, the output-projection matmul seam and the cross entropy. Same
arithmetic as the JAX package's ``models/layers.py`` (fp32 upcasts at
the same places); the embedding and the head are vocabulary-sharded over
'model' (``models/common.py``), whole at tp 1."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (SERIAL, TPContext, pmax_tp, psum_tp,
                                       pvary_tp)


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
                                        plan.sync_axes, w.reads)
    return x @ w


def act_fn(name: str):
    return {"swiglu": F.silu,
            "geglu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 tpc: TPContext = SERIAL, scale: float = 1.0
                 ) -> torch.Tensor:
    """table: [V_local, D], this rank's rows of the vocabulary (all of it
    at tp 1); ids: [B, S] global ids. Ids outside this rank's rows give
    zero rows, and the sum over 'model' puts every row together
    (``psum_tp``, in the table's type). A ``scale`` other than 1
    multiplies the rows in fp32, then casts back to the table's type."""
    v_local = table.shape[0]
    local = ids - tpc.rank * v_local
    valid = (local >= 0) & (local < v_local)
    x = table[local.clamp(0, v_local - 1)]
    x = torch.where(valid[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    x = psum_tp(x, tpc)
    if scale != 1.0:
        x = (x.float() * scale).to(table.dtype)
    return x


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor,
                tpc: TPContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the whole vocabulary, this rank's share of the
    label's logit) of logits [..., V_local] in fp32: the max (stability
    only, so exact without a gradient) over 'model' by ``pmax_tp``, the
    sum of exponentials over 'model' by ``psum_tp``. The label's logit
    lies on exactly one rank: the others' shares are 0."""
    v_local = logits.shape[-1]
    lf = logits.float()
    gmax = pmax_tp(lf.amax(dim=-1).detach(), tpc)
    sumexp = psum_tp(torch.exp(lf - gmax[..., None]).sum(dim=-1), tpc)
    local = labels - tpc.rank * v_local
    valid = (local >= 0) & (local < v_local)
    picked = torch.gather(lf, -1, local.clamp(0, v_local - 1)[..., None]
                          .long())[..., 0]
    return (gmax + torch.log(sumexp),
            torch.where(valid, picked, torch.zeros_like(picked)))


def _xent_sum(lse, picked_local, labels, vocab_size, mask, tpc):
    """Sum of losses and count over the unmasked positions; labels
    outside [0, vocab_size) count as masked."""
    nll = lse - psum_tp(picked_local, tpc)
    keep = labels < vocab_size
    if mask is not None:
        keep = keep & mask
    nll = torch.where(keep, nll, torch.zeros_like(nll))
    return nll.sum(), keep.float().sum()


def tp_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                    vocab_size: int, mask: Optional[torch.Tensor] = None,
                    tpc: TPContext = SERIAL
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over this rank's vocabulary columns of the logits
    [..., V_local] in fp32 (the whole vocabulary at tp 1). Returns (sum
    of losses, count) over the unmasked positions."""
    lse, picked = _xent_terms(logits, labels, tpc)
    return _xent_sum(lse, picked, labels, vocab_size, mask, tpc)


def chunked_tp_softmax_xent(x: torch.Tensor, head_w: torch.Tensor,
                            labels: torch.Tensor, vocab_size: int,
                            chunk: int,
                            mask: Optional[torch.Tensor] = None,
                            tpc: TPContext = SERIAL
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits ``x @ head_w`` (this rank's vocabulary columns) and their
    cross entropy in sequence chunks, each recomputed in the backward,
    so the [B, S, V_local] logits never exist at once. Unchunked when
    ``chunk`` does not split S into several chunks. x is the same on
    every 'model' rank and the logits are not, so x's gradient is summed
    over 'model' (``pvary_tp``), per chunk as in the JAX package. The
    recompute re-runs the sum of exponentials over 'model', whose result
    the backward needs, and not the label logit's sum, whose result it
    does not: the JAX package's remat re-runs the same one."""
    B, S, _ = x.shape
    if chunk <= 0 or S % chunk or S == chunk:
        return tp_softmax_xent(pvary_tp(x, tpc) @ head_w, labels,
                               vocab_size, mask, tpc)

    def f(xc, lc):
        return _xent_terms(pvary_tp(xc, tpc) @ head_w, lc, tpc)
    tot = cnt = x.new_zeros((), dtype=torch.float32)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        lse, picked = checkpoint(f, x[:, sl], labels[:, sl],
                                 use_reentrant=False)
        s, n = _xent_sum(lse, picked, labels[:, sl], vocab_size,
                         None if mask is None else mask[:, sl], tpc)
        tot, cnt = tot + s, cnt + n
    return tot, cnt
