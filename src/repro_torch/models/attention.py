"""Attention sublayer: GQA with qkv bias, qk-norm and RoPE, over the
paged KV cache (continuous batching), over the contiguous KV cache (the
prefill/decode steps), without a cache (the encoder's, non-causal), or
in training; and the core of cross-attention over the encoder's K/V.

The serving branches hand their core to ``kernels.ops.flash_attention``
(the hand-written kernel on CUDA tensors, its plain version on CPU
tensors) with the per-row absolute position of q[:, 0] as ``q_offset``:
the function the JAX package's ``attention_block`` computes with
``chunked_causal_attention``. The kernel reads kv heads by index, so
K/V are never expanded to the q heads.

LoRA adapters (PEFT) ride in as ``lora``, the sublayer's
``<t>_lora_a`` / ``<t>_lora_b`` leaves, with ``lora_scale`` = alpha /
rank: ``((x @ a) @ b) * scale`` in the projection's type is added to q,
k and v after their bias and before RoPE, and to the output projection's
result, as the JAX package's ``attention_block`` adds them. These are
small matrix products outside any kernel in both packages.

The train branch (``attention_train``) runs on this rank's q heads
under tensor parallelism over 'model' (heads padded to a multiple of
tp, k/v projections whole on every rank, ``slice_expand_kv``) and
differentiates ``chunked_causal_attention``, plain PyTorch under
autograd, as the JAX package's train path does: the flash kernel is
forward-only in both packages (its Pallas version has no VJP). That function is the
counterpart of a jnp function, not the plain version of a kernel, so
``kernels/ref.attention_plain`` is not used for it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (SERIAL, TPContext, local_head_mask,
                                       region_vary)
from repro_torch.models.layers import apply_rope, matmul, rms_norm


def _write_pages(pool: torch.Tensor, table: torch.Tensor,
                 positions: torch.Tensor, new: torch.Tensor) -> None:
    """Scatter new K or V rows [B,S,KVH,hd] into the pool [n_pages,
    page_size, KVH, hd] IN PLACE at their absolute positions through the
    page table. The JAX step donates the pools and returns new ones; the
    port updates them where they lie. Positions past the table width
    (chunk-padding overshoot) go to the scratch page, as do all rows of
    inactive slots: never read unmasked (the causal mask stops at each
    row's own position), so duplicate writes there may land in any
    order."""
    n_pages, page_size, n_kv, hd = pool.shape
    page_idx = positions // page_size
    in_range = page_idx < table.shape[1]
    pageof = torch.gather(table, 1,
                          page_idx.clamp(max=table.shape[1] - 1).long())
    pageof = torch.where(in_range, pageof, torch.zeros_like(pageof))
    slot = (pageof.long() * page_size + positions % page_size).reshape(-1)
    pool.view(n_pages * page_size, n_kv, hd).index_copy_(
        0, slot, new.to(pool.dtype).reshape(-1, n_kv, hd))


def _gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Every page a row can address as one contiguous view [B,
    max_pages*page_size, KVH, hd]. Rows beyond a sequence's written
    length come from scratch or stale pages: finite (the pools start as
    zeros), and masked by the per-row causal offset."""
    n_pages, page_size, n_kv, hd = pool.shape
    idx = (table.long()[..., None] * page_size
           + torch.arange(page_size, device=table.device)
           ).reshape(table.shape[0], -1)
    return pool.view(n_pages * page_size, n_kv, hd)[idx]


NEG_INF = -1e30


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_chunk: int = 1024,
                             kv_chunk: int = 1024, causal: bool = True,
                             softmax_scale: Optional[float] = None,
                             q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention in plain PyTorch, fp32 inside: online
    softmax over kv chunks, O(chunk^2) live memory per q chunk.

    q: [B, Sq, H, hd]; k, v: [B, Skv, H, hd] (kv already head-expanded).
    q_offset: absolute position of q[0] relative to k[0]; causal masking
    uses absolute positions. Output in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = softmax_scale or (1.0 / math.sqrt(hd))
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    kv_pos = torch.arange(nk * kv_chunk, device=q.device)
    kt = k.float().transpose(1, 2)                         # [B,H,Skv,hd]
    vt = v.float().transpose(1, 2)
    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk].float().transpose(1, 2)
        nqc = qc.shape[2]
        q_pos = q_offset + qi * q_chunk + torch.arange(nqc, device=q.device)
        m = torch.full((B, H, nqc), NEG_INF, device=q.device)
        l = torch.zeros((B, H, nqc), device=q.device)
        acc = torch.zeros((B, H, nqc, hd), device=q.device)
        for ki in range(nk):
            lo, hi = ki * kv_chunk, min((ki + 1) * kv_chunk, Skv)
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kt[:, :, lo:hi]) * scale
            if causal:
                mask = kv_pos[lo:hi][None, :] <= q_pos[:, None]
                s = torch.where(mask, s, torch.full((), NEG_INF,
                                                    device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vt[:, :, lo:hi])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)            # [B,Sq,H,hd]
    return out.to(q.dtype)


def _lora_term(x, lora, name, scale):
    """The adapter term of projection ``name`` on its input x, or None
    without adapters for it."""
    a = lora.get(f"{name}_lora_a") if lora else None
    if a is None:
        return None
    return ((x @ a) @ lora[f"{name}_lora_b"]) * scale


def _add_lora(y, x, lora, name, scale):
    """y, the output of projection ``name`` on x, plus its adapter term
    in y's type."""
    t = _lora_term(x, lora, name, scale)
    return y if t is None else y + t.to(y.dtype)


def _project(x, wq, wk, wv, bq, bk, bv, cfg, positions, lora=None,
             lora_scale=2.0, tpc: TPContext = SERIAL, q_norm=None,
             k_norm=None):
    """q [B,S,H_local,hd] (this rank's q heads), k and v [B,S,KVH,hd],
    RoPE applied to q and k; the adapter terms go in before RoPE, and so
    does the qk-norm (chameleon: ``q_norm`` / ``k_norm`` [hd], an
    RMSNorm of each head's q and k), as in the JAX package. Where
    the region's input meets a 'model'-sharded weight (x and wq, the wq
    adapter's product and its ``lora_b``), its gradient is summed over
    'model' (``region_vary``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = region_vary(x, tpc) @ wq
    k = x @ wk
    v = x @ wv
    if bq is not None:
        q = q + bq
    if bk is not None:
        k = k + bk
    if bv is not None:
        v = v + bv
    a = lora.get("wq_lora_a") if lora else None
    if a is not None:
        q = q + ((region_vary(x @ a, tpc) @ lora["wq_lora_b"])
                 * lora_scale).to(q.dtype)
    k = _add_lora(k, x, lora, "wk", lora_scale)
    v = _add_lora(v, x, lora, "wv", lora_scale)
    q = q.reshape(B, S, wq.shape[1] // hd, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    if q_norm is not None:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.num_kv_heads, hd)


def kv_span(h_local: int, n_rep: int, n_kv: int) -> int:
    """How many kv heads one 'model' rank's q heads read."""
    if n_rep <= 0:
        return n_kv
    aligned = (h_local % n_rep == 0) or (n_rep % h_local == 0)
    span = max(h_local // n_rep, 1) + (0 if aligned else 1)
    return min(span, n_kv)


def slice_expand_kv(k_all: torch.Tensor, v_all: torch.Tensor, h_local: int,
                    n_rep: int, tp_rank: int):
    """This rank's [B,S,h_local,hd] K/V, q head h reading kv head h //
    n_rep: the (at most ``kv_span``) kv heads its q heads map onto are
    sliced, expanded, and the local head range cut out, so the expansion
    over every head never exists."""
    n_kv = k_all.shape[2]
    start = tp_rank * h_local
    span = kv_span(h_local, n_rep, n_kv)
    first = min(start // n_rep, n_kv - span)
    off = start - first * n_rep

    def one(t):
        t = t[:, :, first:first + span]
        if n_rep > 1:
            t = t.repeat_interleave(n_rep, dim=2)
        return t[:, :, off:off + h_local]
    return one(k_all), one(v_all)


def attention_train(x, wq, wk, wv, wo, bq, bk, bv, cfg,
                    positions: torch.Tensor, lora=None,
                    lora_scale: float = 2.0,
                    tpc: TPContext = SERIAL, q_norm=None,
                    k_norm=None, causal: bool = True) -> torch.Tensor:
    """Self-attention sublayer of the train step (causal, or not: the
    encoder's), under autograd,
    on this rank's q heads: x: [B, S, D] (the normed input, after
    ``tp_region_in``); wq [D, H_local*hd], wo [H_local*hd, D], wk/wv
    whole. Returns this rank's partial output [B, S, D], before the sum
    over 'model'. K/V are expanded to the local q heads
    (``slice_expand_kv``); where k and v are the same on every rank, the
    slice is where they start to differ, so their gradients are summed
    over 'model' there (``region_vary``), as the JAX step sums them. The
    padding heads' outputs are zeroed (``local_head_mask``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project(x, wq, wk, wv, bq, bk, bv, cfg, positions, lora,
                       lora_scale, tpc, q_norm, k_norm)
    h_local = q.shape[2]
    padded = h_local * tpc.tp
    if padded % cfg.num_kv_heads:
        raise ValueError(f"padded heads {padded} not divisible by kv heads "
                         f"{cfg.num_kv_heads}")
    k, v = slice_expand_kv(region_vary(k, tpc), region_vary(v, tpc),
                           h_local, padded // cfg.num_kv_heads, tpc.rank)
    out = chunked_causal_attention(q, k, v, causal=causal)
    if padded != cfg.num_heads:
        mask = local_head_mask(tpc, padded, cfg.num_heads, out.device)
        out = out * mask[None, None, :, None].to(out.dtype)
    out = out.reshape(B, S, h_local * hd)
    return _add_lora(matmul(out, wo), out, lora, "wo", lora_scale)


def attention_block(x, wq, wk, wv, wo, bq, bk, bv, cfg,
                    positions: torch.Tensor,
                    paged_kv: Optional[Tuple] = None,
                    kv_cache: Optional[Tuple] = None, causal: bool = True,
                    lora=None, lora_scale: float = 2.0, q_norm=None,
                    k_norm=None):
    """Full attention sublayer.

    x: [B, S, D]. wq: [D, H*hd]; wk/wv: [D, KVH*hd]; wo: [H*hd, D].
    positions: [B, S] per-row absolute positions (contiguous per row) on
    the paged path, [1, S] or [B, S] otherwise.

    paged_kv: (pool_k, pool_v, page_table) -- pools [n_pages, page_size,
    KVH, hd], updated in place; page_table [B, max_pages] page ids,
    page 0 the scratch page inactive rows point at.

    kv_cache: (k_cache, v_cache, idx) -- caches [B, max_len, KVH, hd]
    and the int32 scalar ``idx``, the length written so far. The new
    K/V are written at [idx, idx + S) in the cache's type, in place, and
    ``idx`` advances by S in place; attention reads the whole cache back
    (so the cache's rounding enters here too) with q[:, 0] at absolute
    position idx, and the causal mask hides the unwritten tail. The JAX
    package's ``dynamic_update_slice`` clamps a write past ``max_len``
    to the cache's end without a word; here it fails (RuntimeError).

    Returns ([B, S, D], the updated cache: (pool_k, pool_v), (k_cache,
    v_cache, idx) or None).
    """
    B, S, D = x.shape
    q, k, v = _project(x, wq, wk, wv, bq, bk, bv, cfg, positions, lora,
                       lora_scale, q_norm=q_norm, k_norm=k_norm)

    new_cache = None
    if kv_cache is not None:
        k_cache, v_cache, idx = kv_cache
        max_len = k_cache.shape[1]
        # idx stays on the device: the check and the write wait for no
        # copy to the host (on the card a failed check surfaces as a
        # device-side assert at the next synchronisation)
        torch._assert_async(idx + S <= max_len,
                            f"KV cache overflow: writing {S} positions "
                            f"from idx into a cache of {max_len}")
        at = idx.long() + torch.arange(S, device=x.device)
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        q_offset = idx.repeat(B)
        idx.add_(S)
        new_cache = (k_cache, v_cache, idx)
        k, v = k_cache, v_cache
    elif paged_kv is not None:
        pool_k, pool_v, table = paged_kv
        _write_pages(pool_k, table, positions, k)
        _write_pages(pool_v, table, positions, v)
        new_cache = (pool_k, pool_v)
        k = _gather_pages(pool_k, table)
        v = _gather_pages(pool_v, table)
        q_offset = positions[:, 0].to(torch.int32).contiguous()
    else:
        q_offset = torch.zeros(B, dtype=torch.int32, device=x.device)
    out = ops.flash_attention(q, k, v, q_offset, causal)
    out = out.reshape(B, S, -1)
    return _add_lora(matmul(out, wo), out, lora, "wo", lora_scale), \
        new_cache


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The serving core of cross-attention: q [B, Sq, H, hd] (the
    decoder's prompt or one token) over the encoder's k / v [B, Senc,
    KVH, hd], every key visible (``causal`` False; Sq and Senc differ),
    the kv heads read by index, nothing written. Returns [B, Sq, H,
    hd]."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, False)
