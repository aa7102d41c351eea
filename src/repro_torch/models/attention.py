"""Attention sublayer: GQA with qkv bias and RoPE, over the paged KV
cache (continuous batching) or without a cache.

Both branches hand their core to ``kernels.ops.flash_attention`` (the
hand-written kernel on CUDA tensors, its plain version on CPU tensors)
with the per-row absolute position of q[:, 0] as ``q_offset``: the
function the JAX package's ``attention_block`` computes with
``chunked_causal_attention``. The kernel reads kv heads by index, so
K/V are never expanded to the q heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, matmul


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


def attention_block(x, wq, wk, wv, wo, bq, bk, bv, cfg,
                    positions: torch.Tensor,
                    paged_kv: Optional[Tuple] = None, causal: bool = True):
    """Full attention sublayer.

    x: [B, S, D]. wq: [D, H*hd]; wk/wv: [D, KVH*hd]; wo: [H*hd, D].
    positions: [B, S] per-row absolute positions (contiguous per row) on
    the paged path, [1, S] or [B, S] without a cache.

    paged_kv: (pool_k, pool_v, page_table) -- pools [n_pages, page_size,
    KVH, hd], updated in place; page_table [B, max_pages] page ids,
    page 0 the scratch page inactive rows point at. Returns
    ([B, S, D], (pool_k, pool_v) or None).
    """
    B, S, D = x.shape
    hd = cfg.resolved_head_dim()
    n_heads, n_kv = cfg.num_heads, cfg.num_kv_heads

    q = x @ wq
    k = x @ wk
    v = x @ wv
    if bq is not None:
        q = q + bq
    if bk is not None:
        k = k + bk
    if bv is not None:
        v = v + bv
    q = apply_rope(q.reshape(B, S, n_heads, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, n_kv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, n_kv, hd)

    new_cache = None
    if paged_kv is not None:
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
    return matmul(out.reshape(B, S, n_heads * hd), wo), new_cache
