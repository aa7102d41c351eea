"""Paged (block) KV cache for continuous-batching serve.

A copy of the JAX package's ``core/kv_cache.py`` host side:

  - Every attention layer owns one K and one V *pool*: [n_pages,
    page_size, span, hd], stacked over the layer dim.
  - A per-batch-row *page table* [B, max_pages_per_seq] of page ids
    maps absolute token positions to pool rows:
    flat_slot(pos) = table[b, pos // page_size] * page_size + pos % page_size.
  - Page 0 is the reserved SCRATCH page: inactive batch rows keep an
    all-zero table row, so their (ignored) writes land in scratch and
    never touch live pages. Scratch is never read unmasked -- each row's
    causal mask ends at its own position -- so duplicate scratch writes
    are harmless.

Allocation is host-side and conservative: a request is admitted only
when ceil((prompt_len + max_new_tokens) / page_size) free pages exist,
so an admitted sequence can never be starved mid-decode and no
preemption/swap path is needed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

SCRATCH_PAGE = 0


@dataclass(frozen=True)
class PagedKVConfig:
    """Static shape of the paged KV cache (per data replica).

    page_size: tokens per page.
    pages_per_replica: pool size INCLUDING the scratch page.
    max_pages_per_seq: page-table width -- bounds one sequence's
      prompt + generation to max_pages_per_seq * page_size tokens.
    """
    page_size: int = 16
    pages_per_replica: int = 64
    max_pages_per_seq: int = 8

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {self.page_size}")
        if self.pages_per_replica <= 1:
            raise ValueError("pages_per_replica must leave room beyond the "
                             f"scratch page, got {self.pages_per_replica}")
        if self.max_pages_per_seq <= 0:
            raise ValueError("max_pages_per_seq must be > 0, got "
                             f"{self.max_pages_per_seq}")
        if self.pages_per_replica < 1 + self.max_pages_per_seq:
            raise ValueError(
                f"pages_per_replica {self.pages_per_replica} cannot hold "
                f"the scratch page + one max-length sequence "
                f"({1 + self.max_pages_per_seq})")

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def pages_needed(self, total_len: int) -> int:
        """Pages one sequence of prompt+generation length needs."""
        return -(-total_len // self.page_size)


def kv_page_bytes_per_chip(cfg_model, mesh, plan, n_groups: int,
                           kv: PagedKVConfig) -> float:
    """Analytic per-rank bytes of the paged KV pools (K+V, bf16), as the
    JAX package counts them: each attention position holds
    ``pages_per_replica`` pages of its local slice, ``kv_span`` kv-head
    slots (the 'model' shard) by head_dim, ``page_size`` tokens a page.
    ``mesh``: anything with ``size(axis)`` (a ``MeshShape``)."""
    from repro_torch.models.attention import kv_span
    from repro_torch.models.common import pad_heads
    n_attn = sum(1 for kinds in plan for k in kinds if k == "attn")
    if n_attn == 0:
        return 0.0
    tp = mesh.size("model")
    hd = cfg_model.resolved_head_dim()
    n_kv = cfg_model.num_kv_heads
    hp = pad_heads(cfg_model.num_heads, tp)
    span = kv_span(hp // tp, hp // n_kv, n_kv)
    elems = (n_groups * n_attn * kv.pages_per_replica * kv.page_size
             * span * hd)
    return float(elems * 2 * 2)          # K + V, bf16


class PageAllocator:
    """Host-side free-list for ONE replica's page pool. Page 0 (the
    scratch page) is never handed out."""

    def __init__(self, kv: PagedKVConfig):
        self.kv = kv
        # LIFO keeps recently-freed (cache-warm) pages hot; order is
        # irrelevant for correctness
        self._free: List[int] = list(range(kv.pages_per_replica - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None (all-or-nothing: conservative admission)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 < p < self.kv.pages_per_replica):
                raise ValueError(f"freeing invalid page id {p}")
        self._free.extend(pages)
