"""Serve-step builders for one rank, as the JAX package's
``core/engine/serve.py`` builds them: the contiguous prefill and decode
steps over the decode state (attention's contiguous KV cache and the
recurrent state of the ssm and hybrid families),
the paged chunked-prefill and decode steps with the paged-plan gate and
the default pool sizing, and the greedy pick. The steps are plain
functions run eagerly; the paged steps update the pools in place and
return them, the contiguous ones return the new state."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.core.kv_cache import PagedKVConfig


def check_paged_plan(model) -> None:
    """The paged path is gated to attention-only mixer stacks of a
    decoder-only model. An encoder-decoder has no ``plan``; the JAX
    package fails on it with an ``AttributeError``, the port says
    why."""
    if not hasattr(model, "plan"):
        raise ValueError(
            f"paged serving supports decoder-only (attn, mlp) stacks; "
            f"{model.cfg.name} is an encoder-decoder: use the contiguous "
            f"prefill/decode steps (make_prefill_step / make_decode_step) "
            f"instead")
    bad = sorted({k for kinds in model.plan for k in kinds
                  if k not in ("attn", "mlp")})
    if bad:
        raise ValueError(
            f"paged serving supports (attn, mlp) stacks only, plan has "
            f"{bad}; use the contiguous prefill/decode steps instead")


def build_prefill_step(bundle):
    """(params, ids [B,S], state) -> (last-token logits [B,V], state);
    an encoder-decoder's takes (params, enc_embeds [B,S_enc,D], ids,
    state), as the JAX package's does.
    For rwkv the prompt length must be a multiple of min(64, S) (the
    WKV's chunk); mamba and attention take prompts of any length, up to
    the KV cache's ``max_len`` (``cell.seq_len``) with room left for the
    decode steps."""
    model = bundle.model
    if bundle.run.model.num_encoder_layers > 0:
        @torch.no_grad()
        def encdec_step(params, enc_embeds, ids, state):
            return model.prefill_fn(params, enc_embeds, ids, state)
        return encdec_step

    @torch.no_grad()
    def step(params, ids, state):
        return model.prefill_fn(params, ids, state)
    return step


def build_decode_step(bundle):
    """(params, tok [B,1], state) -> (logits [B,V], state)."""
    model = bundle.model

    @torch.no_grad()
    def step(params, tok, state):
        return model.decode_fn(params, tok, state)
    return step


def paged_replicas(bundle, cell: ShapeCell) -> int:
    """Data replicas the paged pool's page dim is split over: one rank
    holds one replica."""
    return 1


def default_paged_kv(bundle, cell: ShapeCell) -> PagedKVConfig:
    """A pool sized so every batch slot can hold one max-length
    (cell.seq_len) sequence, plus the scratch page."""
    ps = 16 if cell.seq_len % 16 == 0 else 8
    mpps = -(-cell.seq_len // ps)
    slots = cell.global_batch // paged_replicas(bundle, cell)
    return PagedKVConfig(page_size=ps, pages_per_replica=1 + slots * mpps,
                         max_pages_per_seq=mpps)


def build_paged_decode_step(bundle, kv: PagedKVConfig):
    """(params, tok [B,1], table [B,max_pages], lengths [B], pools) ->
    (logits [B,V], pools)."""
    model = bundle.model
    check_paged_plan(model)

    @torch.no_grad()
    def step(params, tok, table, lengths, state):
        return model.paged_decode_fn(params, tok, state, table, lengths)
    return step


def build_prefill_chunk_step(bundle, kv: PagedKVConfig):
    """(params, ids [B,C], table, pos0 [B], last_idx [B], pools) ->
    (last-prompt-token logits [B,V], pools). Rows not prefilling this
    call must carry a scratch (all-zero) table row."""
    model = bundle.model
    check_paged_plan(model)

    @torch.no_grad()
    def step(params, ids, table, pos0, last_idx, state):
        return model.paged_prefill_fn(params, ids, state, table, pos0,
                                      last_idx)
    return step


def build_greedy_pick(bundle):
    """Greedy sampler: int32 argmax over the vocab per row. Ties go to
    the lowest index (``torch.argmax`` returns the first maximum), as
    ``jnp.argmax`` does."""
    @torch.no_grad()
    def pick(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return pick
