"""Decoder-only language model of the dense, moe, ssm, hybrid and vlm
families: parameter defs, the training loss over this rank's shards, the
paged serve steps (chunked prefill and decode over the paged KV cache;
dense and vlm) and the contiguous serve steps (prefill and decode over
the contiguous KV cache and the recurrent state), as the JAX package's
``models/lm.py`` computes them. The vlm family (chameleon) is a decoder
over a unified token space: its VQ image frontend is a stub, so its
inputs are token ids, and its attention has qk-norm. Under
``tie_embeddings`` (gemma) there is no ``head`` leaf: the head is the
embedding table's transpose; gemma's embedding is scaled by
sqrt(d_model)."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, SystemConfig
from repro_torch.core.partition import ParamDef, label_tree
from repro_torch.core.peft import lora_scale
from repro_torch.models import stack as stk
from repro_torch.models.common import TPContext, pad_vocab
from repro_torch.models.layers import (chunked_tp_softmax_xent, embed_lookup,
                                       rms_norm)


def layer_plan(cfg: ModelConfig) -> Tuple[List[Tuple[str, ...]], int]:
    """Returns (plan, n_groups). plan[i] = sublayer kinds at position i."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", "mlp")], cfg.num_layers
    if cfg.family == "moe":
        return [("attn", "moe")], cfg.num_layers
    if cfg.family == "ssm":
        return [("rwkv_tm", "rwkv_cm")], cfg.num_layers
    if cfg.family == "hybrid":
        period = cfg.hybrid_period
        if period < 1 or cfg.num_layers % period:
            raise ValueError(f"hybrid: {cfg.num_layers} layers are not a "
                             f"whole number of periods of {period}")
        plan = []
        m = cfg.moe
        for i in range(period):
            mixer = "attn" if i in cfg.hybrid_attn_positions else "mamba"
            ffn = "moe" if (m and i % m.moe_period == m.moe_offset) else "mlp"
            plan.append((mixer, ffn))
        return plan, cfg.num_layers // period
    if cfg.family == "encdec":
        raise ValueError("layer_plan: the encdec family is two stacks "
                         "(models/encdec.py: EncDec)")
    raise ValueError(f"layer_plan: unknown family {cfg.family!r}")


class LM:
    """Defs + step bodies for one decoder-only architecture, at
    tensor-parallel degree ``tp`` (the train mesh's 'model' size; the
    vocabulary and the q heads are padded to multiples of it).
    ``stacks`` names its layer stack, (defs key, plan, layers), as
    ``EncDec.stacks`` names its two."""

    def __init__(self, cfg: ModelConfig, sys: SystemConfig, tp: int = 1):
        self.cfg, self.sys, self.tp = cfg, sys, tp
        self.plan, self.n_groups = layer_plan(cfg)
        self.stacks = (("blocks", self.plan, self.n_groups),)
        self.vpad = pad_vocab(cfg.vocab_size, tp)
        self.defs = label_tree(self._build_defs())
        # the attention adapters' scale, where the params hold adapters
        self.lora_scale = lora_scale(sys)
        # the embedding's scale, keyed on the name as in the JAX package
        self.embed_scale = (math.sqrt(cfg.d_model)
                            if cfg.name.startswith("gemma") else 1.0)

    def _build_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        defs = {
            "embed": ParamDef((self.vpad, cfg.d_model), ("tp", "fsdp"),
                              init="embed"),
            "final_norm": ParamDef((cfg.d_model,), ("fsdp",), init="ones"),
            "blocks": stk.stack_defs(stk.group_defs(cfg, self.plan,
                                                    self.tp, self.sys),
                                     self.n_groups),
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((cfg.d_model, self.vpad), ("fsdp", "tp"))
        return defs

    # -- shared forward pieces ----------------------------------------------
    def head_weights(self, params, gather=None) -> torch.Tensor:
        """The head [D, V_local]: the ``head`` leaf, or under
        ``tie_embeddings`` the embedding table's transpose. ``gather``
        (a ``core.fcdp.ParamGather``; None: ``params`` are whole) gathers
        the leaf from this rank's shards, the tied table a second time,
        as the JAX package's ``_head_weights`` does."""
        name = "embed" if self.cfg.tie_embeddings else "head"
        w = params[name] if gather is None else gather(params[name],
                                                       gather.plans[name])
        return w.T if self.cfg.tie_embeddings else w

    def _embed(self, params, ids: torch.Tensor) -> torch.Tensor:
        return embed_lookup(params["embed"], ids,
                            scale=self.embed_scale).to(self.sys.torch_dtype)

    def _final(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and logits of x [B, D] -> [B, V]."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self.head_weights(params)

    # -- training loss -------------------------------------------------------
    def _segments(self, strategy):
        """(start, length, placement) segments of FCDP-Cache's device
        fraction over the stack: the leading ``device_cache_groups``
        layers with placement "device", the rest with None."""
        n_dev = strategy.device_cache_groups(self.n_groups,
                                             self.sys.device_cache_fraction)
        segs = []
        if n_dev > 0:
            segs.append((0, n_dev, "device"))
        if n_dev < self.n_groups:
            segs.append((n_dev, self.n_groups - n_dev, None))
        return segs

    def loss_fn(self, params, batch, gather, defs, strategy):
        """This rank's loss over its batch rows: ``params`` are its
        shards, ``gather`` a ``core.fcdp.ParamGather`` holding their
        plans, ``defs`` the bundle's classified defs (the adapters
        included), ``strategy`` the bundle's (the device segment's
        length). batch: ids / labels / mask
        [B_local, S], the same rows on every 'model' rank. Returns
        (loss_sum, token_count, aux_sum: the MoE sublayers' aux losses,
        each summed over 'model' and weighted); the caller sums them
        over the data-parallel ranks."""
        cfg, plans = self.cfg, gather.plans
        tpc = TPContext.of(gather.coll, self.sys.act_psum)
        if tpc.tp != self.tp:
            raise ValueError(f"the model's defs are for tp {self.tp}, the "
                             f"mesh's 'model' axis is {tpc.tp}")
        ids, labels = batch["ids"], batch["labels"]
        S = ids.shape[1]
        x = embed_lookup(gather(params["embed"], plans["embed"]), ids, tpc,
                         self.embed_scale)
        x = x.to(self.sys.torch_dtype)
        positions = torch.arange(S, device=ids.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for start, length, placement in self._segments(strategy):
            x, a = stk.apply_stack_train(
                cfg, self.plan, start + length, params["blocks"],
                plans["blocks"], defs["blocks"], x, positions, gather,
                self.lora_scale, tpc, start, placement,
                self.sys.activation_policy, self.sys.moe_token_chunk)
            aux = aux + a
        x = rms_norm(x, gather(params["final_norm"], plans["final_norm"],
                               torch.float32), cfg.norm_eps)
        loss_sum, cnt = chunked_tp_softmax_xent(
            x, self.head_weights(params, gather), labels, cfg.vocab_size,
            self.sys.loss_chunk, batch.get("mask"), tpc)
        return loss_sum, cnt, aux

    # -- serving over the contiguous decode state ----------------------------
    def init_decode_state(self, batch: int, max_len: int, device):
        """The decode state of ``batch`` rows, stacked over the layer
        groups: attention's KV cache of ``max_len`` positions and the
        recurrent sublayers' state."""
        return stk.init_group_state(self.cfg, self.plan, batch, max_len,
                                    self.n_groups, device)

    def prefill_fn(self, params, ids, state):
        """Full-prompt forward that fills the decode state. ids: [B, S].
        Returns (last-token logits [B, V], new state)."""
        S = ids.shape[1]
        x = self._embed(params, ids)
        ctx = {"prefill": True, "lora_scale": self.lora_scale,
               "positions": torch.arange(S, device=ids.device)[None, :]}
        x, state = stk.apply_stack(self.cfg, self.plan, self.n_groups,
                                   params["blocks"], x, ctx, state)
        return self._final(params, x[:, -1]), state

    def decode_fn(self, params, tok, state):
        """One decode step. tok: [B, 1] token ids. Returns (logits [B,
        V], new state)."""
        x = self._embed(params, tok)
        x, state = stk.apply_stack(self.cfg, self.plan, self.n_groups,
                                   params["blocks"], x,
                                   {"decode": True,
                                    "lora_scale": self.lora_scale}, state)
        return self._final(params, x[:, 0]), state

    # -- paged serving (continuous batching) ---------------------------------
    def init_paged_state(self, n_pages: int, page_size: int, device):
        """Paged KV pools, stacked over the layer groups."""
        return stk.init_paged_group_state(self.cfg, self.plan, n_pages,
                                          page_size, self.n_groups, device)

    def paged_decode_fn(self, params, tok, state, table, lengths):
        """One decode step over the paged cache. tok: [B, 1]; table:
        [B, max_pages] page ids; lengths: [B] current written length per
        row (the incoming token's absolute position). The pools in
        ``state`` are updated in place. Returns (logits [B, V], state)."""
        x = self._embed(params, tok)
        ctx = {"paged": True, "positions": lengths[:, None],
               "page_table": table, "lora_scale": self.lora_scale}
        x, state = stk.apply_stack(self.cfg, self.plan, self.n_groups,
                                   params["blocks"], x, ctx, state)
        return self._final(params, x[:, 0]), state

    def paged_prefill_fn(self, params, ids, state, table, pos0, last_idx):
        """One prefill CHUNK over the paged cache. ids: [B, C] (rows not
        prefilling this call carry padding and a scratch table row);
        pos0: [B] absolute position of each row's chunk start; last_idx:
        [B] position within the chunk of the row's last prompt token
        (logits are taken there). Returns (logits [B, V], state)."""
        S = ids.shape[1]
        x = self._embed(params, ids)
        positions = pos0[:, None] + torch.arange(
            S, dtype=pos0.dtype, device=pos0.device)[None, :]
        ctx = {"paged": True, "positions": positions, "page_table": table,
               "lora_scale": self.lora_scale}
        x, state = stk.apply_stack(self.cfg, self.plan, self.n_groups,
                                   params["blocks"], x, ctx, state)
        x_last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
        return self._final(params, x_last), state
