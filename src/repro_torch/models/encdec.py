"""Encoder-decoder backbone (seamless-m4t-medium), as the JAX package's
``models/encdec.py`` computes it: parameter defs, the training loss over
this rank's shards and the contiguous serve steps.

The audio frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``enc_embeds`` [B, S_enc, D] (bf16), runs
non-causal self-attention with RoPE over ``arange(S_enc)`` and ends in
``enc_norm``. The decoder is a causal stack whose every layer also
attends, without a mask, over the encoder output through its
cross-attention (``models/sublayers.py``: ``xattn_*``). In training the
encoder output is a differentiable input of every decoder layer, so its
gradient is the sum of the decoder's cross-attentions' and flows back
through the encoder stack. Each stack runs its own gather schedule (its
own prefetch ring). Serving is contiguous only: the prefill encodes the
frames once, projects the encoder output into each cross-attention's
K/V state and fills the self-attention KV cache; each decode step reads
both. There is no paged path (no ``plan``), and, as in the JAX package,
no FCDP-Cache segments: ``device_cache_fraction`` does not split the
stacks."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, SystemConfig
from repro_torch.core.partition import ParamDef, label_tree
from repro_torch.core.peft import lora_scale
from repro_torch.models import stack as stk
from repro_torch.models.common import TPContext, pad_vocab
from repro_torch.models.layers import (chunked_tp_softmax_xent, embed_lookup,
                                       rms_norm)

ENC_PLAN = [("attn", "mlp")]
DEC_PLAN = [("attn", "xattn", "mlp")]


def enc_len(seq_len: int) -> int:
    """Encoder frames for a decoder cell of ``seq_len`` positions: the
    stub frontend's 4x downsampling, at least 8 (the JAX package's
    loader and serve state sizing)."""
    return max(seq_len // 4, 8)


class EncDec:
    """Defs + step bodies for one encoder-decoder architecture, at
    tensor-parallel degree ``tp`` (the vocabulary and the q heads padded
    to multiples of it). ``stacks`` names the two layer stacks, (defs
    key, plan, layers) each, as ``LM.stacks`` names its one."""

    def __init__(self, cfg: ModelConfig, sys: SystemConfig, tp: int = 1):
        if cfg.num_encoder_layers <= 0:
            raise ValueError(f"{cfg.name} has no encoder layers")
        self.cfg, self.sys, self.tp = cfg, sys, tp
        self.n_enc, self.n_dec = cfg.num_encoder_layers, cfg.num_layers
        self.stacks = (("enc_blocks", ENC_PLAN, self.n_enc),
                       ("dec_blocks", DEC_PLAN, self.n_dec))
        self.vpad = pad_vocab(cfg.vocab_size, tp)
        self.defs = label_tree(self._build_defs())
        self.lora_scale = lora_scale(sys)

    def _build_defs(self) -> Dict[str, Any]:
        cfg, tp, sys = self.cfg, self.tp, self.sys
        return {
            "embed": ParamDef((self.vpad, cfg.d_model), ("tp", "fsdp"),
                              init="embed"),
            "enc_blocks": stk.stack_defs(
                stk.group_defs(cfg, ENC_PLAN, tp, sys), self.n_enc),
            "enc_norm": ParamDef((cfg.d_model,), ("fsdp",), init="ones"),
            "dec_blocks": stk.stack_defs(
                stk.group_defs(cfg, DEC_PLAN, tp, sys), self.n_dec),
            "final_norm": ParamDef((cfg.d_model,), ("fsdp",), init="ones"),
            "head": ParamDef((cfg.d_model, self.vpad), ("fsdp", "tp")),
        }

    # -- training loss -------------------------------------------------------
    def loss_fn(self, params, batch, gather, defs, strategy):
        """This rank's loss over its batch rows, as ``LM.loss_fn``
        computes it (``strategy`` is unused: no device segment). batch:
        enc_embeds [B_local, S_enc, D], ids / labels / mask [B_local,
        S]. Returns (loss_sum, token_count, aux_sum: zero, no MoE)."""
        cfg, sys, plans = self.cfg, self.sys, gather.plans
        tpc = TPContext.of(gather.coll, sys.act_psum)
        if tpc.tp != self.tp:
            raise ValueError(f"the model's defs are for tp {self.tp}, the "
                             f"mesh's 'model' axis is {tpc.tp}")
        policy, chunk = sys.activation_policy, sys.moe_token_chunk
        x = batch["enc_embeds"].to(sys.torch_dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = stk.apply_stack_train(
            cfg, ENC_PLAN, self.n_enc, params["enc_blocks"],
            plans["enc_blocks"], defs["enc_blocks"], x, positions, gather,
            self.lora_scale, tpc, policy=policy, moe_token_chunk=chunk,
            causal=False)
        enc_out = rms_norm(x, gather(params["enc_norm"], plans["enc_norm"],
                                     torch.float32), cfg.norm_eps)
        ids, labels = batch["ids"], batch["labels"]
        x = embed_lookup(gather(params["embed"], plans["embed"]), ids, tpc)
        x = x.to(sys.torch_dtype)
        positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x, aux = stk.apply_stack_train(
            cfg, DEC_PLAN, self.n_dec, params["dec_blocks"],
            plans["dec_blocks"], defs["dec_blocks"], x, positions, gather,
            self.lora_scale, tpc, policy=policy, moe_token_chunk=chunk,
            enc_out=enc_out)
        x = rms_norm(x, gather(params["final_norm"], plans["final_norm"],
                               torch.float32), cfg.norm_eps)
        loss_sum, cnt = chunked_tp_softmax_xent(
            x, gather(params["head"], plans["head"]), labels,
            cfg.vocab_size, sys.loss_chunk, batch.get("mask"), tpc)
        return loss_sum, cnt, aux

    # -- serving over the contiguous decode state ----------------------------
    def init_decode_state(self, batch: int, max_len: int, device,
                          enc_len: int):
        """The decoder's decode state of ``batch`` rows, stacked over its
        layers: the self-attention KV cache of ``max_len`` positions and
        the cross-attention K/V of ``enc_len`` encoder frames."""
        return stk.init_group_state(self.cfg, DEC_PLAN, batch, max_len,
                                    self.n_dec, device, enc_len)

    def _encode(self, params, enc_embeds):
        x = enc_embeds.to(self.sys.torch_dtype)
        ctx = {"causal": False, "lora_scale": self.lora_scale,
               "positions": torch.arange(x.shape[1],
                                         device=x.device)[None, :]}
        x, _ = stk.apply_stack(self.cfg, ENC_PLAN, self.n_enc,
                               params["enc_blocks"], x, ctx)
        return rms_norm(x, params["enc_norm"], self.cfg.norm_eps)

    def _embed(self, params, ids):
        return embed_lookup(params["embed"], ids).to(self.sys.torch_dtype)

    def _final(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ params["head"]

    def prefill_fn(self, params, enc_embeds, ids, state):
        """Encode the frames [B, S_enc, D], then run the decoder over
        the prompt ids [B, S], filling both states. Returns (last-token
        logits [B, V], new state)."""
        enc_out = self._encode(params, enc_embeds)
        S = ids.shape[1]
        ctx = {"prefill": True, "enc_out": enc_out,
               "lora_scale": self.lora_scale,
               "positions": torch.arange(S, device=ids.device)[None, :]}
        x, state = stk.apply_stack(self.cfg, DEC_PLAN, self.n_dec,
                                   params["dec_blocks"],
                                   self._embed(params, ids), ctx, state)
        return self._final(params, x[:, -1]), state

    def decode_fn(self, params, tok, state):
        """One decode step. tok: [B, 1]. Returns (logits [B, V], new
        state)."""
        x, state = stk.apply_stack(self.cfg, DEC_PLAN, self.n_dec,
                                   params["dec_blocks"],
                                   self._embed(params, tok),
                                   {"decode": True,
                                    "lora_scale": self.lora_scale}, state)
        return self._final(params, x[:, 0]), state
