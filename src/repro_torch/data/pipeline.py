"""Deterministic synthetic LM data, as the JAX package's
``data/pipeline.py`` makes it: zipf-token documents packed into
fixed-length rows, seeded per (seed, step) so any rank can regenerate
any step's batch on its own, an encoder-decoder's frame embeddings
beside them, and the per-rank slice of it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.encdec import enc_len


@dataclass
class DataConfig:
    seed: int = 0
    doc_len_mean: int = 512       # packed documents, exponential lengths
    zipf_a: float = 1.2           # token distribution (heavy-tailed)
    eod_token: int = 0


class SyntheticPackedLM:
    """Zipf-token documents packed into fixed-length rows. ``batch_np``
    depends only on (seed, step): the same numpy stream as the JAX
    package's, so both packages see identical batches."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell, data: DataConfig):
        self.cfg, self.cell, self.data = cfg, cell, data

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.cell.global_batch, self.cell.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step]))
        v = self.cfg.vocab_size
        toks = rng.zipf(self.data.zipf_a, size=(B, S + 1)) % (v - 1) + 1
        n_docs = max(int(S / self.data.doc_len_mean), 1)
        for b in range(B):
            cuts = rng.integers(1, S, size=n_docs)
            toks[b, cuts] = self.data.eod_token
        ids = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        mask = labels != self.data.eod_token
        return {"ids": ids, "labels": labels, "mask": mask}


def enc_embed_dim(cfg: ModelConfig) -> int:
    """The width of the encoder frames a batch carries: d_model for an
    encoder-decoder, 0 (none) otherwise, as the JAX launcher passes
    it."""
    return cfg.d_model if cfg.num_encoder_layers else 0


class ShardedLoader:
    """This rank's rows of each step's batch, on the bundle's device (the
    per-rank slice of the JAX package's ``ShardedLoader``; batches are
    made on demand, without a prefetch thread). With ``enc_embed_dim``
    each batch also holds ``enc_embeds`` [B, ``encdec.enc_len(S)``,
    enc_embed_dim], standard normal from ``SeedSequence([17, seed,
    step])``, drawn in fp32 and rounded to bf16, bit for bit the JAX
    loader's."""

    def __init__(self, dataset: SyntheticPackedLM, bundle,
                 enc_embed_dim: int = 0):
        self.ds, self.bundle = dataset, bundle
        self.enc_embed_dim = enc_embed_dim

    def get(self, step: int):
        b = self.ds.batch_np(step)
        if self.enc_embed_dim:
            rng = np.random.default_rng(
                np.random.SeedSequence([17, self.ds.data.seed, step]))
            cell = self.ds.cell
            frames = rng.standard_normal(
                (cell.global_batch, enc_len(cell.seq_len),
                 self.enc_embed_dim)).astype(np.float32)
            b["enc_embeds"] = torch.from_numpy(frames).to(torch.bfloat16)
        return self.bundle.shard_batch(b)
