"""Deterministic synthetic LM data, as the JAX package's
``data/pipeline.py`` makes it: zipf-token documents packed into
fixed-length rows, seeded per (seed, step) so any rank can regenerate
any step's batch on its own, and the per-rank slice of it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


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


class ShardedLoader:
    """This rank's rows of each step's batch, on the bundle's device (the
    per-rank slice of the JAX package's ``ShardedLoader``; batches are
    made on demand, without a prefetch thread)."""

    def __init__(self, dataset: SyntheticPackedLM, bundle):
        self.ds, self.bundle = dataset, bundle

    def get(self, step: int):
        return self.bundle.shard_batch(self.ds.batch_np(step))
