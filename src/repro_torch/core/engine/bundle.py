"""StepBundle for one rank: the model, its ParamDefs and the serve-step
builders of one (arch x shape x system) cell.

On one rank the FCDP gather and the strategy/residency decisions of
the JAX bundle are the identity for every leaf, so the parameter dict
holds full tensors and the steps consume it directly. Steps run
eagerly; there is nothing to compile.
"""
from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.core.partition import init_params, tree_map
from repro_torch.models.lm import LM


class StepBundle:
    """Everything needed to run one (arch x shape x system) cell on one
    device: ``device=None`` means ``cuda``, and raises without one."""

    def __init__(self, run: RunConfig, device=None):
        self.run = run
        self.device = resolve_device(device)
        self.model = LM(run.model, run.system)
        defs = self.model.defs
        if run.shape.kind != "train" and run.system.serve_frozen:
            # serving: every weight frozen (the FCDP-Comm cached layout)
            defs = tree_map(lambda d: dataclasses.replace(d, frozen=True),
                            defs)
        self.defs = defs

    def init_all_params(self, seed: int = 0):
        """Parameter dict (nested like ``defs``) drawn on this bundle's
        device from ``torch.Generator(device).manual_seed(seed)``, in the
        system's parameter dtype."""
        return init_params(self.defs, seed, self.device,
                           dtype=self.run.system.torch_dtype)

    def init_paged_state(self, kv):
        from repro_torch.core.engine.serve import paged_replicas
        n_pages = kv.pages_per_replica * paged_replicas(self, self.run.shape)
        return self.model.init_paged_state(n_pages, kv.page_size,
                                           self.device)

    def make_paged_decode_step(self, kv):
        from repro_torch.core.engine.serve import build_paged_decode_step
        return build_paged_decode_step(self, kv)

    def make_prefill_chunk_step(self, kv):
        from repro_torch.core.engine.serve import build_prefill_chunk_step
        return build_prefill_chunk_step(self, kv)

    def make_greedy_pick(self):
        from repro_torch.core.engine.serve import build_greedy_pick
        return build_greedy_pick(self)

