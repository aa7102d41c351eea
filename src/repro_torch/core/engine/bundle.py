"""StepBundle: the model, its ParamDefs and the step builders of one
(arch x shape x system) cell.

Serving runs on one rank with whole weights: the FCDP gather and the
strategy decisions are the identity there, and the steps consume the
full parameter dict directly.

The def tree is classified as the JAX bundle does it: under
``SystemConfig.peft`` every weight is frozen and LoRA adapters are
injected (``core/peft.py``); a serve bundle freezes every weight; an
optional ``defs_fn`` transforms the result (the all-trainable reference
arm: ``peft.unfreeze_all``). The per-leaf strategies are resolved at
construction (``core/strategy.resolve_strategies``): on the base tree,
non-strict under ``peft``, and again, strict, on the classified tree.

Training runs on a (pod, data, model) mesh, one process per rank. Given
a mesh, the bundle derives, per leaf in tree order, its gather plan,
storage and optimizer specs and replication factor, as the JAX bundle
does, and per trainable leaf whose optimizer spec is wider than its
storage (hier, an 'inter_only' leaf) the widening (``widen``). Given a
live ``RankMesh`` it
also knows this rank's coordinates: ``init_all_params`` and
``shard_batch`` hand out this rank's shards and batch rows. Steps run
eagerly; there is nothing to compile. ``cross_step`` says whether the
train step runs the cross-step schedule (the scheduler's stream 3), and
``cross_step_carry_layout`` gives its carry's per-rank shapes and
dtypes. ``state_blocks`` places this rank's part of every persisted leaf
(parameters, the widened optimizer state, the carry) in the global
arrays a checkpoint holds, for saving and restoring alike.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.core import peft
from repro_torch.core.partition import (_entry_axes, block_index, init_leaf,
                                        init_params, label_tree, shard_of,
                                        tree_items, tree_map_with_path)
from repro_torch.core.residency import split_train_indices
from repro_torch.core.strategy import resolve_strategies, spec_axes
from repro_torch.launch.mesh import MeshShape, fsdp_axes, tp_degree
from repro_torch.models.registry import build_model


class StepBundle:
    """Everything needed to run one cell: ``device=None`` means
    ``cuda``, and raises without one. ``mesh`` (a ``MeshShape``, or this
    rank's live ``RankMesh``) makes it a train bundle. ``defs_fn``
    transforms the classified def tree (see the module note)."""

    def __init__(self, run: RunConfig, device=None, mesh=None,
                 defs_fn=None):
        self.run = run
        sys = run.system
        self.device = resolve_device(device)
        tp = 1 if mesh is None else tp_degree(getattr(mesh, "mesh_shape",
                                                      mesh))
        self.model = build_model(run.model, sys, tp)
        base, self.strategy = resolve_strategies(sys, self.model.defs,
                                                 strict=not sys.peft)
        defs = base
        if sys.peft:
            defs = peft.apply_lora(defs, sys)
        elif run.shape.kind != "train" and sys.serve_frozen:
            # serving: every weight frozen (the FCDP-Comm cached layout)
            defs = peft.freeze_all(defs)
        if defs_fn is not None:
            defs = defs_fn(defs)
        if defs is not base:
            defs, self.strategy = resolve_strategies(sys, label_tree(defs))
        self.defs = defs
        self.mesh = mesh
        if mesh is not None:
            self._derive_layout(mesh)

    def _derive_layout(self, mesh) -> None:
        sys = self.run.system
        ms = mesh if isinstance(mesh, MeshShape) else mesh.mesh_shape
        self.mesh_shape = ms
        self.coords = None if isinstance(mesh, MeshShape) else mesh.coords
        self.plans = self.strategy.plan_tree(
            self.defs, ms, sys.min_shard_size,
            compress_bwd=(sys.grad_compress == "int8_pod"),
            param_compress=(sys.param_compress == "int8_pod"),
            fused_matmul=sys.fused_matmul)
        items = list(tree_items(self.defs))
        self.paths = [p for p, _ in items]
        self.def_leaves = [d for _, d in items]
        self.plan_leaves = [p for _, p in tree_items(self.plans)]
        self.train_idx, self.frozen_idx = split_train_indices(
            self.plan_leaves)
        self.leaf_specs = [self.strategy.storage_spec(d, ms,
                                                      sys.min_shard_size)
                           for d in self.def_leaves]
        self.full_specs = [self.strategy.opt_spec(d, ms, sys.min_shard_size)
                           for d in self.def_leaves]
        self.rep_factors = [self._replication(s) for s in self.full_specs]
        # train position -> (fsdp dim, widening axes): the optimizer
        # state's fsdp entry less the storage's, in tiling order
        self.widen = {}
        for j, i in enumerate(self.train_idx):
            dim = self.def_leaves[i].fsdp_dim
            if dim is None:
                continue
            storage = _entry_axes(self.leaf_specs[i][dim])
            extra = tuple(a for a in _entry_axes(self.full_specs[i][dim])
                          if a not in storage)
            if extra:
                self.widen[j] = (dim, extra)

    def opt_shards(self, train):
        """This rank's optimizer-layout views of its trainable shards
        (``split``'s first list): a widened leaf's block of its storage
        shard along the widening axes (the storage block subdivided
        over them, first axis major), the shard itself otherwise."""
        out = []
        for j, t in enumerate(train):
            if j in self.widen:
                dim, extra = self.widen[j]
                idx, count = block_index(extra, self.mesh_shape, self.coords)
                step = t.shape[dim] // count
                t = t.narrow(dim, idx * step, step)
            out.append(t)
        return out

    def _replication(self, spec) -> float:
        used = spec_axes(spec)
        rep = 1
        for a in self.mesh_shape.axis_names:
            if a not in used:
                rep *= self.mesh_shape.size(a)
        return float(rep)

    # -- parameters -------------------------------------------------------------
    def init_all_params(self, seed: int = 0,
                        draw_device: Optional[torch.device] = None):
        """Parameter dict (nested like ``defs``) in the system's dtype,
        drawn from ``torch.Generator(draw_device).manual_seed(seed)``
        (``draw_device`` defaults to this bundle's device) in tree order.
        A train bundle draws each full leaf and keeps this rank's shard
        on its device (``shard``); every rank draws the same full
        weights."""
        dtype = self.run.system.torch_dtype
        if self.mesh is None:
            return init_params(self.defs, seed, self.device, dtype=dtype)
        gen_dev = torch.device(draw_device or self.device)
        gen = torch.Generator(device=gen_dev).manual_seed(seed)
        return tree_map_with_path(
            lambda path, d: self.shard(path, init_leaf(gen, d, dtype,
                                                       gen_dev)),
            self.defs)

    def shard(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full leaf ``path`` under its storage
        spec, on the bundle's device, as a leaf tensor that requires
        grad when the leaf is trainable."""
        i = self.paths.index(path)
        block = shard_of(full, self.leaf_specs[i], self.mesh_shape,
                         self.coords)
        return block.to(self.device, copy=True).contiguous() \
            .requires_grad_(self.plan_leaves[i].residency.trainable)

    def split(self, params):
        """Flat (train leaves, frozen leaves) in tree order."""
        leaves = [t for _, t in tree_items(params)]
        return ([leaves[i] for i in self.train_idx],
                [leaves[i] for i in self.frozen_idx])

    def merge(self, train, frozen):
        """The parameter dict (nested like ``defs``) of ``split``'s two
        lists."""
        flat = [None] * len(self.paths)
        for i, t in zip(self.train_idx, train):
            flat[i] = t
        for i, t in zip(self.frozen_idx, frozen):
            flat[i] = t
        it = iter(flat)
        return tree_map_with_path(lambda _, d: next(it), self.defs)

    # -- the scheduler's streams 2 and 3 ---------------------------------------
    @property
    def cross_step(self) -> bool:
        """Whether the train step runs the cross-step schedule (prime /
        piped / flush) instead of the fused step."""
        from repro_torch.core.schedule import cross_step_enabled
        return cross_step_enabled(self.run, self.strategy, self.mesh_shape)

    def cross_step_carry_layout(self):
        """This rank's carry, per trainable leaf in tree order:
        ``{"g_acc": [(shape, dtype), ...], "pending": [...]}``. g_acc is
        the accumulated gradient, a storage shard; pending the last
        microbatch's stage-1-level gradient, the storage shard widened
        over the leaf's stage-1 axes along its fsdp dim (the storage
        shard for a leaf with no stage 1)."""
        dtype = self.run.system.torch_dtype
        out = {"g_acc": [], "pending": []}
        for i in self.train_idx:
            d, plan = self.def_leaves[i], self.plan_leaves[i]
            shape = list(d.shape)
            for dim, entry in enumerate(self.leaf_specs[i]):
                for a in _entry_axes(entry):
                    shape[dim] //= self.mesh_shape.size(a)
            out["g_acc"].append((tuple(shape), dtype))
            if plan.is_gathered and plan.inter_axes:
                shape[d.fsdp_dim] *= math.prod(self.mesh_shape.size(a)
                                               for a in plan.inter_axes)
            out["pending"].append((tuple(shape), dtype))
        return out

    # -- the persisted state (checkpoint/restart) -----------------------------
    def _block(self, shape, spec, widen=None, lead=None):
        """This rank's ``Block`` of a leaf of global ``shape`` stored under
        ``spec``: its block along each spec entry, subdivided along the
        widening ``(dim, axes)`` (the optimizer layout), behind a leading
        partial dim over ``lead`` (the carry). A block is written by its
        replica whose coordinates on the axes that do not split it are
        0."""
        from repro_torch.checkpoint import Block
        ms, c = self.mesh_shape, self.coords
        if c is None:
            raise ValueError("state blocks need a live mesh (a RankMesh)")
        used = spec_axes(spec) | set(lead or ())
        if widen is not None:
            used |= set(widen[1])
        index = []
        if lead is not None:
            row, _ = block_index(lead, ms, c)
            index.append(slice(row, row + 1))
        body = shape[1:] if lead is not None else shape
        for dim, n in enumerate(body):
            idx, count = block_index(_entry_axes(spec[dim]) if dim < len(spec)
                                     else (), ms, c)
            step = n // count
            lo = idx * step
            if widen is not None and dim == widen[0]:
                sub, parts = block_index(widen[1], ms, c)
                step //= parts
                lo += sub * step
            index.append(slice(lo, lo + step))
        return Block(tuple(shape), tuple(index),
                     all(c[a] == 0 for a in ms.axis_names if a not in used))

    def state_blocks(self, tree):
        """This rank's ``Block`` of every leaf of a persisted-state tree
        ``{"params": [trainable shards], "opt": {"m", "v", "master",
        "step"}(, "carry": {"g_acc", "pending"})}`` (any subset of the
        sections), tree-aligned: parameters under their storage specs,
        the optimizer state under the (possibly widened) optimizer
        layout (``opt_shards``), the carry as one row of the JAX
        package's global carry (``engine.train.carried_layout``)."""
        from repro_torch.checkpoint import Block
        from repro_torch.core.engine.train import carried_layout
        train = [(self.def_leaves[i].shape, self.leaf_specs[i])
                 for i in self.train_idx]
        out = {}
        for section in tree:
            if section == "params":
                out[section] = [self._block(s, spec) for s, spec in train]
            elif section == "opt":
                opt = [self._block(s, spec, self.widen.get(j))
                       for j, (s, spec) in enumerate(train)]
                out[section] = {k: list(opt) for k in tree[section]
                                if k != "step"}
                out[section]["step"] = Block.whole(
                    (), all(v == 0 for v in self.coords.values()))
            elif section == "carry":
                layout = carried_layout(self)
                out[section] = {k: [self._block(shape, base, lead=lead)
                                    for lead, base, shape, _ in layout[k]]
                                for k in tree[section]}
            else:
                raise KeyError(f"no persisted section {section!r}")
        return out

    # -- batch --------------------------------------------------------------------
    def shard_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (numpy or torch, [B, ...]),
        as tensors on the bundle's device: the rows split over the fsdp
        axes in the JAX package's order (data-major, pod minor), the same
        rows on every 'model' rank, or all rows when the batch does not
        split evenly."""
        ms = self.mesh_shape
        axes = fsdp_axes(ms)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            idx, count = block_index(axes, ms, self.coords)
            if t.shape[0] % count == 0:
                step = t.shape[0] // count
                t = t[idx * step:(idx + 1) * step]
            out[k] = t.to(self.device)
        return out

    # -- step builders --------------------------------------------------------
    def make_train_step(self, coll):
        from repro_torch.core.engine.train import build_train_step
        return build_train_step(self, coll)

    def init_state(self, cell=None):
        """The decode state for ``cell``'s batch, with KV caches of
        ``cell.seq_len`` positions (default: the run's cell), on the
        bundle's device; an encoder-decoder's cross-attention state
        holds ``encdec.enc_len(cell.seq_len)`` frames, as the JAX
        bundle sizes it."""
        cell = cell or self.run.shape
        kw = {}
        if self.run.model.num_encoder_layers > 0:
            from repro_torch.models.encdec import enc_len
            kw["enc_len"] = enc_len(cell.seq_len)
        return self.model.init_decode_state(cell.global_batch, cell.seq_len,
                                            self.device, **kw)

    def make_prefill_step(self):
        from repro_torch.core.engine.serve import build_prefill_step
        return build_prefill_step(self)

    def make_decode_step(self):
        from repro_torch.core.engine.serve import build_decode_step
        return build_decode_step(self)

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
