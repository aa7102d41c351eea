"""The port's PEFT / FCDP-Comm decisions against the JAX package's: LoRA
injection, the update classes and their invariants, every leaf's
residency, storage and optimizer specs under PEFT for each mode (and
the mixed arm), and the per-leaf strategy resolution of
``SystemConfig.mode_overrides`` (``tests/test_residency.py`` and
``tests/test_composite.py``'s cases that need no prefetch, MoE or
planner). Exact: these are decisions, not numbers."""
import dataclasses
import itertools

import jax
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.core import peft as jpeft
from repro.core.engine import StepBundle as JStepBundle
from repro.core.partition import ParamDef as JParamDef
from repro.core.partition import label_tree as j_label_tree
from repro.core.strategy import get_strategy as j_get_strategy
from repro.launch.mesh import make_mesh
from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeCell,
                                      SystemConfig)
from repro_torch.core import peft
from repro_torch.core.engine import StepBundle
from repro_torch.core.partition import ParamDef, label_tree, tree_items
from repro_torch.core.residency import (ParamResidency, split_frozen_indices,
                                        update_class)
from repro_torch.core.strategy import (CompositeStrategy, get_strategy,
                                       leaf_group, parse_mode_override,
                                       resolve_strategies)
from repro_torch.launch.mesh import MeshShape

PEFT_MODEL = dict(name="smoke-dense-peft", family="dense", num_layers=2,
                  d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                  vocab_size=256)
MODES = ("zero3", "zeropp", "fcdp", "mics")
MESH = MeshShape(("pod", "data", "model"), (2, 2, 1))
MIXED = (("*lora*", "zero3"),)
CELL = ("t", "train", 64, 8)


def _jmesh():
    return make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])


def _bundles(mode, rank=2, overrides=(), compress=False, all_trainable=False,
             **model):
    pc = "int8_pod" if compress else "none"
    kw = dict(mode=mode, min_shard_size=8, peft=True, lora_rank=rank,
              mode_overrides=overrides, param_compress=pc, grad_compress=pc)
    cfg = dict(PEFT_MODEL, **model)
    jb = JStepBundle(JRunConfig(model=JModelConfig(**cfg),
                                shape=JShapeCell(*CELL),
                                system=JSystemConfig(**kw)), _jmesh(),
                     defs_fn=jpeft.unfreeze_all if all_trainable else None)
    pb = StepBundle(RunConfig(model=ModelConfig(**cfg), shape=ShapeCell(*CELL),
                              system=SystemConfig(**kw)),
                    device="cpu", mesh=MESH,
                    defs_fn=peft.unfreeze_all if all_trainable else None)
    return jb, pb


@pytest.mark.parametrize("overrides", [(), MIXED], ids=["uniform", "mixed"])
@pytest.mark.parametrize("compress,rank", [(False, 2), (True, 8)])
@pytest.mark.parametrize("mode", MODES)
def test_peft_layout_equals_jax(mode, compress, rank, overrides):
    """Leaf for leaf: the labels and group tags, the residency field for
    field, the storage and optimizer specs, the replication factors and
    the train/frozen split."""
    jb, pb = _bundles(mode, rank, overrides, compress)
    assert pb.paths == [d.label for d in jb.def_leaves]
    assert [d.strategy for d in pb.def_leaves] == \
        [d.strategy for d in jb.def_leaves]
    assert [(d.shape, d.dims, d.frozen, d.init) for d in pb.def_leaves] == \
        [(d.shape, d.dims, d.frozen, d.init) for d in jb.def_leaves]
    assert pb.leaf_specs == [tuple(s) for s in jb.leaf_specs]
    assert pb.full_specs == [tuple(s) for s in jb.full_specs]
    assert pb.rep_factors == jb.rep_factors
    assert (pb.train_idx, pb.frozen_idx) == (jb.train_idx, jb.frozen_idx)
    for got, want, d in zip(pb.plan_leaves, jb.plan_leaves, pb.def_leaves):
        for f in dataclasses.fields(got.residency):
            assert getattr(got.residency, f.name) == getattr(
                want.residency, f.name), (mode, d.label, f.name)
        for prop in ("frozen", "invariant_gather", "occupies_ring_slot",
                     "receives_gradient", "has_optimizer_state",
                     "backward_source"):
            assert getattr(got.residency, prop) == getattr(
                want.residency, prop), (mode, d.label, prop)
    assert type(pb.strategy).__name__ == type(jb.strategy).__name__
    if overrides and mode != "zero3":
        assert pb.strategy.group_names() == jb.strategy.group_names()


@pytest.mark.parametrize("mode", MODES)
def test_frozen_trunk_tiers(mode):
    """fcdp's frozen trunk is 'frozen_cached', pod-replicated, out of the
    ring, its full weight cached after stage 2 on the host; the other
    modes keep their layouts for frozen leaves ('frozen'): zero3 and
    zeropp dcn_sharded (stage 1 per step), mics pod-replicated."""
    _, pb = _bundles(mode)
    trunk = [pb.plan_leaves[i].residency for i in pb.frozen_idx]
    assert len(trunk) == 12
    want_tier = {"fcdp": "pod_replicated", "mics": "pod_replicated"}.get(
        mode, "dcn_sharded")
    assert {r.tier for r in trunk} == {want_tier}
    assert {r.update for r in trunk} == {
        "frozen_cached" if mode == "fcdp" else "frozen"}
    assert all(r.occupies_ring_slot == (want_tier == "dcn_sharded")
               for r in trunk)
    if mode == "fcdp":
        assert {(r.cache_after, r.backward_source) for r in trunk} == {
            (2, "host_cache")}
    for i in pb.train_idx:
        assert pb.plan_leaves[i].residency.receives_gradient


def test_apply_lora_equals_jax_and_targets_only_what_is_asked():
    """Adapters next to each configured target, with the JAX package's
    shapes, dims and inits; every base def frozen; targets on the MLP
    are injected too (and left unused by the model, as in the JAX
    package)."""
    for targets in (("wq", "wk", "wv", "wo"), ("wq", "w_in")):
        sysp = SystemConfig(peft=True, lora_rank=4, lora_targets=targets)
        sysj = JSystemConfig(peft=True, lora_rank=4, lora_targets=targets)
        from repro.models.registry import build_model
        jdefs = jpeft.apply_lora(
            build_model(JModelConfig(**PEFT_MODEL), sysj, _jmesh()).defs,
            JModelConfig(**PEFT_MODEL), sysj)
        pdefs = peft.apply_lora(
            StepBundle(RunConfig(model=ModelConfig(**PEFT_MODEL),
                                 shape=ShapeCell(*CELL)),
                       device="cpu").model.defs, sysp)
        want = {d.label: d for d in jax.tree.leaves(
            j_label_tree(jdefs), is_leaf=lambda x: isinstance(x, JParamDef))}
        got = dict(tree_items(label_tree(pdefs)))
        assert set(got) == set(want)
        for path, d in got.items():
            w = want[path]
            assert (d.shape, d.dims, d.init, d.init_scale, d.frozen) == (
                w.shape, w.dims, w.init, w.init_scale, w.frozen), path
        adapters = {p for p in got if "_lora_" in p}
        sub = {t: "attn" if t in peft.LORA_TARGETS_IN_ATTN else "mlp"
               for t in targets}
        assert adapters == {f"blocks.pos0.{sub[t]}.{t}_lora_{ab}"
                            for t in targets for ab in "ab"}
        assert all(not got[p].frozen for p in adapters)
        assert all(d.frozen for p, d in got.items() if p not in adapters)
    a = got["blocks.pos0.attn.wq_lora_a"]
    assert a.shape == (2, 256, 4) and a.dims == ("stack", "fsdp", None)


def test_apply_lora_without_a_site_raises_as_in_jax():
    sysp = SystemConfig(peft=True, lora_targets=("q_proj",))
    with pytest.raises(ValueError, match="no LoRA injection sites"):
        StepBundle(RunConfig(model=ModelConfig(**PEFT_MODEL),
                             shape=ShapeCell(*CELL), system=sysp),
                   device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match="no LoRA injection sites"):
        JStepBundle(JRunConfig(model=JModelConfig(**PEFT_MODEL),
                               shape=JShapeCell(*CELL),
                               system=JSystemConfig(
                                   peft=True, lora_targets=("q_proj",))),
                    _jmesh())


@pytest.mark.parametrize("rank,alpha,want", [(8, None, 2.0), (2, None, 2.0),
                                             (8, 16.0, 2.0), (8, 4.0, 0.5),
                                             (4, 1.0, 0.25)])
def test_lora_scale(rank, alpha, want):
    sysp = SystemConfig(lora_rank=rank, lora_alpha=alpha)
    sysj = JSystemConfig(lora_rank=rank, lora_alpha=alpha)
    assert peft.lora_scale(sysp) == jpeft.lora_scale(sysj) == want


def test_peft_fields_default_as_in_jax():
    p, j = SystemConfig(), JSystemConfig()
    for f in ("peft", "lora_rank", "lora_targets", "lora_alpha",
              "mode_overrides"):
        assert getattr(p, f) == getattr(j, f), f
    assert peft.LORA_TARGETS_IN_ATTN == jpeft.LORA_TARGETS_IN_ATTN


@pytest.mark.parametrize("update", ["frozen", "frozen_cached"])
@pytest.mark.parametrize("field,value", [("quantized_gather", True),
                                         ("quantized_reduce", True),
                                         ("fused", "ag_matmul")])
def test_non_trainable_residency_refuses_transports(update, field, value):
    base = dict(tier="dcn_sharded", cache="host", update=update, fsdp_dim=0,
                stage1_axes=("pod",), stage2_axes=("data",), cache_after=1)
    ParamResidency(**base)
    ParamResidency(**dict(base, update="trainable", **{field: value}))
    with pytest.raises(ValueError, match=update):
        ParamResidency(**dict(base, **{field: value}))


def test_update_class_resolution():
    d = ParamDef((8, 8), (None, None))
    assert update_class(d) == "trainable"
    f = dataclasses.replace(d, frozen=True)
    assert update_class(f) == "frozen"
    assert update_class(f, frozen_cached_layout=True) == "frozen_cached"
    r = get_strategy("fcdp").residency(f, MESH, 8)
    assert (r.update, r.frozen, r.receives_gradient,
            r.has_optimizer_state) == ("frozen_cached", True, False, False)
    assert get_strategy("zero3").residency(f, MESH, 8).update == "frozen"


@pytest.mark.parametrize("fused", ["ag_matmul", "both"])
def test_frozen_projection_declines_the_fused_ring(fused):
    """Under fused_matmul a frozen wo/w_out declines silently, as in the
    JAX package; its adapter ``wo_lora_b`` ([r, d], no opt-in) too."""
    wo = ParamDef((2, 256, 256), ("stack", "tp", "fsdp"), fusable=True)
    jwo = JParamDef((2, 256, 256), ("stack", "tp", "fsdp"), fusable=True)
    for frozen, want in ((False, fused), (True, "none")):
        for mode in MODES:
            got = get_strategy(mode).residency(
                dataclasses.replace(wo, frozen=frozen), MESH, 8,
                fused_matmul=fused)
            ref = j_get_strategy(mode).residency(
                dataclasses.replace(jwo, frozen=frozen), _jmesh(), 8,
                fused_matmul=fused, fused_impl="jnp")
            assert got.fused == ref.fused == want, (mode, frozen)


def test_split_stable_under_lora_and_reresolution():
    _, b = _bundles("fcdp", overrides=MIXED)
    labels = [d.label for d in b.def_leaves]
    assert all("_lora_" in labels[i] for i in b.train_idx)
    assert not any("_lora_" in labels[i] for i in b.frozen_idx)
    assert sorted(b.train_idx + b.frozen_idx) == list(range(len(labels)))
    assert peft.split_frozen_indices(b.defs) == (b.train_idx, b.frozen_idx)
    defs2, _ = resolve_strategies(b.run.system, label_tree(b.defs))
    assert split_frozen_indices([d for _, d in tree_items(defs2)]) == (
        b.train_idx, b.frozen_idx)
    assert [p for p, _ in tree_items(defs2)] == labels


def test_all_trainable_arm_trains_every_leaf():
    jb, pb = _bundles("fcdp", all_trainable=True)
    assert pb.frozen_idx == jb.frozen_idx == []
    assert len(pb.train_idx) == len(pb.def_leaves) == 20
    assert pb.leaf_specs == [tuple(s) for s in jb.leaf_specs]


# -- mode_overrides: validation and per-leaf resolution -------------------------

def test_mode_overrides_construction_validation():
    with pytest.raises(ValueError, match="unknown strategy"):
        SystemConfig(mode_overrides=(("embed", "zero17"),))
    with pytest.raises(ValueError, match="malformed"):
        SystemConfig(mode_overrides=("noequals",))
    with pytest.raises(ValueError, match="malformed"):
        SystemConfig(mode_overrides=(("embed",),))
    with pytest.raises(ValueError, match="malformed"):
        SystemConfig(mode_overrides=((" ", "fcdp"),))
    s = SystemConfig(mode_overrides=("embed=mics", ("head", "zero3")))
    assert s.mode_overrides == (("embed", "mics"), ("head", "zero3"))
    assert s.mode_overrides == JSystemConfig(
        mode_overrides=("embed=mics", ("head", "zero3"))).mode_overrides
    assert parse_mode_override(" blocks.* = mics ") == ("blocks.*", "mics")
    with pytest.raises(ValueError, match="malformed"):
        parse_mode_override("=mics")


def test_resolution_order():
    defs = label_tree({
        "a": ParamDef((8, 8), ("fsdp", None)),
        "b": ParamDef((8, 8), ("fsdp", None), strategy="zeropp"),
        "c": ParamDef((8, 8), ("fsdp", None)),
    })
    sysc = SystemConfig(mode="fcdp",
                        mode_overrides=(("b", "mics"), ("c", "mics"),
                                        ("*", "zero3")))
    tagged, strat = resolve_strategies(sysc, defs)
    assert isinstance(strat, CompositeStrategy)
    names = {p: d.strategy for p, d in tree_items(tagged)}
    assert names == {"a": "zero3", "b": "zeropp", "c": "mics"}
    assert strat.group_names() == ("mics", "zero3", "zeropp")
    assert {leaf_group(strat, d) for _, d in tree_items(tagged)} == {
        "mics", "zero3", "zeropp"}
    assert leaf_group(strat, ParamDef((8,), (None,))) == "fcdp"
    assert leaf_group(get_strategy("mics"), ParamDef((8,), (None,))) == "mics"


def test_uniform_resolution_returns_singleton():
    defs = label_tree({"a": ParamDef((8, 8), ("fsdp", None))})
    out, strat = resolve_strategies(SystemConfig(mode="zeropp"), defs)
    assert strat is get_strategy("zeropp") and out is defs
    out, strat = resolve_strategies(
        SystemConfig(mode="zeropp", mode_overrides=(("a", "zeropp"),)), defs)
    assert strat is get_strategy("zeropp")
    assert out["a"].strategy == "zeropp"


def test_composite_gates_qwz_per_group():
    """Per-leaf dispatch gates qwZ by the leaf's own group: a mics leaf
    inside an fcdp composite keeps its exact (stage-1-free) gather."""
    d = ParamDef((4, 64, 64), ("stack", "fsdp", "tp"))
    comp = CompositeStrategy(get_strategy("fcdp"),
                             {"fcdp": get_strategy("fcdp"),
                              "mics": get_strategy("mics")})
    on_fcdp = comp.residency(d, MESH, 8, True, True)
    on_mics = comp.residency(dataclasses.replace(d, strategy="mics"),
                             MESH, 8, True, True)
    assert on_fcdp.quantized_gather and on_fcdp.quantized_reduce
    assert not on_mics.quantized_gather and on_mics.stage1_axes == ()
    assert comp.supports_quantized_gather
    assert comp.cache_placement == "host"


def test_lora_override_rule_resolves_after_injection():
    """'*lora*' matches nothing on the base tree: the bundle must not
    reject it under peft; after injection the adapters form their own
    zero3 group, the trunk stays fcdp."""
    _, b = _bundles("fcdp", overrides=MIXED)
    assert {leaf_group(b.strategy, d) for d in b.def_leaves} == {"fcdp",
                                                                 "zero3"}
    for i in b.train_idx:
        assert leaf_group(b.strategy, b.def_leaves[i]) == "zero3"
    for i in b.frozen_idx:
        assert leaf_group(b.strategy, b.def_leaves[i]) == "fcdp"


def test_dead_rule_still_raises_under_peft():
    with pytest.raises(ValueError, match="matched zero"):
        _bundles("fcdp", overrides=(("*no_such_param*", "zero3"),))


def test_lora_rule_without_peft_raises_at_construction():
    sysc = SystemConfig(mode="fcdp", min_shard_size=8, mode_overrides=MIXED)
    with pytest.raises(ValueError, match="matched zero"):
        StepBundle(RunConfig(model=ModelConfig(**PEFT_MODEL),
                             shape=ShapeCell(*CELL), system=sysc),
                   device="cpu", mesh=MESH)


def test_unknown_tag_raises():
    defs = label_tree({"a": ParamDef((8, 8), ("fsdp", None),
                                     strategy="no_such_mode")})
    with pytest.raises(ValueError, match="unknown system mode"):
        resolve_strategies(SystemConfig(), defs)


# -- the model consumes the attention adapters only -----------------------------

def _serve_logits(targets, touch):
    """Prefill logits of a 2-layer PEFT model (adapters on ``targets``)
    after setting the ``touch`` adapters' B to random values."""
    cfg = ModelConfig(**dict(PEFT_MODEL, vocab_size=64))
    sysc = SystemConfig(dtype="float32", peft=True, lora_rank=2,
                        lora_targets=targets)
    b = StepBundle(RunConfig(model=cfg, shape=ShapeCell("s", "prefill", 16, 2),
                             system=sysc), device="cpu")
    params = b.init_all_params(seed=0)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(1, 64, (2, 16), generator=gen)
    for name in touch:
        sub = "attn" if name in peft.LORA_TARGETS_IN_ATTN else "mlp"
        t = params["blocks"]["pos0"][sub][f"{name}_lora_b"]
        t.copy_(torch.randn(t.shape, generator=gen))
    logits, _ = b.make_prefill_step()(params, ids, b.init_state())
    return logits


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo"])
def test_attention_adapters_change_the_output(name):
    base = _serve_logits(("wq", "wk", "wv", "wo"), ())
    moved = _serve_logits(("wq", "wk", "wv", "wo"), (name,))
    assert not torch.allclose(base, moved), name


def test_mlp_adapter_is_left_unused_as_in_jax():
    """An adapter injected next to an MLP projection (lora_targets
    naming w_in) is not consumed: the model's output does not move
    however its B is set. The JAX package's sublayers pass adapters to
    attention only (``repro/models/sublayers.py`` ``_lora_kwargs``), so
    the reference trains such an adapter on a zero gradient too."""
    base = _serve_logits(("wq", "w_in"), ())
    assert torch.equal(base, _serve_logits(("wq", "w_in"), ("w_in",)))
    assert not torch.equal(base, _serve_logits(("wq", "w_in"), ("wq",)))


def test_lora_term_goes_in_before_rope():
    """The q adapter term is added to the projection before RoPE: a
    B that puts the term into q must give the attention output of the
    merged weight wq + scale * A @ B (RoPE is linear per position, so
    adding after RoPE would differ from the merged weight at every
    position but 0)."""
    from repro_torch.models import attention as attn
    cfg = ModelConfig(**dict(PEFT_MODEL, d_model=64, num_heads=4,
                             num_kv_heads=2, head_dim=16))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 64, generator=g)
    wq, wk, wv, wo = (torch.randn(64, 64, generator=g) * 0.1,
                      torch.randn(64, 32, generator=g) * 0.1,
                      torch.randn(64, 32, generator=g) * 0.1,
                      torch.randn(64, 64, generator=g) * 0.1)
    a, b = torch.randn(64, 2, generator=g), torch.randn(2, 64, generator=g)
    pos = torch.arange(8)[None, :]
    got = attn.attention_train(x, wq, wk, wv, wo, None, None, None, cfg, pos,
                               lora={"wq_lora_a": a, "wq_lora_b": b},
                               lora_scale=0.5)
    want = attn.attention_train(x, wq + 0.5 * a @ b, wk, wv, wo, None, None,
                                None, cfg, pos)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_peft_defaults_resolve_for_every_mode_and_override():
    """Every (mode, override) pair the slice runs builds on the mesh."""
    for mode, ov in itertools.product(MODES, ((), MIXED)):
        _, pb = _bundles(mode, overrides=ov)
        assert len(pb.train_idx) == 8


def test_params_from_jax_takes_the_adapters():
    """A JAX tree holding adapters converts under ``sys.peft`` leaf for
    leaf, bit for bit; without ``peft`` the adapters are extra leaves,
    and the port refuses the tree."""
    import numpy as np
    from repro_torch.convert import params_from_jax
    jb, _ = _bundles("fcdp")
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in
                                           jb.init_all_params(seed=0)])
    cfg = ModelConfig(**PEFT_MODEL)
    got = params_from_jax(tree, cfg, device="cpu",
                          sys=SystemConfig(peft=True, lora_rank=2))
    want = dict(tree_items(tree))
    assert set(dict(tree_items(got))) == set(want)
    for path, t in tree_items(got):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.float().numpy(),
                              want[path].astype(np.float32)), path
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(tree, cfg, device="cpu")
