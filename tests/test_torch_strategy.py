"""The port's decision layer against the JAX package's: for every leaf
of ``tests/test_system.py``'s ``DENSE`` model on the (pod 2, data 2,
model 1) mesh, under every ported mode, with and without the int8
stage-1 transports, the port's ``ParamResidency`` equals the JAX one
field for field, its storage and optimizer specs equal the JAX
``PartitionSpec``s entry for entry, and the qwZ / qgZ gates agree.
Exact: these are decisions, not numbers."""
import dataclasses
import itertools

import jax
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.core.engine import StepBundle as JStepBundle
from repro.core.partition import ParamDef as JParamDef
from repro.core.strategy import get_strategy as j_get_strategy
from repro.launch.mesh import make_mesh
from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeCell,
                                      SystemConfig)
from repro_torch.core.engine import StepBundle
from repro_torch.core.partition import ParamDef, tree_items
from repro_torch.core.strategy import (QUANT_MIN_SHARD_ELEMS, get_strategy,
                                       strategy_names)
from repro_torch.launch.mesh import MeshShape, train_mesh_shape

DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
MODES = ("zero3", "zeropp", "fcdp", "mics")
MESH = MeshShape(("pod", "data", "model"), (2, 2, 1))
COMPRESS = list(itertools.product((False, True), repeat=2))


@pytest.fixture(scope="module")
def jax_defs():
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])
    run = JRunConfig(model=JModelConfig(**DENSE),
                     shape=JShapeCell("t", "train", 64, 8),
                     system=JSystemConfig(min_shard_size=8))
    b = JStepBundle(run, mesh)
    return mesh, {d.label: d for d in b.def_leaves}


@pytest.fixture(scope="module")
def port_defs():
    run = RunConfig(model=ModelConfig(**DENSE),
                    shape=ShapeCell("t", "train", 64, 8),
                    system=SystemConfig(min_shard_size=8))
    return dict(tree_items(StepBundle(run, device="cpu", mesh=MESH).defs))


def test_same_leaves(jax_defs, port_defs):
    _, jdefs = jax_defs
    assert set(jdefs) == set(port_defs)
    for path, d in port_defs.items():
        assert d.shape == jdefs[path].shape and d.dims == jdefs[path].dims


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compress_bwd,param_compress", COMPRESS)
def test_residency_equals_jax(jax_defs, port_defs, mode, compress_bwd,
                              param_compress):
    mesh, jdefs = jax_defs
    js, ps = j_get_strategy(mode), get_strategy(mode)
    for path, d in port_defs.items():
        want = js.residency(jdefs[path], mesh, 8, compress_bwd,
                            param_compress)
        got = ps.residency(d, MESH, 8, compress_bwd, param_compress)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (mode, path, f.name)
        # the JAX fields the port has no knob for sit at their defaults,
        # which is the behaviour the port implements
        assert (want.quant_impl, want.fused) == ("jnp", "none")
        assert got.backward_source == want.backward_source
        assert got.is_gathered == want.is_gathered


@pytest.mark.parametrize("mode", MODES)
def test_specs_equal_jax(jax_defs, port_defs, mode):
    mesh, jdefs = jax_defs
    js, ps = j_get_strategy(mode), get_strategy(mode)
    for path, d in port_defs.items():
        assert ps.storage_spec(d, MESH, 8) == tuple(
            js.storage_spec(jdefs[path], mesh, 8)), (mode, path)
        assert ps.opt_spec(d, MESH, 8) == tuple(
            js.opt_spec(jdefs[path], mesh, 8)), (mode, path)


@pytest.mark.parametrize("mode", MODES)
def test_bundle_layout_equals_jax(mode):
    """The bundles' per-leaf specs, replication factors and train split
    agree on the mesh the train tests run."""
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])
    jb = JStepBundle(JRunConfig(model=JModelConfig(**DENSE),
                                shape=JShapeCell("t", "train", 64, 8),
                                system=JSystemConfig(mode=mode,
                                                     min_shard_size=8)),
                     mesh)
    pb = StepBundle(RunConfig(model=ModelConfig(**DENSE),
                              shape=ShapeCell("t", "train", 64, 8),
                              system=SystemConfig(mode=mode,
                                                  min_shard_size=8)),
                    device="cpu", mesh=MESH)
    assert pb.paths == [d.label for d in jb.def_leaves]
    assert pb.leaf_specs == [tuple(s) for s in jb.leaf_specs]
    assert pb.full_specs == [tuple(s) for s in jb.full_specs]
    assert pb.rep_factors == jb.rep_factors
    assert (pb.train_idx, pb.frozen_idx) == (jb.train_idx, jb.frozen_idx)


def test_qwz_gate_big_vs_small_leaf(jax_defs):
    """test_quant.py's gate: a sub-block per-slice shard stays exact."""
    mesh, _ = jax_defs
    for shape, dims in (((4, 64, 64), ("stack", "fsdp", "tp")),
                        ((4, 64), ("stack", "fsdp"))):
        jd, d = JParamDef(shape, dims), ParamDef(shape, dims)
        for kw in ({}, dict(param_compress=True, compress_bwd=True)):
            want = j_get_strategy("fcdp").gather_plan(jd, mesh, 8, **kw)
            got = get_strategy("fcdp").gather_plan(d, MESH, 8, **kw)
            assert (got.residency.quantized_gather,
                    got.residency.quantized_reduce) == (
                want.compress_fwd, want.compress_bwd), (shape, kw)
    big = get_strategy("fcdp").gather_plan(
        ParamDef((4, 64, 64), ("stack", "fsdp", "tp")), MESH, 8,
        compress_bwd=True, param_compress=True)
    assert big.residency.quantized_gather and big.residency.quantized_reduce
    assert QUANT_MIN_SHARD_ELEMS == 256


def test_mics_declines_qwz_but_has_no_stage1():
    d = ParamDef((4, 64, 64), ("stack", "fsdp", "tp"))
    p = get_strategy("mics").gather_plan(d, MESH, 8, compress_bwd=True,
                                         param_compress=True)
    assert p.inter_axes == () and not p.residency.quantized_gather
    assert not p.residency.quantized_reduce
    assert p.sync_axes == ("pod",)


def test_frozen_leaves_are_refused():
    """PEFT / FCDP-Comm is not ported: a frozen leaf raises instead of
    being laid out as if it were trainable."""
    frozen = ParamDef((4, 64, 64), ("stack", "fsdp", "tp"), frozen=True)
    with pytest.raises(ValueError, match="frozen"):
        get_strategy("fcdp").residency(frozen, MESH, 8)


def test_registry_and_config_validation():
    assert strategy_names() == MODES
    with pytest.raises(ValueError, match="unknown system mode"):
        StepBundle(RunConfig(model=ModelConfig(**DENSE),
                             shape=ShapeCell("t", "train", 64, 8),
                             system=SystemConfig(mode="hier")),
                   device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match="param_compress"):
        SystemConfig(param_compress="int4")
    with pytest.raises(ValueError, match="grad_compress"):
        SystemConfig(grad_compress="int4")


def test_mesh_shapes():
    assert train_mesh_shape(4, True) == MESH
    assert train_mesh_shape(4, False).shape == {"data": 4, "model": 1}
    assert [MESH.coords(r) for r in range(4)] == [
        {"pod": p, "data": d, "model": 0} for p in (0, 1) for d in (0, 1)]
    with pytest.raises(ValueError):
        train_mesh_shape(3, True)
