"""The port's decision layer against the JAX package's: for every leaf
of ``tests/test_system.py``'s ``DENSE`` model on the (pod 2, data 2,
model 1) mesh, under every ported mode, with and without the int8
stage-1 transports, the port's ``ParamResidency`` equals the JAX one
field for field, its storage and optimizer specs equal the JAX
``PartitionSpec``s entry for entry, and the qwZ / qgZ gates agree; the
gather-fused collective matmul's per-leaf gate (``fused_matmul``) agrees
on the same leaves and on ``tests/test_fused_matmul.py``'s eligible and
declined cases. Exact: these are decisions, not numbers."""
import dataclasses
import itertools
import math

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
    """The launcher's mesh follows the JAX package's ``make_smoke_mesh``:
    model = gcd(world/2, 2) with a pod axis, gcd(world, 2) without."""
    assert train_mesh_shape(8, True) == MeshShape(("pod", "data", "model"),
                                                  (2, 2, 2))
    assert train_mesh_shape(4, True) == MeshShape(("pod", "data", "model"),
                                                  (2, 1, 2))
    assert train_mesh_shape(2, True).shape == {"pod": 2, "data": 1,
                                               "model": 1}
    assert train_mesh_shape(4, False).shape == {"data": 2, "model": 2}
    assert train_mesh_shape(1, False).shape == {"data": 1, "model": 1}
    assert [MESH.coords(r) for r in range(4)] == [
        {"pod": p, "data": d, "model": 0} for p in (0, 1) for d in (0, 1)]
    with pytest.raises(ValueError):
        train_mesh_shape(3, True)


# -- the gather-fused collective matmul's plan-level eligibility ----------------

FUSED = ("none", "ag_matmul", "both")
MESH3 = MeshShape(("pod", "data", "model"), (2, 2, 2))
MESH2 = MeshShape(("data", "model"), (4, 2))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", FUSED)
def test_fused_residency_equals_jax(jax_defs, port_defs, mode, fused):
    """Leaf for leaf, the port's residency under ``fused_matmul`` equals
    the JAX one field for field: wo and w_out fuse wherever their fsdp
    dim shards over one intra axis of degree > 1 with a per-use stage 2
    (every mode on this mesh), nothing else does."""
    mesh, jdefs = jax_defs
    js, ps = j_get_strategy(mode), get_strategy(mode)
    fused_paths = set()
    for path, d in port_defs.items():
        want = js.residency(jdefs[path], mesh, 8, fused_matmul=fused,
                            fused_impl="jnp")
        got = ps.residency(d, MESH, 8, fused_matmul=fused)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (mode, fused, path, f.name)
        if got.fused != "none":
            fused_paths.add(path.rsplit(".", 1)[-1])
    assert fused_paths == (set() if fused == "none" else {"wo", "w_out"})


def _jax_mesh(shape, names):
    return make_mesh(shape, names, devices=jax.devices()[:math.prod(shape)])


def _proj(**kw):
    kw.setdefault("fusable", True)
    return ParamDef((256, 128), ("tp", "fsdp"), **kw)


def _jproj(**kw):
    kw.setdefault("fusable", True)
    return JParamDef((256, 128), ("tp", "fsdp"), **kw)


@pytest.mark.parametrize("mode,mesh_name", [("fcdp", "mesh3"),
                                            ("zero3", "mesh3"),
                                            ("zero3", "mesh2"),
                                            ("mics", "mesh3")])
def test_fused_gate_admits_like_jax(mode, mesh_name):
    """test_fused_matmul.py's eligible cases: a projection and its
    stacked form on the multi-pod mesh; zero3 regathers stage 2 per use
    on any mesh."""
    mesh, jmesh = {"mesh3": (MESH3, ((2, 2, 2), ("pod", "data", "model"))),
                   "mesh2": (MESH2, ((4, 2), ("data", "model")))}[mesh_name]
    jm = _jax_mesh(*jmesh)
    for d, jd in ((_proj(), _jproj()),
                  (ParamDef((4, 256, 128), ("stack", "tp", "fsdp"),
                            fusable=True),
                   JParamDef((4, 256, 128), ("stack", "tp", "fsdp"),
                             fusable=True))):
        want = j_get_strategy(mode).gather_plan(jd, jm, 0,
                                                fused_matmul="ag_matmul")
        got = get_strategy(mode).gather_plan(d, mesh, 0,
                                             fused_matmul="ag_matmul")
        assert want.is_fused and got.is_fused and got.fused == "ag_matmul"
        assert got.intra_axes == tuple(want.intra_axes)
    assert not get_strategy(mode).gather_plan(_proj(), mesh, 0).is_fused


def test_fused_gate_declines_like_jax():
    """test_fused_matmul.py's decline cases: no opt-in (an embedding
    table has a projection's dims), an input-dim-sharded matrix, a 1-D
    leaf, an elementwise-consumed leaf without the opt-in, and a
    single-pod fcdp/zeropp leaf whose cache is the fully gathered weight
    (cache_after 2), and a frozen leaf (PEFT), under every mode."""
    jm3 = _jax_mesh((2, 2, 2), ("pod", "data", "model"))
    jm2 = _jax_mesh((4, 2), ("data", "model"))
    cases = [
        ("fcdp", _proj(fusable=False), _jproj(fusable=False), MESH3, jm3),
        ("fcdp", ParamDef((256, 128), ("fsdp", "tp"), fusable=True),
         JParamDef((256, 128), ("fsdp", "tp"), fusable=True), MESH3, jm3),
        ("fcdp", ParamDef((128,), ("fsdp",), fusable=True),
         JParamDef((128,), ("fsdp",), fusable=True), MESH3, jm3),
        ("fcdp", ParamDef((6, 128), (None, "fsdp")),
         JParamDef((6, 128), (None, "fsdp")), MESH3, jm3),
        ("fcdp", _proj(), _jproj(), MESH2, jm2),
        ("zeropp", _proj(), _jproj(), MESH2, jm2),
    ] + [(mode, _proj(frozen=True), _jproj(frozen=True), MESH3, jm3)
         for mode in MODES]
    for mode, d, jd, mesh, jm in cases:
        want = j_get_strategy(mode).gather_plan(jd, jm, 0,
                                                fused_matmul="ag_matmul")
        got = get_strategy(mode).gather_plan(d, mesh, 0,
                                             fused_matmul="ag_matmul")
        assert not want.is_fused and not got.is_fused, (mode, d)
    assert get_strategy("fcdp").gather_plan(_proj(), MESH2, 0).cache_after \
        == 2


def test_fused_strategy_opt_out():
    """A strategy that declines keeps its unfused stage 2 for eligible
    leaves."""
    from repro_torch.core.strategy import FCDP

    class Declining(FCDP):
        name = "declining_fused"
        supports_fused_matmul = False

    assert not Declining().gather_plan(_proj(), MESH3, 0,
                                       fused_matmul="both").is_fused
    assert FCDP().gather_plan(_proj(), MESH3, 0, fused_matmul="both").is_fused


def test_mics_both_raises_at_plan_time():
    """MiCS stores pod-replicated, so mode 'both' would have to sum the
    ring-scattered dw over 'pod'; the JAX package's step fails to trace
    there ('varying manual axes do not match'), and the port refuses the
    plan with a ValueError naming it. 'ag_matmul' is fine."""
    run = RunConfig(model=ModelConfig(**DENSE),
                    shape=ShapeCell("t", "train", 64, 8),
                    system=SystemConfig(mode="mics", min_shard_size=8,
                                        fused_matmul="both"))
    with pytest.raises(ValueError, match="varying manual axes"):
        StepBundle(run, device="cpu", mesh=MESH)
    ok = dataclasses.replace(run, system=dataclasses.replace(
        run.system, fused_matmul="ag_matmul"))
    assert sum(p.is_fused for p in StepBundle(ok, device="cpu",
                                              mesh=MESH).plan_leaves) == 2


def test_fused_config_validation():
    for v in FUSED:
        assert SystemConfig(fused_matmul=v).fused_matmul == v
    with pytest.raises(ValueError, match="fused_matmul"):
        SystemConfig(fused_matmul="everything")
