"""The port's decision layer against the JAX package's: for every leaf
of ``tests/test_system.py``'s ``DENSE`` model on the (pod 2, data 2,
model 1) mesh, under every ported mode (hier included), with and
without the int8 stage-1 transports, the port's ``ParamResidency``
equals the JAX one field for field, its storage and optimizer specs
equal the JAX ``PartitionSpec``s entry for entry, and the qwZ / qgZ
gates agree; the gather-fused collective matmul's per-leaf gate
(``fused_matmul``) agrees on the same leaves and on
``tests/test_fused_matmul.py``'s eligible and declined cases. hier's
and 'inter_only' leaves' decisions agree on (2, 2, 2) and (4, 2) too,
the prefetch gates agree with ``tests/test_schedule.py`` and
``tests/test_strategy.py``, and the ring's analytic bytes
(``prefetch_buffer_bytes``, per group) equal the JAX function's.
Exact: these are decisions, not numbers."""
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
                                       spec_axes, strategy_names)
from repro_torch.launch.mesh import MeshShape, train_mesh_shape

DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
MODES = ("zero3", "zeropp", "fcdp", "mics", "hier")
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
                             system=SystemConfig(mode="no_such_mode")),
                   device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match="param_compress"):
        SystemConfig(param_compress="int4")
    with pytest.raises(ValueError, match="grad_compress"):
        SystemConfig(grad_compress="int4")
    for bad in (-1, 1.5, True, None):
        with pytest.raises(ValueError, match="prefetch_depth"):
            SystemConfig(prefetch_depth=bad)
    with pytest.raises(ValueError, match="fsdp_scope"):
        ParamDef((8, 8), ("fsdp", None), fsdp_scope="intra_only")


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


# -- hier, 'inter_only' and the prefetch ring ------------------------------------

LAYOUTS = {"mesh3": (MESH3, ((2, 2, 2), ("pod", "data", "model"))),
           "mesh2": (MESH2, ((4, 2), ("data", "model")))}


def _dense_defs(jmesh, mesh):
    """Both packages' labelled DENSE defs on one mesh."""
    jb = JStepBundle(JRunConfig(model=JModelConfig(**DENSE),
                                shape=JShapeCell("t", "train", 64, 8),
                                system=JSystemConfig(min_shard_size=8)),
                     jmesh)
    pb = StepBundle(RunConfig(model=ModelConfig(**DENSE),
                              shape=ShapeCell("t", "train", 64, 8),
                              system=SystemConfig(min_shard_size=8)),
                    device="cpu", mesh=mesh)
    return {d.label: d for d in jb.def_leaves}, dict(tree_items(pb.defs))


@pytest.mark.parametrize("mesh_name", sorted(LAYOUTS))
@pytest.mark.parametrize("mode,scope", [("hier", "full"),
                                        ("hier", "inter_only"),
                                        ("fcdp", "inter_only"),
                                        ("zero3", "inter_only"),
                                        ("mics", "inter_only")])
def test_hier_and_inter_only_equal_jax(mesh_name, mode, scope):
    """Per leaf: storage and optimizer specs, residency and the gather
    plan's stages equal the JAX package's; a widened leaf's gradient sum
    leaves out the widening axes (``sync_axes``), the rest of its
    replicated axes stays."""
    mesh, jlayout = LAYOUTS[mesh_name]
    jm = _jax_mesh(*jlayout)
    jdefs, pdefs = _dense_defs(jm, mesh)
    js, ps = j_get_strategy(mode), get_strategy(mode)
    n_widened = 0
    for path, d in pdefs.items():
        d = dataclasses.replace(d, fsdp_scope=scope)
        jd = dataclasses.replace(jdefs[path], fsdp_scope=scope)
        storage = ps.storage_spec(d, mesh, 8)
        opt = ps.opt_spec(d, mesh, 8)
        assert storage == tuple(js.storage_spec(jd, jm, 8)), (path, "storage")
        assert opt == tuple(js.opt_spec(jd, jm, 8)), (path, "opt")
        want = js.gather_plan(jd, jm, 8)
        got = ps.gather_plan(d, mesh, 8)
        for f in dataclasses.fields(got.residency):
            assert getattr(got.residency, f.name) == getattr(
                want.residency, f.name), (path, f.name)
        assert (got.fsdp_dim, got.inter_axes, got.intra_axes,
                got.cache_after) == (want.fsdp_dim, tuple(want.inter_axes),
                                     tuple(want.intra_axes),
                                     want.cache_after), path
        replicated = {a for a in mesh.axis_names if a != "model"
                      and mesh.size(a) > 1} - spec_axes(storage)
        widening = spec_axes(opt) - spec_axes(storage)
        n_widened += bool(widening)
        assert set(got.sync_axes) == replicated - widening, path
    # hier widens its sharded leaves over 'pod', 'inter_only' ones over
    # the intra axes: only hier's full scope without 'pod' has nothing
    assert (n_widened > 0) == ("pod" in mesh.axis_names
                               or scope == "inter_only")


def test_hier_opt_spec_falls_back_when_the_full_width_does_not_divide():
    """An fsdp dim that splits over 'data' but not over ('data', 'pod')
    keeps the parameter's layout, as in the JAX package."""
    mesh = MeshShape(("pod", "data", "model"), (2, 3, 1))
    jm = _jax_mesh((2, 3, 1), ("pod", "data", "model"))
    d, jd = ParamDef((9, 64), ("fsdp", None)), JParamDef((9, 64),
                                                         ("fsdp", None))
    got = get_strategy("hier").opt_spec(d, mesh, 0)
    assert got == tuple(j_get_strategy("hier").opt_spec(jd, jm, 0))
    assert got == get_strategy("hier").storage_spec(d, mesh, 0) \
        == ("data", None)
    wide = ParamDef((12, 64), ("fsdp", None))
    assert get_strategy("hier").opt_spec(wide, mesh, 0) == (("data", "pod"),
                                                            None)


def test_mics_and_hier_both_raise_at_plan_time():
    """hier stores pod-replicated as mics does, so fused 'both' is
    refused there too, widening or not."""
    for mode in ("mics", "hier"):
        run = RunConfig(model=ModelConfig(**DENSE),
                        shape=ShapeCell("t", "train", 64, 8),
                        system=SystemConfig(mode=mode, min_shard_size=8,
                                            fused_matmul="both"))
        with pytest.raises(ValueError, match="varying manual axes"):
            StepBundle(run, device="cpu", mesh=MESH)


class _M3:
    axis_names = ("pod", "data", "model")


class _M2:
    axis_names = ("data", "model")


def test_strategy_stream_capabilities():
    """tests/test_schedule.py's: the depth clamps to the capability and
    needs a pod axis; mics and hier cannot stream."""
    deep = SystemConfig(prefetch_depth=64)
    for mode in ("zero3", "zeropp", "fcdp"):
        s, js = get_strategy(mode), j_get_strategy(mode)
        assert s.supports_prefetch and s.max_prefetch_depth == \
            js.max_prefetch_depth == 8
        assert s.prefetch_depth(deep, _M3()) == s.max_prefetch_depth
        assert s.prefetch_depth(deep, _M2()) == 0
    for mode in ("mics", "hier"):
        s = get_strategy(mode)
        assert not s.supports_prefetch and s.max_prefetch_depth == 0
        assert s.prefetch_depth(deep, _M3()) == 0


@pytest.mark.parametrize("depth", [0, 1, 2, 9])
def test_prefetch_gating(depth):
    """tests/test_strategy.py's: prefetch needs a pod axis, a willing
    strategy and the config's depth; every answer equals the JAX one."""
    sysc, jsys = SystemConfig(prefetch_depth=depth), JSystemConfig(
        prefetch_depth=depth)
    for mode in MODES:
        s, js = get_strategy(mode), j_get_strategy(mode)
        for m in (_M3(), _M2()):
            assert s.prefetch_depth(sysc, m) == js.prefetch_depth(jsys, m)
            assert s.prefetch_active(sysc, m) == js.prefetch_active(jsys, m)
    assert get_strategy("fcdp").prefetch_active(sysc, _M3()) == (depth > 0)
    assert not get_strategy("mics").prefetch_active(sysc, _M3())


def _ring_bundles(overrides):
    jm = _jax_mesh((2, 2, 2), ("pod", "data", "model"))
    jb = JStepBundle(JRunConfig(
        model=JModelConfig(**DENSE), shape=JShapeCell("t", "train", 64, 8),
        system=JSystemConfig(min_shard_size=8, mode_overrides=overrides)),
        jm)
    pb = StepBundle(RunConfig(
        model=ModelConfig(**DENSE), shape=ShapeCell("t", "train", 64, 8),
        system=SystemConfig(min_shard_size=8, mode_overrides=overrides)),
        device="cpu", mesh=MESH3)
    return jb, pb


@pytest.mark.parametrize("overrides", [(), (("blocks.*.mlp.*", "hier"),
                                            ("embed", "hier"))],
                         ids=["dense", "fcdp_hier"])
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_buffer_bytes_equal_jax(overrides, depth):
    """The ring's analytic bytes per group and in total equal the JAX
    package's on DENSE (fcdp) and on a fcdp/hier composite, whose hier
    leaves hold no slot; the groups sum to the total."""
    from repro.core.schedule import prefetch_buffer_bytes as j_total
    from repro.core.schedule import prefetch_buffer_bytes_by_group as j_by
    from repro_torch.core.schedule import (prefetch_buffer_bytes,
                                           prefetch_buffer_bytes_by_group)
    jb, pb = _ring_bundles(overrides)
    want = j_by(jb.strategy, jb.def_leaves, jb.plan_leaves, jb.mi, depth)
    got = prefetch_buffer_bytes_by_group(pb.strategy, pb.def_leaves,
                                         pb.plan_leaves, MESH3, depth)
    assert got == want and set(got) == {"fcdp"}
    total = prefetch_buffer_bytes(pb.strategy, pb.def_leaves,
                                  pb.plan_leaves, MESH3, depth)
    assert total == sum(got.values()) == j_total(
        jb.strategy, jb.def_leaves, jb.plan_leaves, jb.mi, depth)
    assert pb.strategy.max_prefetch_depth == \
        jb.strategy.max_prefetch_depth == 8
    if overrides:
        assert type(pb.strategy).__name__ == "CompositeStrategy"
        assert total < prefetch_buffer_bytes(*(lambda b: (
            b.strategy, b.def_leaves, b.plan_leaves, MESH3, depth))(
                _ring_bundles(())[1]))
